"""Woven cloth (irawan, ROADMAP item 12) in the port against the reference
on the CPU.

- ops: the weave tables and presets, _hash_cell bit for bit (the
  reference's uint32 mix, emulated in int64), resolve_features and
  eval_cloth on seeded inputs at rtol 1e-5 on >= 99.9% of lanes and
  1e-4 on all (cos / sin / exp differ in the last bit between the
  frameworks, and the von Mises lobe's exp(kappa (cos - 1)) scales it by
  kappa), and IRAWAN through bsdf.eval / pdf / sample on the rows the
  loader builds in both packages (held equal);
- the reference's own checks (tests/test_irawan.py): reciprocity, the
  energy bound, the lobe following the yarn axis, the sample weight's
  mean against quadrature of eval, and a chi^2 of the port's sample
  against its own pdf;
- renders: the cloth quads of tools/cloth_board.py (loaded by path)
  through BDPT and G-BDPT + L1 in both packages (16^2, 2 spp, maxDepth
  3, seed 1; the reference's intersectors pinned to the linear-MT
  matmul sweeps), at rtol 1e-3 on >= 99% of pixels with equal rays, and
  the port's BDPT against its path tracer on the same quads (the
  reference's test_bdpt_matches_path_on_cloth: the strategies'
  re-evaluations keep the cloth's specular lobe through SubPath.aux).

torch runs on one thread with subnormals flushed, as XLA's CPU
arithmetic does (tests/torch_parity.py)."""
import importlib.util
import os
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gradientdomain_mitsuba_tpu.ops import bsdf as ref_bsdf
from gradientdomain_mitsuba_tpu.ops import common as ref_common
from gradientdomain_mitsuba_tpu.ops import irawan as ref_irawan
from gradientdomain_mitsuba_tpu.scene import scene as ref_scene
from gradientdomain_mitsuba_tpu_torch.models import factory
from gradientdomain_mitsuba_tpu_torch.ops import bsdf, common, irawan
from gradientdomain_mitsuba_tpu_torch.scene import bridge
from gradientdomain_mitsuba_tpu_torch.scene import materials as PM
from gradientdomain_mitsuba_tpu_torch.scene import scene as port_scene
from torch_parity import flush_subnormals, one_thread  # noqa: F401
from torch_parity import (GBDPT_BUFS, assert_l1_final_close, bidir_renders,
                          check_bdpt, check_gbdpt_buffer,
                          check_gbdpt_primal_is_bdpt, op_close)

pytestmark = pytest.mark.usefixtures("flush_subnormals", "one_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 16


def _board_module():
    spec = importlib.util.spec_from_file_location(
        "cloth_board", os.path.join(ROOT, "tools/cloth_board.py"))
    board = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(board)
    return board


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _unit_hemi(rs, n, lo=1e-3):
    d = rs.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[:, 2] = np.abs(d[:, 2]) + lo
    return np.float32(d / np.linalg.norm(d, axis=-1, keepdims=True))


@pytest.fixture(scope="module")
def cloth(tmp_path_factory):
    """The cloth quads of the board: (XML path, numpy scene, reference
    scene, port scene, settings)."""
    b = _board_module()
    path = b.write_board(str(tmp_path_factory.mktemp("cloth")), b.CLOTH)
    s, st = ref_scene.load_scene(path, {
        "width": str(SIZE), "height": str(SIZE), "spp": "2",
        "maxDepth": "3"})
    return path, s, jax.device_put(s), bridge.to_torch(s, "cpu"), st


# ------------------------------------------------------------------ ops

def test_tables_and_presets():
    for name in ("GRID", "GRID_H", "GRID_W", "YARN", "PRESET_KD",
                 "PRESET_KS"):
        np.testing.assert_array_equal(getattr(irawan, name),
                                      getattr(ref_irawan, name), name)
    assert irawan.PRESET_IDS == ref_irawan.PRESET_IDS
    for name in ("cotton_denim.wif", "SILK_CHARMEUSE", "wool_gabardine",
                 "polyester", "unknown.wif", "plain"):
        assert (irawan.preset_from_name(name) ==
                ref_irawan.preset_from_name(name)), name


def test_hash_cell_bit_for_bit():
    """Every int32 cell coordinate the wrap reaches (negative ones, the
    extremes) and every preset id."""
    rs = np.random.RandomState(1)
    n = 200000
    cx = rs.randint(-2 ** 31, 2 ** 31, n, dtype=np.int64).astype(np.int32)
    cy = rs.randint(-5000, 5000, n).astype(np.int32)
    pid = rs.randint(0, len(irawan.PRESET_IDS), n).astype(np.int32)
    cx[:6] = [0, -1, 2 ** 31 - 1, -2 ** 31, 1, 12345]
    cy[:6] = [0, -1, -2 ** 31, 2 ** 31 - 1, -7, 0]
    ref = np.asarray(ref_irawan._hash_cell(*map(jnp.asarray,
                                                (cx, cy, pid))))
    got = irawan._hash_cell(*map(_t, (cx, cy, pid))).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    assert 0.0 <= got.min() and got.max() < 1.0 and got.std() > 0.25


def test_resolve_features(cloth):
    """On every row of the cloth board's table (cloth and not), at uv far
    outside [0, 1) and seeded azimuths, with and without the payload."""
    _, _, rs_scene, ts_scene, _ = cloth
    rs = np.random.RandomState(2)
    n = 20000
    mid = rs.randint(0, ts_scene.materials.packed.shape[0],
                     n).astype(np.int32)
    uv = np.float32(rs.uniform(-3, 4, (n, 2)))
    az = rs.normal(size=(n, 2))
    az /= np.linalg.norm(az, axis=-1, keepdims=True)
    bary = np.float32(np.concatenate([rs.uniform(0, 1, (n, 4)), az], -1))
    for b in (bary, None):
        ref = ref_irawan.resolve_features(rs_scene, jnp.asarray(mid),
                                          jnp.asarray(uv),
                                          None if b is None else
                                          jnp.asarray(b))
        got = irawan.resolve_features(ts_scene, _t(mid), _t(uv), _t(b))
        op_close(got.numpy(), np.asarray(ref), "features", atol=1e-6)


def _params(n, rs, cloth_feat=True):
    """IRAWAN MatParams in both packages from seeded kd / ks / features."""
    z = np.zeros(n, np.float32)
    kd = np.float32(rs.uniform(0, 0.6, (n, 3)))
    ks = np.float32(rs.uniform(0, 0.6, (n, 3)))
    az = rs.normal(size=(n, 2))
    az /= np.linalg.norm(az, axis=-1, keepdims=True)
    feat = np.float32(np.stack([
        rs.uniform(-0.7, 0.7, n), rs.uniform(-0.6, 0.6, n), az[:, 0],
        az[:, 1], rs.uniform(20, 80, n), rs.uniform(0.7, 1.3, n)], -1))
    fields = dict(
        kind=np.full(n, PM.IRAWAN, np.int32), twosided=np.zeros(n, bool),
        reflectance=kd, specular=ks,
        transmittance=np.ones((n, 3), np.float32), alpha=z + 10.0,
        eta=np.full((n, 3), 1.345, np.float32),
        k=np.zeros((n, 3), np.float32), dist=np.zeros(n, np.int32),
        fdr_int=z, spec_weight=z, alpha_v=z + 10.0, opacity=z + 1.0)
    ref = ref_bsdf.MatParams(**{k: jnp.asarray(v) for k, v in
                                fields.items()},
                             cloth=jnp.asarray(feat) if cloth_feat else None)
    got = bsdf.MatParams(**{k: _t(v) for k, v in fields.items()},
                         cloth=_t(feat) if cloth_feat else None)
    return ref, got


@pytest.mark.parametrize("with_cloth", [True, False])
def test_eval_cloth(with_cloth):
    rs = np.random.RandomState(3)
    n = 20000
    ref_p, got_p = _params(n, rs, with_cloth)
    wi = np.float32(rs.normal(size=(n, 3)))
    wi /= np.linalg.norm(wi, axis=-1, keepdims=True)
    wo = _unit_hemi(rs, n)
    ref = ref_irawan.eval_cloth(ref_p, jnp.asarray(wi), jnp.asarray(wo))
    got = irawan.eval_cloth(got_p, _t(wi), _t(wo))
    op_close(got.numpy(), np.asarray(ref), "eval_cloth", atol=1e-7)
    assert (np.asarray(ref) > 0).any() and (np.asarray(ref) == 0).any()


def test_bsdf_dispatch_on_loaded_rows(cloth):
    """eval / pdf / sample of the board's rows through each package's
    material_params (has_textures bit 4, the payload's azimuth) on seeded
    directions: the loader's irawan rows are the reference's."""
    _, s, rs_scene, ts_scene, st = cloth
    assert st.has_textures & 16
    np.testing.assert_array_equal(ts_scene.materials.packed.numpy(),
                                  np.asarray(s.materials.packed))
    kinds = bsdf.scene_kinds(ts_scene)
    assert PM.IRAWAN in kinds
    rs = np.random.RandomState(4)
    n = 20000
    mid = rs.randint(0, ts_scene.materials.packed.shape[0],
                     n).astype(np.int32)
    uv = np.float32(rs.uniform(0, 1, (n, 2)))
    az = rs.normal(size=(n, 2))
    az /= np.linalg.norm(az, axis=-1, keepdims=True)
    bary = np.float32(np.concatenate([np.ones((n, 4)), az], -1))
    bits = int(st.has_textures)
    rp = ref_common.material_params(rs_scene, bits, jnp.asarray(mid),
                                    jnp.asarray(uv), bary=jnp.asarray(bary))
    tp = common.material_params(ts_scene, bits, _t(mid), _t(uv),
                                bary=_t(bary))
    wi = np.float32(rs.normal(size=(n, 3)))
    wi /= np.linalg.norm(wi, axis=-1, keepdims=True)
    wo = np.float32(rs.normal(size=(n, 3)))
    wo /= np.linalg.norm(wo, axis=-1, keepdims=True)
    u2 = np.float32(rs.uniform(size=(n, 2)))
    uc = np.float32(rs.uniform(size=n))
    for name in ("eval", "pdf"):
        ref = getattr(ref_bsdf, name)(rp, *map(jnp.asarray, (wi, wo)),
                                      kinds=kinds)
        got = getattr(bsdf, name)(tp, *map(_t, (wi, wo)), kinds=kinds)
        op_close(got.numpy(), np.asarray(ref), name, atol=1e-7)
    rs_ = ref_bsdf.sample(rp, *map(jnp.asarray, (wi, u2, uc)), kinds=kinds)
    ts_ = bsdf.sample(tp, *map(_t, (wi, u2, uc)), kinds=kinds)
    np.testing.assert_array_equal(ts_.valid.numpy(), np.asarray(rs_.valid))
    np.testing.assert_allclose(ts_.wo.numpy(), np.asarray(rs_.wo),
                               rtol=1e-5, atol=1e-5)
    for name in ("weight", "pdf"):
        op_close(getattr(ts_, name).numpy(),
                 np.asarray(getattr(rs_, name)), name, atol=1e-6)


# ------------------------------------- the reference's checks, on the port

def _feat_params(n, u=0.2, v=0.1, axis=(1.0, 0.0), kappa=40.0, inten=1.0,
                 kd=(0.3, 0.3, 0.3), ks=(0.4, 0.4, 0.4)):
    """tests/test_irawan.py's _params / _feat, in the port."""
    z = torch.zeros(n)
    v3 = lambda c: torch.tensor(c, dtype=torch.float32).expand(n, 3)
    feat = torch.tensor([u, v, axis[0], axis[1], kappa, inten],
                        dtype=torch.float32).expand(n, 6)
    return bsdf.MatParams(
        kind=torch.full((n,), PM.IRAWAN, dtype=torch.int32),
        twosided=torch.zeros(n, dtype=torch.bool), reflectance=v3(kd),
        specular=v3(ks), transmittance=v3((1, 1, 1)), alpha=z + 10.0,
        eta=v3((1.345,) * 3), k=v3((0, 0, 0)),
        dist=torch.zeros(n, dtype=torch.int32), fdr_int=z, spec_weight=z,
        alpha_v=z + 10.0, opacity=z + 1.0, cloth=feat)


def _cos_dirs(rs, n):
    u = rs.random((n, 2)).astype(np.float32)
    r = np.sqrt(u[:, 0])
    phi = 2 * np.pi * u[:, 1]
    return np.float32(np.stack([r * np.cos(phi), r * np.sin(phi),
                                np.sqrt(np.maximum(1 - u[:, 0], 0.0))], -1))


def test_reciprocity():
    rng = np.random.default_rng(0)
    n = 64
    wi = torch.from_numpy(_unit_hemi(rng, n))
    wo = torch.from_numpy(_unit_hemi(rng, n))
    p = _feat_params(n)
    f_io = irawan.eval_cloth(p, wi, wo) / wo[:, 2:3].clamp_min(1e-6)
    f_oi = irawan.eval_cloth(p, wo, wi) / wi[:, 2:3].clamp_min(1e-6)
    np.testing.assert_allclose(f_io.numpy(), f_oi.numpy(), rtol=2e-3,
                               atol=1e-5)


def test_energy_bounded():
    rng = np.random.default_rng(1)
    n = 20000
    wo = _cos_dirs(rng, n)
    wi = np.tile(np.float32([0.3, 0.1, 0.95]), (n, 1))
    wi /= np.linalg.norm(wi, axis=-1, keepdims=True)
    f = irawan.eval_cloth(_feat_params(n, kappa=40.0, inten=1.3),
                          _t(wi), _t(wo)).numpy()
    albedo = (f / np.maximum(wo[:, 2] / np.pi, 1e-6)[:, None]).mean(0)
    assert np.all(albedo < 1.0) and np.all(albedo > 0.05), albedo


def test_anisotropy_follows_yarn_axis():
    wi = torch.tensor([[0.0, 0.0, 1.0]])
    wo = torch.tensor([[np.sin(0.75), 0.0, np.cos(0.75)]],
                      dtype=torch.float32)
    f_x = irawan.eval_cloth(_feat_params(1, u=0.4, v=0.0, axis=(1.0, 0.0),
                                         kappa=60.0, kd=(0, 0, 0)),
                            wi, wo).sum()
    f_y = irawan.eval_cloth(_feat_params(1, u=0.4, v=0.0, axis=(0.0, 1.0),
                                         kappa=60.0, kd=(0, 0, 0)),
                            wi, wo).sum()
    assert f_x > 3.0 * f_y, (f_x, f_y)


def test_sampling_matches_quadrature():
    n = 30000
    rng = np.random.default_rng(2)
    wi = np.tile(np.float32([0.4, -0.2, 0.89]), (n, 1))
    wi /= np.linalg.norm(wi, axis=-1, keepdims=True)
    p = _feat_params(n, u=0.3, v=0.2, kappa=25.0)
    s = bsdf.sample(p, _t(wi), _t(rng.random((n, 2)).astype(np.float32)),
                    _t(rng.random(n).astype(np.float32)),
                    kinds=frozenset({PM.IRAWAN}))
    est = (s.weight * s.valid[..., None]).numpy().mean(0)
    wo = _cos_dirs(rng, n)
    f = irawan.eval_cloth(p, _t(wi), _t(wo)).numpy()
    ref = (f / np.maximum(wo[:, 2] / np.pi, 1e-6)[:, None]).mean(0)
    np.testing.assert_allclose(est, ref, rtol=0.05)


def test_chi2_sample_vs_pdf():
    """The port's IRAWAN sample against its own pdf (the cosine
    hemisphere), as test_torch_envmap.py holds the microfacet kinds."""
    n = 1 << 16
    ct_bins, phi_bins = 10, 20
    rs = np.random.RandomState(9)
    wi = torch.tensor([0.4, -0.2, 0.89])
    wi = wi / wi.norm()
    p = _feat_params(n, u=0.3, v=0.2, kappa=25.0)
    kinds = frozenset({PM.IRAWAN})
    bs = bsdf.sample(p, wi.expand(n, 3),
                     _t(np.float32(rs.uniform(size=(n, 2)))),
                     _t(np.float32(rs.uniform(size=n))), kinds)
    keep = (bs.valid & ~bs.is_delta).numpy()
    wo = bs.wo.numpy()[keep]
    phi = np.arctan2(wo[:, 1], wo[:, 0]) % (2 * np.pi)
    counts, _, _ = np.histogram2d(np.clip(wo[:, 2], -1, 1), phi,
                                  bins=[ct_bins, phi_bins],
                                  range=[[-1, 1], [0, 2 * np.pi]])
    nsub = 16
    cts = -1 + 2 * (np.arange(ct_bins * nsub) + 0.5) / (ct_bins * nsub)
    phs = 2 * np.pi * (np.arange(phi_bins * nsub) + 0.5) / (phi_bins * nsub)
    CT, PH = np.meshgrid(cts, phs, indexing="ij")
    ST = np.sqrt(np.maximum(0, 1 - CT ** 2))
    dirs = np.float32(np.stack([ST * np.cos(PH), ST * np.sin(PH), CT],
                               -1).reshape(-1, 3))
    K = dirs.shape[0]
    vals = bsdf.pdf(_feat_params(K, u=0.3, v=0.2, kappa=25.0),
                    wi.expand(K, 3), _t(dirs), kinds).numpy()
    dA = (2.0 / (ct_bins * nsub)) * (2 * np.pi / (phi_bins * nsub))
    probs = vals.reshape(ct_bins, nsub, phi_bins, nsub).sum((1, 3)) * dA
    expected = probs * keep.sum() / max(probs.sum(), 1e-9)
    mask = expected > 8
    chi2 = ((counts[mask] - expected[mask]) ** 2 / expected[mask]).sum()
    dof = mask.sum() - 1
    assert abs(probs.sum() - keep.mean()) < 0.03
    assert chi2 < dof + 5.5 * np.sqrt(2.0 * max(dof, 1)), (chi2, dof)


IRAWAN_XML = textwrap.dedent("""\
    <scene version="0.5.0">
      <sensor type="perspective">
        <float name="fov" value="45"/>
        <transform name="toWorld">
          <lookat origin="0, 1.2, 2.2" target="0, 0, 0" up="0, 1, 0"/>
        </transform>
        <film type="hdrfilm">
          <integer name="width" value="8"/><integer name="height" value="8"/>
        </film>
      </sensor>
      <shape type="rectangle">
        <transform name="toWorld"><rotate x="1" angle="-90"/></transform>
        <bsdf type="irawan">
          <string name="filename" value="{pattern}"/>
          <float name="repeatU" value="6"/>
          <rgb name="kd" value="0.2 0.3 0.4"/>
          <float name="ksMultiplier" value="1.5"/>
        </bsdf>
      </shape>
    </scene>
""")


@pytest.mark.parametrize("pattern", ["cotton_denim.wif", "satin.wif",
                                     "silk_charmeuse.wif"])
def test_loader_irawan_row(tmp_path, pattern):
    """The port's loader builds the irawan row as the reference's does
    (preset by name, repeatU / V, kd given, ks the preset's times its
    multiplier), from its own presets."""
    path = tmp_path / "cloth.xml"
    path.write_text(IRAWAN_XML.format(pattern=pattern))
    s_ref, st_ref = ref_scene.load_scene(str(path))
    s_port, st_port = port_scene.load_scene(str(path))
    np.testing.assert_array_equal(np.asarray(s_port.materials.packed),
                                  np.asarray(s_ref.materials.packed))
    assert st_port.has_textures == st_ref.has_textures == 16
    assert s_port.geom.tri_shade.shape[-1] == 41


# -------------------------------------------------------------- renders

@pytest.fixture(scope="module")
def renders(cloth):
    return bidir_renders(cloth[0], SIZE, spp=2, depth=3, seed=1)


def test_bdpt_matches_reference_on_cloth(renders):
    check_bdpt(renders, SIZE, lit=0.2)


@pytest.mark.parametrize("name", GBDPT_BUFS)
def test_gbdpt_buffer_matches_reference_on_cloth(renders, name):
    check_gbdpt_buffer(renders, name, SIZE)


def test_gbdpt_rays_and_l1_on_cloth(renders):
    g = renders["gbdpt"]
    assert int(g["port"]["rays"]) == int(g["ref"]["rays"]) > 0
    assert_l1_final_close(g["port"]["L1"], g["ref"])
    check_gbdpt_primal_is_bdpt(renders)


def test_bdpt_matches_path_on_cloth(cloth):
    """The reference's test_bdpt_matches_path_on_cloth on the port: BDPT
    (whose connection strategies re-evaluate the cloth at stored vertices
    through SubPath.aux) and the path tracer estimate the same image of
    the cloth quads, means within 4%."""
    path, s, _, ts, st = cloth
    means = {}
    for integ, spp, seed in (("bdpt", 48, 0), ("path", 256, 9)):
        s2, st2 = port_scene.load_scene(path, {
            "width": "20", "height": "20", "spp": str(spp),
            "maxDepth": "3"})
        st2.integrator = integ
        ts2 = bridge.to_torch(s2, "cpu")
        tracer = factory.make_integrator(ts2, st2)
        if integ == "bdpt":
            assert tracer.has_cloth
        img = tracer.render(ts2, seed=seed, spp=spp).numpy()
        assert np.isfinite(img).all()
        means[integ] = img.mean()
    assert abs(means["bdpt"] / means["path"] - 1) < 0.04, means
