"""The port's half-vector shift (G-PT) against the reference on the CPU.

- half_vector_copy (shared with G-BDPT's prefix replay) on seeded local
  directions over every ported kind: reflection, refraction and
  total-internal-reflection lanes;
- G-PT + L1 through both factories (16^2, 2 spp, maxDepth 5, seed 1) on
  caustics.xml (glass and Ag spheres), cbox-mats.xml (dielectric sphere,
  checkerboard floor, a roughconductor at alpha 0.1 that classifies
  diffuse), the reference's own rough-glass scene (roughdielectric alpha
  0.05 at shiftThreshold 0.1, tests/test_gpt_specular.py) and envmap.xml
  at shiftThreshold 0.5 (its rough spheres take the glossy copy);
- same-seed reruns of G-PT and G-BDPT on caustics bit for bit, and on
  cbox (all diffuse) the all-diffuse branches (the suffix
  factorizations, G-BDPT's slot-0 walk) against the general ones.
G-BDPT's prefix replay against the reference: test_torch_gbdpt_specular.py.

The reference's intersectors are pinned to the linear-MT matmul sweeps
(tests/torch_parity.py), and torch's CPU arithmetic flushes subnormals
to zero as XLA's does (flush_subnormals), on one thread (one_thread).  Tolerances: the copied
direction and the Jacobian at rtol 1e-5 on >= 99.9% of lanes and 1e-4
on all (test_torch_envmap.py's rule for steep lobes), validity and delta
class exactly; the offset's f and pdf at rtol 1e-5 on >= 98% and 2e-4
on all (near a steep lobe's peak 1 - cos^2 theta_h cancels: an ulp of
cos is ~1e-7 of tan^2, which exp(-tan^2 / alpha^2) at alpha 0.05 scales
by 400 -- the port's eval at the reference's own direction differs as
much); images at rtol 1e-3 /
atol 1e-4 on >= 99% of pixels with means within 1e-3 relative, the L1
final by its objective (1%) and mean (5e-3), as test_torch_envmap.py
holds envmap's.  Ray counts: equal on caustics and envmap.  On cbox-mats
and the rough glass the reference's jitted render and its own pass run
outside jit differ by one ray at this seed (an offset's half-vector
continuation ray whose validity sits on a grazing direction: XLA's fused
arithmetic flips it); the port equals the pass outside jit (held on
cbox-mats, 8,866 rays, where the render traces 8,867) and the render
within that one ray."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gradientdomain_mitsuba_tpu.models import gpt as ref_gpt
from gradientdomain_mitsuba_tpu.ops import bsdf as ref_bsdf
from gradientdomain_mitsuba_tpu.scene import materials as M
from gradientdomain_mitsuba_tpu_torch.models import gbdpt, gpt
from gradientdomain_mitsuba_tpu_torch.models.gbdpt import GBDPTracer
from gradientdomain_mitsuba_tpu_torch.models.gpt import GPTracer
from gradientdomain_mitsuba_tpu_torch.ops import bsdf
from gradientdomain_mitsuba_tpu_torch.scene import bridge
from test_gpt_specular import ROUGH_XML
from torch_parity import flush_subnormals, one_thread  # noqa: F401
from torch_parity import load, make_both, op_close

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = os.path.join(ROOT, "data/scenes")
CAUS = os.path.join(SCENES, "caustics/caustics.xml")
CBOX = os.path.join(SCENES, "cbox/cbox.xml")
SIZE, SPP, SEED = 16, 2, 1
BUFS = ("primal", "very_direct", "dx", "dy")
pytestmark = pytest.mark.usefixtures("flush_subnormals", "one_thread")


def _frac_close(got, ref):
    return np.isclose(got, ref, rtol=1e-3, atol=1e-4).all(-1).mean()


def _rel_mean_diff(got, ref):
    return abs(got.mean() - ref.mean()) / max(abs(ref.mean()), 1e-12)


# ------------------------------------------------------ half_vector_copy

AG_ETA, AG_K = (0.155, 0.117, 0.138), (4.828, 3.122, 2.147)
HV_ROWS = [
    dict(kind=M.DIFFUSE, reflectance=(0.6, 0.5, 0.4)),
    dict(kind=M.CONDUCTOR, eta=AG_ETA, k=AG_K),
    dict(kind=M.DIELECTRIC, eta=(1.5,) * 3),
    dict(kind=M.DIELECTRIC, eta=(1.33,) * 3, transmittance=(0.9, 0.8, 0.7)),
    dict(kind=M.ROUGH_CONDUCTOR, alpha=0.1, eta=AG_ETA, k=AG_K,
         dist=M.DIST_GGX),
    dict(kind=M.ROUGH_DIELECTRIC, alpha=0.05, eta=(1.5,) * 3),
    dict(kind=M.ROUGH_DIELECTRIC, alpha=0.3, eta=(1.33,) * 3),
    dict(kind=M.ROUGH_PLASTIC, reflectance=(0.5, 0.4, 0.3), alpha=0.15,
         eta=(1.49,) * 3, fdr_int=0.58),
    dict(kind=M.PLASTIC, reflectance=(0.1, 0.27, 0.36), eta=(1.49,) * 3,
         fdr_int=0.58),
    dict(kind=M.NULL_BSDF),
]


def _unit(rs, n):
    v = rs.normal(size=(n, 3))
    return np.float32(v / np.linalg.norm(v, axis=-1, keepdims=True))


def test_half_vector_copy_matches_reference():
    """Base bounces sampled by the reference's own sample() (so delta
    reflection and refraction appear as a path takes them) from wi over
    the whole sphere, and offsets with a perturbed wi on the same or a
    random material: reflect, refract and TIR lanes, delta-class
    mismatches, dead base samples."""
    mb = M.MaterialBuilder()
    for r in HV_ROWS:
        mb.add_row(**r)
    mats = mb.finalize()
    kinds = frozenset(int(k) for k in np.unique(mats.kind))
    rs = np.random.RandomState(12)
    n = 12000
    mid_m = rs.randint(0, len(HV_ROWS), n).astype(np.int32)
    mid_o = np.where(rs.uniform(size=n) < 0.7, mid_m,
                     rs.randint(0, len(HV_ROWS), n)).astype(np.int32)
    wi_m = _unit(rs, n)
    wi_o = wi_m + np.float32(rs.normal(0, 0.08, (n, 3)))
    wi_o = np.float32(wi_o / np.linalg.norm(wi_o, axis=-1, keepdims=True))
    u2 = np.float32(rs.uniform(size=(n, 2)))
    uc = np.float32(rs.uniform(size=n))
    jm = jax.device_put(mats)
    rp_m = ref_bsdf.gather_params(jm, jnp.asarray(mid_m))
    rp_o = ref_bsdf.gather_params(jm, jnp.asarray(mid_o))
    bs = ref_bsdf.sample(rp_m, jnp.asarray(wi_m), jnp.asarray(u2),
                         jnp.asarray(uc), kinds)
    wo_m = np.array(bs.wo)
    is_delta_m = np.array(bs.is_delta)
    ref = ref_gpt.half_vector_copy(
        lambda p, a, b: ref_bsdf.eval(p, a, b, kinds),
        lambda p, a, b: ref_bsdf.pdf(p, a, b, kinds),
        jnp.asarray(wi_m), jnp.asarray(wo_m), rp_m,
        jnp.asarray(is_delta_m), jnp.asarray(wi_o), rp_o)
    tm = bridge.to_torch(mats, "cpu")
    t = torch.from_numpy
    got = gpt.half_vector_copy(
        lambda p, a, b: bsdf.eval(p, a, b, kinds),
        lambda p, a, b: bsdf.pdf(p, a, b, kinds),
        t(wi_m), t(wo_m), bsdf.gather_params(tm, t(mid_m)), t(is_delta_m),
        t(wi_o), bsdf.gather_params(tm, t(mid_o)))
    refract = wi_m[:, 2] * wo_m[:, 2] < 0
    valid = np.asarray(ref["valid"])
    # the lanes this test is for are there
    assert refract.mean() > 0.05 and (valid & refract).mean() > 0.03
    assert (valid & ~refract).mean() > 0.2 and (~valid).mean() > 0.1
    assert (refract & ~valid & np.asarray(ref["is_delta"])).any()  # TIR
    for name in ("valid", "is_delta"):
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(ref[name]), name)
    for name in ("wo", "jac"):
        op_close(got[name].numpy(), ref[name], name)
    for name in ("f", "pdf"):
        op_close(got[name].numpy(), ref[name], name, frac=0.98,
                 rtol_all=2e-4)


# ------------------------------------------------------------ G-PT

@pytest.fixture(scope="module")
def rough_xml(tmp_path_factory):
    path = tmp_path_factory.mktemp("rough") / "rough.xml"
    path.write_text(ROUGH_XML.replace('value="20"', f'value="{SIZE}"')
                    .replace('name="maxDepth" value="4"',
                             'name="maxDepth" value="5"'))
    return str(path)


GPT_CASES = {
    "caustics": (CAUS, {}),
    "cbox-mats": (os.path.join(SCENES, "cbox-mats/cbox-mats.xml"), {}),
    "roughglass": (None, {}),
    "envmap": (os.path.join(SCENES, "envmap/envmap.xml"),
               {"shiftThreshold": 0.5}),
}


def _ref_pass_rays(rt, rs, n_pix):
    """The reference's ray count of its one pass (SPP samples a pixel)
    run outside jit (its bounce loop still compiles as one body)."""
    rt.ray_tally = []
    try:
        rt.trace_pass(rs, SEED, jnp.repeat(jnp.arange(SPP, dtype=jnp.uint32),
                                           n_pix),
                      pixel_id=jnp.tile(jnp.arange(n_pix, dtype=jnp.uint32),
                                        SPP))
        return int(sum(float(r) for r in rt.ray_tally))
    finally:
        rt.ray_tally = None


@pytest.fixture(scope="module", params=sorted(GPT_CASES))
def gpt_renders(request, rough_xml):
    """Both packages' render_final (L1) with their buffers and rays."""
    path, props = GPT_CASES[request.param]
    scene, st = load(path or rough_xml, "gpt", size=SIZE, spp=SPP, depth=5,
                     props=props)
    rt, rs, pt, ts = make_both(scene, st)
    assert type(pt) is GPTracer and pt.any_specular and rt.any_specular
    rt.count_rays = pt.count_rays = True
    out = {"case": request.param}
    for name, tr, sc in (("ref", rt, rs), ("port", pt, ts)):
        final, bufs = tr.render_final(sc, SEED, SPP, alpha=0.2, mode="L1")
        out[name] = {k: np.asarray(bufs[k]) for k in BUFS}
        out[name]["L1"] = np.asarray(final)
        out[name]["rays"] = int(np.asarray(bufs["rays"]))
    if request.param == "cbox-mats":
        out["ref"]["pass_rays"] = _ref_pass_rays(rt, rs, st.width * st.height)
    return out


@pytest.mark.parametrize("name", BUFS)
def test_gpt_buffers_match_reference(gpt_renders, name):
    got, ref = gpt_renders["port"][name], gpt_renders["ref"][name]
    assert got.shape == ref.shape and got.shape[-1] == 3
    assert np.isfinite(got).all()
    if name != "very_direct" or gpt_renders["case"] != "caustics":
        assert np.abs(ref).mean() > 1e-4  # (caustics: the light is unseen)
    assert _frac_close(got, ref) >= 0.99
    assert (_rel_mean_diff(got, ref) < 1e-3 or
            abs(got.mean() - ref.mean()) < 1e-6)


def test_gpt_ray_counts_equal(gpt_renders):
    got, ref = gpt_renders["port"]["rays"], gpt_renders["ref"]
    assert got > 0
    if gpt_renders["case"] in ("caustics", "envmap"):
        assert got == ref["rays"]
    else:
        assert abs(got - ref["rays"]) <= 1
    if "pass_rays" in ref:
        assert got == ref["pass_rays"]


def test_gpt_l1_final_matches_reference(gpt_renders):
    ref, port = gpt_renders["ref"], gpt_renders["port"]
    got = port["L1"]
    assert np.isfinite(got).all()
    assert _rel_mean_diff(got, ref["L1"]) < 5e-3
    p, gx, gy, vd = (ref[k] for k in ("primal", "dx", "dy", "very_direct"))

    def energy(x):
        gxm, gym = gx.copy(), gy.copy()
        gxm[:, -1] = 0.0
        gym[-1] = 0.0
        dx = np.pad(x[:, 1:] - x[:, :-1], ((0, 0), (0, 1), (0, 0)))
        dy = np.pad(x[1:] - x[:-1], ((0, 1), (0, 0), (0, 0)))
        return (np.abs(dx - gxm).sum() + np.abs(dy - gym).sum() +
                0.2 * np.abs(x - p).sum())

    e_ref, e_got = energy(ref["L1"] - vd), energy(got - vd)
    assert abs(e_got - e_ref) <= 0.01 * e_ref, (e_got, e_ref)


# ----------------------------------------------- reruns, diffuse branches

def _port_scene(path, integrator, depth, **props):
    from gradientdomain_mitsuba_tpu_torch.scene import scene as port_scene
    scene, st = port_scene.load_scene(path, {
        "width": str(SIZE), "height": str(SIZE), "spp": str(SPP),
        "maxDepth": str(depth), "integrator": integrator})
    st.integrator = integrator
    st.integrator_props.update(props)
    return bridge.to_torch(scene, "cpu"), st


@pytest.mark.parametrize("cls,depth", [(GPTracer, 5), (GBDPTracer, 4)])
def test_specular_render_is_deterministic(cls, depth):
    ts, st = _port_scene(CAUS, "gpt", depth)
    a = cls(ts, st).render_chunk(ts, SEED, 0, SPP)
    b = cls(ts, st).render_chunk(ts, SEED, 0, SPP)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("cls,mod,depth", [(GPTracer, gpt, 6),
                                           (GBDPTracer, gbdpt, 4)])
def test_all_diffuse_branch_matches_general_one(monkeypatch, cls, mod,
                                                depth):
    """On cbox (all diffuse) the all-diffuse branch never reaches the
    half-vector copy, and its shortcuts (G-PT's suffix factorization and
    two-bounce offsets, G-BDPT's slot-0 walk, suffix factorization and
    shadow-ray reuse) give the buffers of the general branch that
    any_specular selects, up to rounding."""
    ts, st = _port_scene(CBOX, "gpt", depth)
    fast = cls(ts, st)
    assert not fast.any_specular

    def refuse(*a, **k):
        raise AssertionError("half_vector_copy on an all-diffuse branch")
    monkeypatch.setattr(mod, "half_vector_copy", refuse)
    a = fast.render_chunk(ts, SEED, 0, SPP)
    monkeypatch.undo()
    full = cls(ts, st)
    full.any_specular = True
    b = full.render_chunk(ts, SEED, 0, SPP)
    for k in a:
        assert torch.isfinite(a[k]).all(), k
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    assert a["dx"].abs().max() > 0
