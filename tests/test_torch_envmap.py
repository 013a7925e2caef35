"""The port's step-F slice against the reference on the CPU: the
microfacet warps, the roughconductor / roughplastic / roughdielectric /
plastic BSDFs (plus a chi^2 of the port's sample against its own pdf),
texture evaluation and the primary hits' uv footprint, the environment
map (texel sampling, bilinear lookup, its pdf, NEE with it), the thin
lens, and PathTracer and GPTracer + L1 on data/scenes/envmap/envmap.xml
(16x12, 2 spp, maxDepth 5, seed 1) through both factories, the
reference's intersectors pinned to the linear-MT matmul sweeps.

Tolerances: ids, counts and booleans exactly; texture lookups and env
quantities at rtol 1e-5 with a small atol; directions at rtol 1e-5 /
atol 1e-5 (the warps' log / sin / cos / acos / atan2 differ in the last
float32 bits between the frameworks, and sin(theta) = sqrt(1 - cos^2)
grows them near the pole); BSDF values at rtol 1e-5 on >= 99.9% of
lanes and 1e-4 on all (a steep lobe's exp(-tan^2 / alpha^2) scales an
ulp by 1/alpha^2); images at rtol 1e-3 / atol 1e-4 on >= 99% of pixels,
means within 1e-3 relative; the L1 final by its objective (1%) and mean
(5e-3), as tests/test_torch_gpt.py holds cbox's."""
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gradientdomain_mitsuba_tpu.core import warp as ref_warp
from gradientdomain_mitsuba_tpu.ops import bsdf as ref_bsdf
from gradientdomain_mitsuba_tpu.ops import common as ref_common
from gradientdomain_mitsuba_tpu.ops import emitter as ref_em
from gradientdomain_mitsuba_tpu.ops import sensor as ref_sensor
from gradientdomain_mitsuba_tpu.ops import texture as ref_tex
from gradientdomain_mitsuba_tpu.scene import materials as M
from gradientdomain_mitsuba_tpu.scene import scene as ref_scene
from gradientdomain_mitsuba_tpu_torch.core import warp
from gradientdomain_mitsuba_tpu_torch.core.records import Intersection
from gradientdomain_mitsuba_tpu_torch.models import factory
from gradientdomain_mitsuba_tpu_torch.models.gpt import GPTracer
from gradientdomain_mitsuba_tpu_torch.models.path import PathTracer
from gradientdomain_mitsuba_tpu_torch.ops import bsdf, common, sensor
from gradientdomain_mitsuba_tpu_torch.ops import emitter as em
from gradientdomain_mitsuba_tpu_torch.ops import texture as tex
from gradientdomain_mitsuba_tpu_torch.scene import bridge
from torch_parity import make_both, pinned_matmul

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = os.path.join(ROOT, "data/scenes/envmap/envmap.xml")
CBOX = os.path.join(ROOT, "data/scenes/cbox/cbox.xml")
W, H, SPP, SEED = 16, 12, 2, 1
TOL = dict(rtol=1e-5, atol=1e-6)
BUFS = ("primal", "very_direct", "dx", "dy")


def _close(got, ref, **kw):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               **(kw or TOL))


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _load(integrator="gpt", **props):
    scene, st = ref_scene.load_scene(ENV, {
        "width": str(W), "height": str(H), "spp": str(SPP),
        "maxDepth": "5", "integrator": integrator})
    st.integrator_props.update(props)
    return scene, st


@pytest.fixture(scope="module")
def scenes():
    """(numpy scene, reference scene as jax arrays, port scene as CPU
    tensors, settings) from ONE load, so both sides see the same
    tables."""
    s, st = _load()
    return s, jax.device_put(s), bridge.to_torch(s, "cpu"), st


def _unit(rs, n):
    v = rs.normal(size=(n, 3))
    return np.float32(v / np.linalg.norm(v, axis=-1, keepdims=True))


# --------------------------------------------------------------- warps

@pytest.mark.parametrize("name", ["beckmann", "ggx"])
def test_microfacet_warps(name):
    rs = np.random.RandomState(3)
    u = np.float32(rs.uniform(size=(5000, 2)))
    u[:8, 0] = [0.0, 1e-7, 0.5, 0.999, 0.9999999, 1.0 - 2 ** -24, 0.25,
                0.75]
    alpha = np.float32(rs.uniform(0.02, 0.8, 5000))
    ref_s = getattr(ref_warp, f"square_to_{name}")
    ref_p = getattr(ref_warp, f"square_to_{name}_pdf")
    got_s = getattr(warp, f"square_to_{name}")
    got_p = getattr(warp, f"square_to_{name}_pdf")
    d_ref = ref_s(*_j(u, alpha))
    d_got = got_s(*_t(u, alpha))
    # sin(theta) = sqrt(1 - cos^2) near the pole turns an ulp of cos into
    # a few 1e-6 of sin: directions at atol 1e-5
    _close(d_got, d_ref, rtol=1e-5, atol=1e-5)
    # pdfs of the same directions (the reference's samples) and of
    # random ones, the lower hemisphere included
    d = np.concatenate([np.asarray(d_ref), _unit(rs, 5000)])
    a = np.concatenate([alpha, alpha])
    _close(got_p(*_t(d, a)), ref_p(*_j(d, a)), rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------- BSDFs

AU_ETA, AU_K = (0.143, 0.374, 1.442), (3.983, 2.385, 1.603)
KIND_ROWS = {
    "roughconductor": [
        dict(kind=M.ROUGH_CONDUCTOR, alpha=0.2, eta=AU_ETA, k=AU_K),
        dict(kind=M.ROUGH_CONDUCTOR, alpha=0.45, eta=AU_ETA, k=AU_K,
             dist=M.DIST_GGX, flags=M.FLAG_TWOSIDED)],
    "roughplastic": [
        dict(kind=M.ROUGH_PLASTIC, reflectance=(0.5, 0.4, 0.3), alpha=0.15,
             eta=(1.49,) * 3, fdr_int=0.58),
        dict(kind=M.ROUGH_PLASTIC, reflectance=(0.1, 0.6, 0.2), alpha=0.3,
             eta=(1.49,) * 3, fdr_int=0.58, dist=M.DIST_GGX,
             flags=M.FLAG_TWOSIDED)],
    "roughdielectric": [
        dict(kind=M.ROUGH_DIELECTRIC, alpha=0.1, eta=(1.5,) * 3),
        dict(kind=M.ROUGH_DIELECTRIC, alpha=0.35, eta=(1.33,) * 3,
             dist=M.DIST_GGX, transmittance=(0.9, 0.8, 0.7))],
    "plastic": [
        dict(kind=M.PLASTIC, reflectance=(0.1, 0.27, 0.36),
             eta=(1.49,) * 3, fdr_int=0.58),
        dict(kind=M.PLASTIC, reflectance=(0.7, 0.2, 0.1), eta=(1.6,) * 3,
             fdr_int=0.6, flags=M.FLAG_TWOSIDED)],
}


def _materials(rows):
    mb = M.MaterialBuilder()
    for r in rows:
        mb.add_row(**r)
    mb.add_row(kind=M.DIFFUSE, reflectance=(0.6, 0.5, 0.4))
    return mb.finalize()


@pytest.mark.parametrize("name", sorted(KIND_ROWS))
def test_bsdf_kind_matches_reference(name):
    """eval, pdf and sample over a table of the kind's rows (Beckmann and
    GGX, one-sided and two-sided) and a diffuse row, on seeded wi / wo
    over the whole sphere (so from inside for roughdielectric)."""
    mats = _materials(KIND_ROWS[name])
    kinds = frozenset(int(k) for k in np.unique(mats.kind))
    rs = np.random.RandomState(sorted(KIND_ROWS).index(name))
    n = 6000
    mid = rs.randint(0, mats.kind.shape[0], n).astype(np.int32)
    wi, wo = _unit(rs, n), _unit(rs, n)
    u2 = np.float32(rs.uniform(size=(n, 2)))
    uc = np.float32(rs.uniform(size=n))
    rp = ref_bsdf.gather_params(jax.device_put(mats), jnp.asarray(mid))
    tp = bsdf.gather_params(bridge.to_torch(mats, "cpu"),
                            torch.from_numpy(mid))
    jw, tw = _j(wi, wo, u2, uc), _t(wi, wo, u2, uc)
    f_ref = np.asarray(ref_bsdf.eval(rp, jw[0], jw[1], kinds))
    assert (f_ref.max(-1) > 0).mean() > 0.2
    # a steep lobe (alpha 0.1) scales an ulp of tan^2 by 1/alpha^2 in
    # exp(-tan^2 / alpha^2): rtol 1e-5 on >= 99.9% of lanes, 1e-4 on all
    for got, ref in ((bsdf.eval(tp, tw[0], tw[1], kinds), f_ref),
                     (bsdf.pdf(tp, tw[0], tw[1], kinds),
                      ref_bsdf.pdf(rp, jw[0], jw[1], kinds))):
        got, ref = got.numpy(), np.asarray(ref)
        _close(got, ref, rtol=1e-4, atol=1e-6)
        assert np.isclose(got, ref, rtol=1e-5, atol=1e-6).mean() >= 0.999
    rsam = ref_bsdf.sample(rp, jw[0], jw[2], jw[3], kinds)
    tsam = bsdf.sample(tp, tw[0], tw[2], tw[3], kinds)
    for f in ("is_delta", "valid"):
        np.testing.assert_array_equal(getattr(tsam, f).numpy(),
                                      np.asarray(getattr(rsam, f)), f)
    assert tsam.valid.float().mean() > 0.3
    _close(tsam.eta, rsam.eta)
    # sampled directions carry the warps' ulps (atol 1e-5, as there);
    # the lobe's pdf and weight at them amplify those by 1/alpha^2
    _close(tsam.wo, rsam.wo, rtol=1e-5, atol=1e-5)
    _close(tsam.pdf, rsam.pdf, rtol=1e-4, atol=1e-5)
    _close(tsam.weight, rsam.weight, rtol=1e-4, atol=1e-5)
    _close(bsdf.roughness(bridge.to_torch(mats, "cpu"),
                          torch.from_numpy(mid)),
           ref_bsdf.roughness(jax.device_put(mats), jnp.asarray(mid)))


CT_BINS, PHI_BINS = 12, 24


@pytest.mark.parametrize("name,row,wi", [
    ("roughconductor", 0, (0.4, -0.2, 0.89)),
    ("roughconductor", 1, (0.3, 0.5, 0.81)),
    ("roughplastic", 0, (0.4, -0.2, 0.89)),
    ("roughdielectric", 0, (0.4, -0.2, 0.89)),
    ("roughdielectric", 1, (0.3, 0.1, -0.94)),
    ("plastic", 0, (0.4, -0.2, 0.89))])
def test_chi2_sample_vs_pdf(name, row, wi):
    """The port's sample() against its own pdf(), as tests/test_bsdf.py
    holds the reference's: a histogram of the sampled wo over the sphere
    against the pdf integrated over each bin (the smooth lobes; plastic's
    delta lobe is left out of both)."""
    n = 1 << 16
    mats = bridge.to_torch(_materials([KIND_ROWS[name][row]]), "cpu")
    kinds = frozenset(int(k) for k in mats.kind.unique())
    wi = torch.tensor(wi, dtype=torch.float32)
    wi = wi / wi.norm()
    rs = np.random.RandomState(17 + row)
    p1 = bsdf.gather_params(mats, torch.zeros(n, dtype=torch.int32))
    u2, uc = _t(np.float32(rs.uniform(size=(n, 2))),
                np.float32(rs.uniform(size=n)))
    bs = bsdf.sample(p1, wi.expand(n, 3), u2, uc, kinds)
    keep = (bs.valid & ~bs.is_delta).numpy()
    wo = bs.wo.numpy()[keep]
    phi = np.arctan2(wo[:, 1], wo[:, 0]) % (2 * np.pi)
    counts, _, _ = np.histogram2d(
        np.clip(wo[:, 2], -1, 1), phi, bins=[CT_BINS, PHI_BINS],
        range=[[-1, 1], [0, 2 * np.pi]])
    nsub = 24
    cts = -1 + 2 * (np.arange(CT_BINS * nsub) + 0.5) / (CT_BINS * nsub)
    phs = 2 * np.pi * (np.arange(PHI_BINS * nsub) + 0.5) / (PHI_BINS * nsub)
    CT, PH = np.meshgrid(cts, phs, indexing="ij")
    ST = np.sqrt(np.maximum(0, 1 - CT ** 2))
    dirs = np.float32(np.stack([ST * np.cos(PH), ST * np.sin(PH), CT],
                               -1).reshape(-1, 3))
    K = dirs.shape[0]
    pk = bsdf.gather_params(mats, torch.zeros(K, dtype=torch.int32))
    vals = bsdf.pdf(pk, wi.expand(K, 3), torch.from_numpy(dirs),
                    kinds).numpy()
    dA = (2.0 / (CT_BINS * nsub)) * (2 * np.pi / (PHI_BINS * nsub))
    probs = vals.reshape(CT_BINS, nsub, PHI_BINS, nsub).sum((1, 3)) * dA
    total = probs.sum()
    expected = probs * keep.sum() / max(total, 1e-9)
    mask = expected > 8
    chi2 = ((counts[mask] - expected[mask]) ** 2 / expected[mask]).sum()
    dof = mask.sum() - 1
    # the pdf integrates to the share of smooth samples (wider for the
    # dense side: the pdf is steep at the critical angle)
    int_tol = 0.06 if wi[2] < 0 else 0.03
    assert abs(total - keep.mean()) < int_tol, (total, keep.mean())
    assert chi2 < dof + 5.5 * np.sqrt(2.0 * max(dof, 1)), (chi2, dof)


def test_albedo_override_sets_spec_weight():
    """gather_params takes the specular sampling weight from the
    overridden (textured) reflectance, as the reference does."""
    mats = _materials(KIND_ROWS["plastic"])
    rs = np.random.RandomState(4)
    mid = rs.randint(0, 3, 500).astype(np.int32)
    alb = np.float32(rs.uniform(0, 1, (500, 3)))
    rp = ref_bsdf.gather_params(jax.device_put(mats), jnp.asarray(mid),
                                albedo_override=jnp.asarray(alb))
    tp = bsdf.gather_params(bridge.to_torch(mats, "cpu"),
                            torch.from_numpy(mid),
                            albedo_override=torch.from_numpy(alb))
    for f in ("reflectance", "spec_weight"):
        _close(getattr(tp, f), getattr(rp, f))
    plain = bsdf.gather_params(bridge.to_torch(mats, "cpu"),
                               torch.from_numpy(mid))
    assert not torch.allclose(plain.spec_weight, tp.spec_weight)


# ------------------------------------------------------------- textures

def _texture_table():
    """Bitmap (13x10, scaled and offset uv, 5 mip levels), checkerboard,
    grid, vertexcolor and wireframe rows, stacked as build_table stacks
    them."""
    rs = np.random.RandomState(8)
    img = np.float32(rs.uniform(0, 1, (10, 13, 3)))
    slabs = [ref_tex._pack_pyramid(ref_tex._build_pyramid(img))]
    one = np.ones((1, 1, 3), np.float32)
    slabs += [ref_tex._pack_pyramid(ref_tex._build_pyramid(one))] * 4
    T = len(slabs)
    L = max(len(o) for _, o, _ in slabs)
    hmax = max(sl.shape[0] for sl, _, _ in slabs)
    wmax = max(sl.shape[1] for sl, _, _ in slabs)
    image = np.zeros((T, hmax, wmax, 3), np.float32)
    lo = np.zeros((T, L, 2), np.int32)
    ls = np.ones((T, L, 2), np.int32)
    nl = np.zeros(T, np.int32)
    for i, (sl, offs, szs) in enumerate(slabs):
        image[i, :sl.shape[0], :sl.shape[1]] = sl
        n = len(offs)
        lo[i, :n], ls[i, :n] = offs, szs
        lo[i, n:], ls[i, n:] = offs[-1], szs[-1]
        nl[i] = n
    return ref_tex.TextureTable(
        kind=np.int32([ref_tex.TEX_BITMAP, ref_tex.TEX_CHECKERBOARD,
                       ref_tex.TEX_GRID, ref_tex.TEX_VERTEXCOLOR,
                       ref_tex.TEX_WIREFRAME]),
        color0=np.float32([[0.9, 1.1, 1.0], [0.5, 0.5, 0.55],
                           [0.4, 0.3, 0.2], [0.7, 0.6, 0.5],
                           [0.5, 0.5, 0.5]]),
        color1=np.float32([[0, 0, 0], [0.2, 0.2, 0.22], [0.9, 0.9, 0.1],
                           [0, 0, 0], [0.1, 0.1, 0.1]]),
        uv_scale=np.float32([[1.7, 0.6], [16, 16], [4, 3], [1, 1],
                             [1, 1]]),
        uv_offset=np.float32([[0.3, -0.45], [0, 0], [0.1, 0], [0, 0],
                              [0, 0]]),
        image=image, img_size=np.int32([[10, 13]] + [[1, 1]] * 4),
        lvl_off=lo, lvl_size=ls, n_levels=nl,
        grid_width=np.float32([0.01, 0.01, 0.05, 0.01, 0.02]),
        filter_ewa=np.zeros(T, np.int32))


@pytest.mark.parametrize("footprint", [None, "random"])
def test_eval_texture(footprint):
    """Every texture kind at level 0 (footprint None) and trilinear
    (footprints spanning below level 0 to past the coarsest level), on uv
    far outside [0, 1) both ways (the floor-mod wraps)."""
    table = _texture_table()
    rs = np.random.RandomState(9)
    n = 5000
    tid = rs.randint(0, 5, n).astype(np.int32)
    uv = np.float32(rs.uniform(-3.0, 4.0, (n, 2)))
    uv[:10] = [[0, 0], [1, 1], [-1, 0.5], [0.5, -0.25], [0.25, 0.5],
               [2.0, -3.0], [1e-7, -1e-7], [0.999999, 0.5], [-0.5, 1.5],
               [0.125, 0.0625]]
    fp = None if footprint is None else np.float32(
        10.0 ** rs.uniform(-9, 1, n))
    ref = ref_tex.eval_texture(jax.device_put(table), jnp.asarray(tid),
                               jnp.asarray(uv),
                               None if fp is None else jnp.asarray(fp))
    got = tex.eval_texture(bridge.to_torch(table, "cpu"),
                           torch.from_numpy(tid), torch.from_numpy(uv),
                           None if fp is None else torch.from_numpy(fp))
    _close(got, ref, rtol=1e-5, atol=1e-6)
    # every kind was drawn, with both checker colors
    assert len(np.unique(np.asarray(ref)[tid == 1], axis=0)) == 2


def test_resolve_albedo_on_envmap(scenes):
    """The envmap's checkerboard ground: textured rows take the texture,
    the others keep their reflectance, with and without a footprint."""
    _, rs_scene, ts_scene, _ = scenes
    rs = np.random.RandomState(10)
    n = 3000
    mid = rs.randint(0, rs_scene.materials.kind.shape[0], n).astype(np.int32)
    uv = np.float32(rs.uniform(-1, 2, (n, 2)))
    fp = np.float32(10.0 ** rs.uniform(-8, 0, n))
    packed = np.asarray(rs_scene.materials.packed)
    assert (packed[mid, 20] >= 0).any() and (packed[mid, 20] < 0).any()
    for f in (None, fp):
        ref = ref_tex.resolve_albedo(
            rs_scene, jnp.asarray(mid), jnp.asarray(uv),
            None if f is None else jnp.asarray(f))
        got = tex.resolve_albedo(
            ts_scene, torch.from_numpy(mid), torch.from_numpy(uv),
            None if f is None else torch.from_numpy(f))
        _close(got, ref)
        # material_params with bit 0 carries it into the BSDF params
        tp = common.material_params(ts_scene, 1, torch.from_numpy(mid),
                                    torch.from_numpy(uv),
                                    None if f is None else
                                    torch.from_numpy(f))
        rp = ref_common.material_params(
            rs_scene, 1, jnp.asarray(mid), jnp.asarray(uv),
            None if f is None else jnp.asarray(f))
        for name in ("reflectance", "spec_weight", "kind", "alpha"):
            _close(getattr(tp, name), getattr(rp, name))


def _primary_hits(rs_scene, n=3000, seed=5):
    """Thin-lens camera rays and their reference hit records (triangles
    through the matmul sweep, spheres merged by closest t)."""
    rs = np.random.RandomState(seed)
    pos = np.float32(rs.uniform(0, 1, (n, 2)) * [W, H])
    u_ap = np.float32(rs.uniform(size=(n, 2)))
    o, d = ref_sensor.sample_ray(rs_scene.camera, W, H, *_j(pos, u_ap))
    closest, _ = pinned_matmul(None, 2)
    hit = closest(o, d, jnp.zeros(n), jnp.full(n, 3e38), rs_scene.geom)
    return pos, u_ap, d, ref_common.fill_intersection(rs_scene, o, d, hit)


def test_primary_uv_footprint(scenes):
    """Same hit records on both sides: triangle lanes get t^2 omega /
    |cos| times the uv density, sphere lanes 0, misses 0."""
    _, rs_scene, ts_scene, _ = scenes
    _, _, d, its = _primary_hits(rs_scene)
    ref = np.asarray(ref_common.primary_uv_footprint(rs_scene, W, H, d,
                                                     its))
    t_its = Intersection(*[None if v is None else _t(v)[0] for v in its])
    got = common.primary_uv_footprint(ts_scene, W, H,
                                      _t(d)[0],
                                      t_its).numpy()
    _close(got, ref, rtol=1e-5, atol=1e-12)
    prim = np.asarray(its.prim_id)
    tri = np.asarray(its.valid) & (prim < common.SPHERE_PRIM_BASE)
    assert (ref[tri] > 0).all() and tri.any()
    assert (ref[~tri] == 0).all() and (~tri).any()


# ---------------------------------------------------------- environment

def _env_u(emitters, n, rs):
    """Uniform u, plus u equal to CDF entries exactly (row and column
    boundaries)."""
    u = np.float32(rs.uniform(size=(n, 2)))
    rows = np.asarray(emitters.env_cdf_rows)
    cols = np.asarray(emitters.env_cdf_cols)
    k = len(rows)
    u[:k, 0] = rows
    u[k:2 * k, 1] = cols[rs.randint(0, cols.shape[0], k),
                         rs.randint(0, cols.shape[1], k)]
    return np.clip(u, 0.0, np.float32(1.0 - 2 ** -24))


def _flat_rows(scene_np):
    """The envmap's tables with every third row's CDF flat (all mass in
    one texel, so the row's CDF repeats 0 and then 1) and its marginal
    weight zero."""
    em_np = scene_np.emitters
    cols = np.array(em_np.env_cdf_cols)
    cols[::3] = np.where(np.arange(cols.shape[1]) >= 5, 1.0, 0.0)
    rows = np.array(em_np.env_cdf_rows)
    rows[1::4] = rows[:-1:4][:len(rows[1::4])]
    rows = np.maximum.accumulate(rows)
    return scene_np._replace(emitters=em_np._replace(
        env_cdf_cols=np.float32(cols), env_cdf_rows=np.float32(rows)))


@pytest.mark.parametrize("tables", ["envmap", "flat-rows"])
def test_sample_env(scenes, tables):
    s_np = scenes[0] if tables == "envmap" else _flat_rows(scenes[0])
    rs_scene, ts_scene = jax.device_put(s_np), bridge.to_torch(s_np, "cpu")
    u = _env_u(s_np.emitters, 4000, np.random.RandomState(11))
    rd, rp, rr = ref_em._sample_env(rs_scene, ref_em.ENV_MAP,
                                    jnp.asarray(u))
    td, tp, tr = em._sample_env(ts_scene, em.ENV_MAP, torch.from_numpy(u))
    _close(td, rd, rtol=1e-5, atol=1e-6)
    # pdf and radiance are texel lookups: equal texels give equal bits
    np.testing.assert_array_equal(tp.numpy(), np.asarray(rp))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(rr))


def test_eval_env_and_pdf(scenes):
    """Bilinear lookup (wrapping in phi, clamped at the poles) and the
    texel pdf, on random directions, the poles and the phi seam."""
    _, rs_scene, ts_scene, _ = scenes
    rs = np.random.RandomState(12)
    d = _unit(rs, 5000)
    d[:6] = [[0, 0, 1], [0, 0, -1], [0, 1, 0], [0, -1, 0], [1, 0, 0],
             [1, -1e-7, 0]]
    d = np.float32(d / np.linalg.norm(d, axis=-1, keepdims=True))
    _close(em.eval_env(ts_scene, em.ENV_MAP, torch.from_numpy(d)),
           ref_em.eval_env(rs_scene, ref_em.ENV_MAP, jnp.asarray(d)),
           rtol=1e-5, atol=1e-6)
    for n_area in (0, 2):
        _close(em.pdf_env_direct(ts_scene, n_area, em.ENV_MAP,
                                 torch.from_numpy(d)),
               ref_em.pdf_env_direct(rs_scene, n_area, ref_em.ENV_MAP,
                                     jnp.asarray(d)), rtol=1e-5, atol=0)


@pytest.mark.parametrize("case", ["envmap", "cbox+envmap"])
def test_sample_direct_with_env(scenes, case):
    """NEE picks among the area emitters and the environment: envmap.xml
    alone (every lane picks the env), and cbox's light with the envmap's
    tables added (the pick, is_env, and pdf_area_direct's count)."""
    s_np = scenes[0]
    if case == "cbox+envmap":
        cbox, _ = ref_scene.load_scene(CBOX, {"width": "8", "height": "8"})
        env = s_np.emitters
        s_np = cbox._replace(emitters=cbox.emitters._replace(
            **{f: getattr(env, f) for f in env._fields
               if f.startswith("env_")}))
    rs_scene, ts_scene = jax.device_put(s_np), bridge.to_torch(s_np, "cpu")
    n_area = int((np.asarray(s_np.emitters.tri_count) > 0).sum())
    rs = np.random.RandomState(13)
    n = 4000
    lo, hi = ((0, 0, 0), (550, 540, 560)) if n_area else ((-3, 0, -3),
                                                          (3, 2, 5))
    p_ref = np.float32(rs.uniform(lo, hi, (n, 3)))
    u_sel = np.float32(rs.uniform(size=n))
    u_pos = np.float32(rs.uniform(size=(n, 2)))
    ref = ref_em.sample_direct(rs_scene, n_area, ref_em.ENV_MAP,
                               *_j(p_ref, u_sel, u_pos))
    got = em.sample_direct(ts_scene, n_area, em.ENV_MAP,
                           *_t(p_ref, u_sel, u_pos))
    for f in ("valid", "is_env", "is_delta"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), f)
    is_env = got.is_env.numpy()
    assert is_env.all() if n_area == 0 else 0.3 < is_env.mean() < 0.7
    for f in ("d", "dist", "pdf", "radiance", "n", "p", "pdf_area"):
        _close(getattr(got, f), getattr(ref, f), rtol=1e-5, atol=1e-5)
    if n_area:
        eid = np.zeros(n, np.int32)
        eid[::3] = -1
        r_pdf = ref_em.pdf_area_direct(rs_scene, n_area, True,
                                       jnp.asarray(eid), jnp.asarray(p_ref),
                                       ref.p, ref.n)
        # on the reference's sampled points (grazing ones amplify ulps)
        t_pdf = em.pdf_area_direct(ts_scene, n_area, True,
                                   *_t(eid, p_ref, ref.p, ref.n))
        _close(t_pdf, r_pdf)


def test_thin_lens_sample_ray(scenes):
    """envmap.xml's thin lens (aperture 0.1, focus 5): origins on the
    lens disk, rays through the focal plane."""
    _, rs_scene, ts_scene, _ = scenes
    pos, u_ap, d_ref, _ = _primary_hits(rs_scene)
    ro, rd = ref_sensor.sample_ray(rs_scene.camera, W, H, *_j(pos, u_ap))
    desc = sensor.describe(ts_scene.camera)
    assert desc.lens and desc.kind == sensor.PERSPECTIVE
    to, td = sensor.sample_ray(desc, W, H, *_t(pos, u_ap))
    _close(to, ro, rtol=1e-5, atol=1e-6)
    _close(td, rd, rtol=1e-5, atol=1e-6)
    assert float(ts_scene.camera.aperture_radius) == pytest.approx(0.1)
    # the lens moves the origins; a pinhole keeps them at the eye
    pin = ts_scene.camera._replace(aperture_radius=torch.tensor(0.0))
    po, _ = sensor.sample_ray(sensor.describe(pin), W, H, *_t(pos, u_ap))
    assert (po - po[:1]).abs().max() == 0 and (to - po).abs().max() > 0.01
    # light tracing: the thin lens takes the pinhole's importance (the
    # aperture ignored), as the reference does
    p = (np.asarray(ro) + 3.0 * np.asarray(rd)).astype(np.float32)
    rf, rwe, rin = ref_sensor.importance_sample_direct(rs_scene.camera, W,
                                                       H, jnp.asarray(p))
    tf, twe, tin = sensor.importance_sample_direct(desc, W, H, *_t(p))
    np.testing.assert_array_equal(tin.numpy(), np.asarray(rin))
    assert tin.float().mean() > 0.9
    _close(tf, rf, rtol=1e-5, atol=1e-4)
    _close(twe, rwe, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------- gates

def test_factory_builds_both_tracers():
    for integrator, cls in (("gpt", GPTracer), ("path", PathTracer)):
        scene, st = _load(integrator)
        assert type(factory.make_integrator(bridge.to_torch(scene, "cpu"),
                                            st)) is cls


def test_gpt_takes_the_half_vector_shift_at_glossy_threshold():
    """shiftThreshold 0.5 classes the alpha 0.2 roughconductor (and the
    other rough rows) as glossy: G-PT takes the half-vector shift (its
    parity with the reference: test_torch_specular.py)."""
    scene, st = _load("gpt", shiftThreshold=0.5)
    tracer = factory.make_integrator(bridge.to_torch(scene, "cpu"), st)
    assert type(tracer) is GPTracer and tracer.any_specular
    assert not GPTracer(bridge.to_torch(scene, "cpu"),
                        _load("gpt")[1]).any_specular


@pytest.mark.parametrize("bit,item", [(2, 13), (4, 12), (8, 13), (16, 12)])
def test_unported_texture_bits_raise(scenes, bit, item):
    """Every has_textures bit resolves (textured opacity and blend
    weights were item 13, woven cloth item 12; their parity:
    tests/test_torch_texture_rest.py, tests/test_torch_irawan.py): the
    params fill their fields on the envmap scene's rows, which bind no
    such texture (the rows' scalars come back), and both tracers
    build."""
    _, _, ts_scene, st = scenes
    ids = torch.zeros(2).int()
    bary = torch.tensor([[1.0, 1.0, 1.0, 3.4e38, 1.0, 0.0]]).expand(2, 6)
    p = common.material_params(ts_scene, 1 | bit, ids, torch.zeros(2, 2),
                               bary=bary)
    row = ts_scene.materials.packed[0]
    if bit == 4:
        assert p.blend is not None and not p.coat.any()
        assert (p.blend_w == 0).all()
    if bit == 2:
        assert (p.opacity == row[22]).all()
    if bit == 16:
        assert p.cloth is not None and p.cloth.shape == (2, 6)
    else:
        assert p.cloth is None
    st2 = copy.deepcopy(st)
    st2.has_textures = 1 | bit
    for cls in (GPTracer, PathTracer):
        cls(ts_scene, st2)


def test_ewa_and_other_envs_raise(scenes):
    """EWA filtering (item 13 before) builds and filters (its parity:
    tests/test_torch_texture_rest.py); the constant environment and
    delta lights (item 14 before) build in both tracers, and the
    constant environment's NEE, radiance and pdf on the envmap scene's
    tables (its env_radiance read as the constant's radiance) equal the
    reference's (the lights board: tests/test_torch_lights.py)."""
    _, rs_scene, ts_scene, st = scenes
    st2 = copy.deepcopy(st)
    st2.has_ewa = True
    for cls in (GPTracer, PathTracer):
        assert cls(ts_scene, st2).has_ewa
    for field, value in (("env_kind", 1), ("n_delta", 1)):
        st2 = copy.deepcopy(st)
        setattr(st2, field, value)
        for cls in (GPTracer, PathTracer):
            assert getattr(cls(ts_scene, st2), field) == value
    out = tex.eval_texture(ts_scene.textures, torch.zeros(2).int(),
                           torch.zeros(2, 2),
                           (torch.ones(2), torch.zeros(2, 2, 2)))
    assert out.shape == (2, 3) and torch.isfinite(out).all()
    rs = np.random.RandomState(9)
    p_ref = np.float32(rs.normal(size=(500, 3)))
    u_sel = np.float32(rs.uniform(size=500))
    u_pos = np.float32(rs.uniform(size=(500, 2)))
    d = _unit(rs, 500)
    ref = ref_em.sample_direct(rs_scene, 1, em.ENV_CONSTANT, *_j(p_ref, u_sel,
                                                                 u_pos))
    got = em.sample_direct(ts_scene, 1, em.ENV_CONSTANT, *_t(p_ref, u_sel,
                                                             u_pos))
    assert got.is_env.any() and (~got.is_env).any()
    for name in ("d", "dist", "pdf", "radiance", "n", "valid", "pdf_area",
                 "is_env"):
        _close(getattr(got, name), getattr(ref, name), rtol=1e-5,
               atol=1e-5)
    _close(em.eval_env(ts_scene, em.ENV_CONSTANT, *_t(d)),
           ref_em.eval_env(rs_scene, em.ENV_CONSTANT, *_j(d)))
    _close(em.pdf_env_direct(ts_scene, 1, em.ENV_CONSTANT, *_t(d)),
           ref_em.pdf_env_direct(rs_scene, 1, em.ENV_CONSTANT, *_j(d)))


# --------------------------------------------------------------- renders

def _frac_close(got, ref):
    return np.isclose(got, ref, rtol=1e-3, atol=1e-4).all(-1).mean()


def _rel_mean_diff(got, ref):
    return abs(got.mean() - ref.mean()) / max(abs(ref.mean()), 1e-12)


@pytest.fixture(scope="module")
def path_renders():
    scene, st = _load("path")
    rt, rs, pt, ts = make_both(scene, st)
    rt.count_rays = pt.count_rays = True
    ref = np.asarray(rt.render(rs, seed=SEED, spp=SPP))
    got = pt.render(ts, seed=SEED, spp=SPP).numpy()
    return ref, got, rt.last_ray_count, pt.last_ray_count


def test_path_matches_reference(path_renders):
    ref, got, ref_rays, got_rays = path_renders
    assert got.shape == ref.shape == (H, W, 3)
    assert np.isfinite(got).all() and ref.mean() > 1e-3
    assert _frac_close(got, ref) >= 0.99
    assert _rel_mean_diff(got, ref) < 1e-3
    assert int(got_rays) == int(ref_rays) > 0


@pytest.fixture(scope="module")
def gpt_renders():
    """Both packages' render_final (L1) with their buffers."""
    scene, st = _load("gpt")
    rt, rs, pt, ts = make_both(scene, st)
    rt.count_rays = pt.count_rays = True
    out = {}
    for name, tr, sc in (("ref", rt, rs), ("port", pt, ts)):
        final, bufs = tr.render_final(sc, SEED, SPP, alpha=0.2, mode="L1")
        out[name] = {k: np.asarray(bufs[k]) for k in BUFS}
        out[name]["L1"] = np.asarray(final)
        out[name]["rays"] = int(np.asarray(bufs["rays"]))
    return out


@pytest.mark.parametrize("name", BUFS)
def test_gpt_buffers_match_reference(gpt_renders, name):
    got, ref = gpt_renders["port"][name], gpt_renders["ref"][name]
    assert got.shape == ref.shape == (H, W, 3)
    assert np.isfinite(got).all()
    assert np.abs(ref).mean() > 1e-4
    assert _frac_close(got, ref) >= 0.99
    assert (_rel_mean_diff(got, ref) < 1e-3 or
            abs(got.mean() - ref.mean()) < 1e-6)


def test_gpt_ray_counts_equal(gpt_renders):
    assert gpt_renders["port"]["rays"] == gpt_renders["ref"]["rays"] > 0


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
