"""Port ops against the reference functions on the same inputs (made from
a seed with numpy): camera rays, film splats (grid adds and the scatter
on colliding, edge and out-of-film positions), the sensor importance,
area-light NEE, the diffuse BSDF and the hit fill on cbox.  Tolerance
rtol 1e-5 / atol 1e-6 (1e-5 for the scatters, whose sums of up to 150
samples a pixel run in another order): the two frameworks sum in
different orders."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gradientdomain_mitsuba_tpu.ops import bsdf as ref_bsdf
from gradientdomain_mitsuba_tpu.ops import common as ref_common
from gradientdomain_mitsuba_tpu.ops import emitter as ref_em
from gradientdomain_mitsuba_tpu.ops import film as ref_film
from gradientdomain_mitsuba_tpu.ops import intersect as ref_isec
from gradientdomain_mitsuba_tpu.ops import sensor as ref_sensor
from gradientdomain_mitsuba_tpu.scene import scene as ref_scene
from gradientdomain_mitsuba_tpu_torch.ops import bsdf
from gradientdomain_mitsuba_tpu_torch.ops import common
from gradientdomain_mitsuba_tpu_torch.ops import emitter as em
from gradientdomain_mitsuba_tpu_torch.ops import film
from gradientdomain_mitsuba_tpu_torch.ops import intersect as isec
from gradientdomain_mitsuba_tpu_torch.ops import sensor
from gradientdomain_mitsuba_tpu_torch.scene import bridge

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CBOX = os.path.join(ROOT, "data/scenes/cbox/cbox.xml")
W, H = 24, 16
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def scenes():
    """(reference scene as jax arrays, port scene as CPU tensors, settings)
    from ONE numpy load, so both sides see identical tables."""
    s, st = ref_scene.load_scene(CBOX, {"width": str(W), "height": str(H)})
    return jax.device_put(s), bridge.to_torch(s, "cpu"), st


def _close(got, ref, **kw):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               **(kw or TOL))


def _camera_rays(rs_scene, ts_scene, n=2000, seed=0):
    rs = np.random.RandomState(seed)
    pos = np.float32(rs.uniform(0, 1, (n, 2)) * [W, H])
    u_ap = np.float32(rs.uniform(size=(n, 2)))
    ro, rd = ref_sensor.sample_ray(rs_scene.camera, W, H, jnp.asarray(pos),
                                   jnp.asarray(u_ap))
    to, td = sensor.sample_ray(sensor.describe(ts_scene.camera), W, H,
                               torch.from_numpy(pos), torch.from_numpy(u_ap))
    return (ro, rd), (to, td)


def _cameras(rs_scene, ts_scene, **fields):
    """Both packages' cbox camera with `fields` replaced."""
    rcam = rs_scene.camera._replace(
        **{k: jnp.asarray(v, jnp.float32) for k, v in fields.items()})
    tcam = ts_scene.camera._replace(
        **{k: torch.tensor(v, dtype=torch.float32)
           for k, v in fields.items()})
    return rcam, tcam


def test_sample_ray(scenes):
    rs_scene, ts_scene, _ = scenes
    (ro, rd), (to, td) = _camera_rays(rs_scene, ts_scene)
    _close(to, ro)
    _close(td, rd)


def test_sample_ray_rejects_other_sensors(scenes):
    """Every other kind generates the reference's rays on cbox's
    camera (their own scenes: tests/test_torch_sensors.py):
    orthographic, telecentric (with an aperture), spherical and the two
    meters; the thin lens is kind 0 with an aperture
    (tests/test_torch_envmap.py)."""
    rs_scene, ts_scene, _ = scenes
    rs = np.random.RandomState(3)
    pos = np.float32(rs.uniform(0, 1, (500, 2)) * [W, H])
    u_ap = np.float32(rs.uniform(size=(500, 2)))
    for kind, ap in ((1.0, 0.0), (1.0, 20.0), (2.0, 0.0), (3.0, 0.0),
                     (4.0, 0.0)):
        rcam, tcam = _cameras(rs_scene, ts_scene, kind=kind,
                              aperture_radius=ap)
        desc = sensor.describe(tcam)
        assert (desc.kind, desc.lens) == (int(kind), ap > 0)
        ro, rd = ref_sensor.sample_ray(rcam, W, H, jnp.asarray(pos),
                                       jnp.asarray(u_ap))
        to, td = sensor.sample_ray(desc, W, H, torch.from_numpy(pos),
                                   torch.from_numpy(u_ap))
        _close(to, ro, rtol=1e-5, atol=1e-4)
        _close(td, rd, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("filter_kind", [0, 1, 2])
def test_splat_grid(filter_kind):
    rs = np.random.RandomState(filter_kind)
    S, rows = 3, 5
    fb = np.float32(rs.normal(size=(8, W, 3)))
    wb = np.float32(rs.uniform(size=(8, W)))
    jit = np.float32(rs.uniform(size=(S, rows * W, 2)))
    val = np.float32(rs.normal(size=(S, rows * W, 3)))
    for row0 in (0, 3):
        rf, rw = ref_film.splat_grid(jnp.asarray(fb), jnp.asarray(wb),
                                     jnp.asarray(jit), jnp.asarray(val),
                                     filter_kind, row0=row0)
        tf, tw = film.splat_grid(torch.from_numpy(fb), torch.from_numpy(wb),
                                 torch.from_numpy(jit), torch.from_numpy(val),
                                 filter_kind, row0=row0)
        _close(tf, rf)
        _close(tw, rw)


@pytest.mark.parametrize("dx,dy", [(0, 0), (1, 0), (-1, 0), (0, 1),
                                   (0, -1)])
def test_add_grid_shifted(dx, dy):
    rs = np.random.RandomState(7)
    fb = np.float32(rs.normal(size=(H, W, 3)))
    val = np.float32(rs.normal(size=(2, H * W, 3)))
    ref = ref_film.add_grid_shifted(jnp.asarray(fb), jnp.asarray(val), dx, dy)
    got = film.add_grid_shifted(torch.from_numpy(fb), torch.from_numpy(val),
                                dx, dy)
    _close(got, ref)


def _scatter_inputs(n=600, seed=11):
    """Film positions that collide (many samples on few pixels), sit on
    the film's edges and corners, and leave it on every side."""
    rs = np.random.RandomState(seed)
    pos = np.float32(rs.uniform(-0.5, 1.5, (n, 2)) * [W, H])
    pos[: n // 4] = np.float32([[3.25, 2.5]])                  # collisions
    pos[n // 4: n // 4 + 40] = np.float32(rs.uniform(0, 4, (40, 2)))
    edges = np.float32([[0, 0], [W - 1e-3, H - 1e-3], [W, 0], [0, H],
                        [-1e-3, 3], [3, -1e-3], [W - 0.5, 2], [-0.5, -0.5],
                        [W + 2, H + 2], [-3, H / 2]])
    pos[-len(edges):] = edges
    val = np.float32(rs.normal(size=(n, 3)))
    fb = np.float32(rs.normal(size=(H, W, 3)))
    wb = np.float32(rs.uniform(size=(H, W)))
    return pos, val, fb, wb


def test_develop():
    rs = np.random.RandomState(3)
    fb = np.float32(rs.normal(size=(H, W, 3)))
    wb = np.float32(rs.uniform(size=(H, W)))
    wb[::3, ::5] = 0.0      # pixels no sample reached
    _close(film.develop(torch.from_numpy(fb), torch.from_numpy(wb)),
           ref_film.develop(jnp.asarray(fb), jnp.asarray(wb)), rtol=1e-6,
           atol=1e-6)


def test_splat_unfiltered():
    pos, val, fb, _ = _scatter_inputs()
    ref = ref_film.splat_unfiltered(jnp.asarray(fb), jnp.asarray(pos),
                                    jnp.asarray(val))
    got = film.splat_unfiltered(torch.from_numpy(fb), torch.from_numpy(pos),
                                torch.from_numpy(val))
    _close(got, ref, rtol=1e-5, atol=1e-5)
    # truncation, not flooring: (-0.5, -0.5) is outside and adds nothing
    one = film.splat_unfiltered(torch.zeros(H, W, 3),
                                torch.tensor([[-0.5, -0.5], [0.5, 0.5]]),
                                torch.ones(2, 3))
    assert float(one.sum()) == 3.0 and float(one[0, 0, 0]) == 1.0


def test_scatter_add_is_order_free():
    """The sort + segment sum equals a plain sequential scatter-add
    (index_put_ with accumulate, on the CPU) up to summation order, and
    a second call gives the same bits."""
    pos, val, fb, _ = _scatter_inputs(seed=4)
    px = torch.from_numpy(pos[:, 0]).clamp(0, W - 1).long()
    py = torch.from_numpy(pos[:, 1]).clamp(0, H - 1).long()
    v = torch.from_numpy(val)
    got = film.scatter_add(torch.zeros(H, W, 3), py, px, v)
    ref = torch.zeros(H, W, 3)
    ref.index_put_((py, px), v, accumulate=True)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    again = film.scatter_add(torch.zeros(H, W, 3), py, px, v)
    assert torch.equal(got, again)


def test_importance_sample_direct(scenes):
    rs_scene, ts_scene, _ = scenes
    rs = np.random.RandomState(5)
    p = np.float32(rs.uniform([-100, -100, -300], [650, 650, 900],
                              (4000, 3)))
    rf, rwe, rin = ref_sensor.importance_sample_direct(
        rs_scene.camera, W, H, jnp.asarray(p))
    tf, twe, tin = sensor.importance_sample_direct(
        sensor.describe(ts_scene.camera), W, H, torch.from_numpy(p))
    np.testing.assert_array_equal(tin.numpy(), np.asarray(rin))
    assert 0.05 < float(tin.float().mean()) < 0.95
    _close(tf, rf, rtol=1e-5, atol=1e-4)
    _close(twe, rwe, rtol=1e-5, atol=1e-6)


def _importance_both(rcam, tcam, p):
    rf, rwe, rin = ref_sensor.importance_sample_direct(rcam, W, H,
                                                       jnp.asarray(p))
    tf, twe, tin = sensor.importance_sample_direct(
        sensor.describe(tcam), W, H, torch.from_numpy(p))
    np.testing.assert_array_equal(tin.numpy(), np.asarray(rin))
    _close(tf, rf, rtol=1e-5, atol=1e-4)
    _close(twe, rwe, rtol=1e-5, atol=1e-6)
    return tin


def test_importance_sample_direct_rdist(scenes):
    """perspective_rdist: the light image lands on the distorted film
    (forward distortion before the sample-space transform), the
    importance is the undistorted cos^4 model, as in the reference; ray
    generation inverts the distortion with four Newton steps."""
    rs_scene, ts_scene, _ = scenes
    rcam, tcam = _cameras(rs_scene, ts_scene, kc=[0.08, -0.02])
    rs = np.random.RandomState(6)
    p = np.float32(rs.uniform([-100, -100, -300], [650, 650, 900],
                              (4000, 3)))
    tin = _importance_both(rcam, tcam, p)
    assert 0.05 < float(tin.float().mean()) < 0.95
    pos = np.float32(rs.uniform(0, 1, (500, 2)) * [W, H])
    u_ap = np.float32(rs.uniform(size=(500, 2)))
    ro, rd = ref_sensor.sample_ray(rcam, W, H, jnp.asarray(pos),
                                   jnp.asarray(u_ap))
    to, td = sensor.sample_ray(sensor.describe(tcam), W, H,
                               torch.from_numpy(pos), torch.from_numpy(u_ap))
    _close(to, ro)
    _close(td, rd, rtol=1e-5, atol=1e-5)


def test_importance_sample_direct_rejects_other_sensors(scenes):
    """The other kinds' importance equals the reference's: orthographic
    (constant over the film), the thin lens (the pinhole's cos^4 model,
    the aperture ignored, as in the reference), spherical
    (1 / (2 pi^2 sin theta)) and the meters (invalid)."""
    rs_scene, ts_scene, _ = scenes
    rs = np.random.RandomState(7)
    p = np.float32(rs.uniform([-100, -100, -300], [650, 650, 900],
                              (4000, 3)))
    for fields in ({"kind": 1.0}, {"aperture_radius": 0.5},
                   {"kind": 2.0}, {"kind": 3.0}, {"kind": 4.0}):
        rcam, tcam = _cameras(rs_scene, ts_scene, **fields)
        tin = _importance_both(rcam, tcam, p)
        assert bool(tin.any()) == (fields.get("kind", 0.0) < 3.0)


def test_fast_row_gather():
    table = torch.arange(12.0).reshape(6, 2)
    idx = torch.tensor([[5, 0], [2, 2]], dtype=torch.int32)
    np.testing.assert_array_equal(
        common.fast_row_gather(table, idx).numpy(),
        np.asarray(ref_common.fast_row_gather(jnp.asarray(table.numpy()),
                                              jnp.asarray(idx.numpy()))))


def _nee_inputs(n=3000, seed=1):
    rs = np.random.RandomState(seed)
    p_ref = np.float32(rs.uniform([0, 0, 0], [550, 540, 560], (n, 3)))
    u_sel = np.float32(rs.uniform(size=n))
    u_pos = np.float32(rs.uniform(size=(n, 2)))
    return p_ref, u_sel, u_pos


def test_sample_direct(scenes):
    rs_scene, ts_scene, st = scenes
    n_area = int((np.asarray(rs_scene.emitters.tri_count) > 0).sum())
    p_ref, u_sel, u_pos = _nee_inputs()
    ref = ref_em.sample_direct(rs_scene, n_area, 0, jnp.asarray(p_ref),
                               jnp.asarray(u_sel), jnp.asarray(u_pos))
    got = em.sample_direct(ts_scene, n_area, 0, torch.from_numpy(p_ref),
                           torch.from_numpy(u_sel), torch.from_numpy(u_pos))
    for f in ("d", "dist", "pdf", "radiance", "n", "p", "pdf_area"):
        _close(getattr(got, f), getattr(ref, f))
    for f in ("valid", "is_env", "is_delta"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)))

    # pdf of the same points seen as BSDF-sampled emitter hits
    eid = np.zeros(len(p_ref), np.int32)
    eid[::3] = -1
    r_pdf = ref_em.pdf_area_direct(rs_scene, n_area, False, jnp.asarray(eid),
                                   jnp.asarray(p_ref), ref.p, ref.n)
    t_pdf = em.pdf_area_direct(ts_scene, n_area, False, torch.from_numpy(eid),
                               torch.from_numpy(p_ref), got.p, got.n)
    _close(t_pdf, r_pdf)


def _diffuse_inputs(M, n=4000, seed=2):
    rs = np.random.RandomState(seed)
    mid = rs.randint(0, M, n).astype(np.int32)
    wi = np.float32(rs.normal(size=(n, 3)))
    wi /= np.linalg.norm(wi, axis=-1, keepdims=True)
    wo = np.float32(rs.normal(size=(n, 3)))
    wo /= np.linalg.norm(wo, axis=-1, keepdims=True)
    u2 = np.float32(rs.uniform(size=(n, 2)))
    uc = np.float32(rs.uniform(size=n))
    return mid, wi, wo, u2, uc


@pytest.mark.parametrize("twosided", [False, True])
def test_diffuse_bsdf(scenes, twosided):
    rs_scene, ts_scene, _ = scenes
    rmat, tmat = rs_scene.materials, ts_scene.materials
    if twosided:   # flip the two-sided flag on every row (packed col 1)
        rmat = rmat._replace(packed=rmat.packed.at[:, 1].set(1.0))
        tmat = tmat._replace(packed=tmat.packed.clone())
        tmat.packed[:, 1] = 1.0
    kinds = frozenset({0})
    assert bsdf.scene_kinds(ts_scene) == ref_bsdf.scene_kinds(rs_scene)
    mid, wi, wo, u2, uc = _diffuse_inputs(rmat.packed.shape[0])
    rp = ref_bsdf.gather_params(rmat, jnp.asarray(mid))
    tp = bsdf.gather_params(tmat, torch.from_numpy(mid))
    for f in ("kind", "twosided", "reflectance", "spec_weight", "opacity"):
        _close(getattr(tp, f), getattr(rp, f))
    jw = [jnp.asarray(a) for a in (wi, wo, u2, uc)]
    tw = [torch.from_numpy(a) for a in (wi, wo, u2, uc)]
    _close(bsdf.eval(tp, tw[0], tw[1], kinds),
           ref_bsdf.eval(rp, jw[0], jw[1], kinds))
    _close(bsdf.pdf(tp, tw[0], tw[1], kinds),
           ref_bsdf.pdf(rp, jw[0], jw[1], kinds))
    rsam = ref_bsdf.sample(rp, jw[0], jw[2], jw[3], kinds)
    tsam = bsdf.sample(tp, tw[0], tw[2], tw[3], kinds)
    for f in ("wo", "weight", "pdf", "eta"):
        _close(getattr(tsam, f), getattr(rsam, f))
    for f in ("is_delta", "valid"):
        np.testing.assert_array_equal(getattr(tsam, f).numpy(),
                                      np.asarray(getattr(rsam, f)))
    _close(bsdf.roughness(tmat, torch.from_numpy(mid)),
           ref_bsdf.roughness(rmat, jnp.asarray(mid)))
    assert bsdf.any_specular(tmat, 1e-3) == ref_bsdf.any_specular(rmat, 1e-3)


def test_non_diffuse_kinds_raise(scenes):
    """Every kind of the reference dispatches (woven cloth, 16, the last
    one that raised here, is ported); a static set naming an unknown
    kind raises."""
    _, ts_scene, _ = scenes
    tp = bsdf.gather_params(ts_scene.materials, torch.zeros(4, dtype=torch.int32))
    f = bsdf.eval(tp, torch.ones(4, 3), torch.ones(4, 3), frozenset({0, 16}))
    assert torch.isfinite(f).all()
    with pytest.raises(ValueError):
        bsdf.eval(tp, torch.ones(4, 3), torch.ones(4, 3), frozenset({0, 99}))


def test_fill_intersection(scenes):
    """Closest hits of camera rays through the plain sweeps, then the hit
    fill (position, normals, uv, ids) on lanes whose prim agrees."""
    rs_scene, ts_scene, _ = scenes
    (ro, rd), (to, td) = _camera_rays(rs_scene, ts_scene, n=3000, seed=5)
    n = ro.shape[0]
    maxt = np.full(n, 3e38, np.float32)
    maxt[::7] = -1.0
    rhit = ref_isec.intersect_matmul(ro, rd, jnp.zeros(n), jnp.asarray(maxt),
                                     rs_scene.geom.linC)
    thit = isec.intersect_matmul(to, td, torch.zeros(n),
                                 torch.from_numpy(maxt), ts_scene.geom.linC)
    np.testing.assert_array_equal(thit.valid.numpy(), np.asarray(rhit.valid))
    same = thit.prim.numpy() == np.asarray(rhit.prim)
    assert same.mean() >= 0.998
    rits = ref_common.fill_intersection(rs_scene, ro, rd, rhit)
    tits = common.fill_intersection(ts_scene, to, td, thit)
    for f in ("t", "p", "ng", "ns", "uv"):
        _close(getattr(tits, f).numpy()[same],
               np.asarray(getattr(rits, f))[same], rtol=1e-5, atol=1e-4)
    for f in ("valid", "prim_id", "shape_id", "bsdf_id", "emitter_id"):
        np.testing.assert_array_equal(getattr(tits, f).numpy()[same],
                                      np.asarray(getattr(rits, f))[same])
    assert tits.bary is None


def test_offset_ray_origin():
    rs = np.random.RandomState(3)
    p, ng, d = (np.float32(rs.normal(size=(500, 3))) for _ in range(3))
    eps = np.float32(1e-3)
    ref = ref_common.offset_ray_origin(*map(jnp.asarray, (p, ng, d, eps)))
    got = common.offset_ray_origin(*map(torch.from_numpy, (p, ng, d)),
                                   torch.tensor(eps))
    _close(got, ref)
