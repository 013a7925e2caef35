"""The port's BDPT against the reference on the CPU: cbox 16^2, 2 spp,
maxDepth 4, seed 3.

As in test_torch_gpt.py, the reference's intersectors are pinned to the
linear-MT matmul sweeps (intersect_matmul / occluded_matmul), the math
the port's plain sweep versions compute, so both sides trace the same
hits.  The image and the light image alone then agree at rtol 1e-3 /
atol 1e-4 on >= 99% of pixels, and the measured ray counts are equal.
One reference render_chunk per configuration (default, and
lightImage=false) gives the eye film, its weights, the light image and
the rays; its finalize gives the image."""
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gradientdomain_mitsuba_tpu.models import bdpt as ref_bdpt
from gradientdomain_mitsuba_tpu.ops import common as ref_common
from gradientdomain_mitsuba_tpu.ops import intersect as ref_isec
from gradientdomain_mitsuba_tpu.scene import scene as ref_scene
from gradientdomain_mitsuba_tpu_torch.models import bdpt
from gradientdomain_mitsuba_tpu_torch.scene import bridge
from torch_parity import one_thread  # noqa: F401

# torch on one thread: the suite runs six workers, and a multi-threaded
# CPU torch among them spends the renders' time contending for cores
pytestmark = pytest.mark.usefixtures("one_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CBOX = os.path.join(ROOT, "data/scenes/cbox/cbox.xml")
VARS = {"width": "16", "height": "16", "spp": "2", "maxDepth": "4",
        "integrator": "bdpt"}
SEED, SPP = 3, 2


def _pinned_matmul(settings, n_tris, n_clusters=0):
    def closest(o, d, mint, maxt, geom):
        return ref_isec.intersect_matmul(o, d, mint, maxt, geom.linC)

    def occl(o, d, mint, maxt, geom):
        return ref_isec.occluded_matmul(o, d, mint, maxt, geom.linC)
    return ref_common.add_sphere_intersections(closest, occl)


def _settings(light_image=True):
    scene, st = ref_scene.load_scene(CBOX, VARS)
    if not light_image:
        st = copy.deepcopy(st)
        st.integrator_props["lightImage"] = False
    return scene, st


def _reference(light_image):
    mp = pytest.MonkeyPatch()
    mp.setattr(ref_common, "choose_intersector", _pinned_matmul)
    try:
        scene, st = _settings(light_image)
        tracer = ref_bdpt.BDPTracer(scene, st)
        tracer.count_rays = True
        fb, wb, li, rays = tracer.render_chunk(jax.device_put(scene), SEED,
                                               0, SPP)
    finally:
        mp.undo()
    state = {"0": np.asarray(fb), "1": np.asarray(wb), "2": np.asarray(li)}
    return dict(image=np.asarray(tracer.finalize(state, SPP)),
                light=np.asarray(li) / SPP, rays=float(rays))


def _port(light_image):
    scene, st = _settings(light_image)
    ts = bridge.to_torch(scene, "cpu")
    tracer = bdpt.BDPTracer(ts, st)
    tracer.count_rays = True
    fb, wb, li, rays = tracer.render_chunk(ts, SEED, 0, SPP)
    image = tracer.finalize({"0": fb, "1": wb, "2": li}, SPP)
    assert tracer.kernels[0].launches == 0   # CPU: plain versions
    return dict(image=image.numpy(), light=(li / SPP).numpy(),
                rays=int(rays))


@pytest.fixture(scope="module")
def reference():
    return _reference(True)


@pytest.fixture(scope="module")
def port():
    return _port(True)


def _frac_close(got, ref):
    return np.isclose(got, ref, rtol=1e-3, atol=1e-4).all(-1).mean()


@pytest.mark.parametrize("name", ["image", "light"])
def test_bdpt_matches_reference(reference, port, name):
    got, ref = port[name], reference[name]
    assert got.shape == ref.shape == (16, 16, 3)
    assert np.isfinite(got).all()
    assert _frac_close(got, ref) >= 0.99
    assert abs(got.mean() - ref.mean()) <= 1e-4 * abs(ref.mean()) + 1e-7
    assert ref.mean() > 0


def test_bdpt_ray_counts_equal(reference, port):
    assert port["rays"] == reference["rays"] > 0


def test_bdpt_render_matches_render_chunk(port):
    """render (render_accumulate + finalize) gives the render_chunk image
    and counts the same rays."""
    scene, st = _settings()
    ts = bridge.to_torch(scene, "cpu")
    tracer = bdpt.BDPTracer(ts, st)
    tracer.count_rays = True
    img = tracer.render(ts, seed=SEED, spp=SPP)
    np.testing.assert_array_equal(img.numpy(), port["image"])
    assert tracer.last_ray_count == port["rays"]


def test_bdpt_render_is_deterministic():
    scene, st = _settings()
    ts = bridge.to_torch(scene, "cpu")
    a = bdpt.BDPTracer(ts, st).render_chunk(ts, SEED, 0, SPP)
    b = bdpt.BDPTracer(ts, st).render_chunk(ts, SEED, 0, SPP)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_bdpt_no_lightimage_matches_reference():
    """lightImage=false: the t=1 family leaves the sampling and every MIS
    denominator on both sides (the camera is not connectable)."""
    ref = _reference(False)
    got = _port(False)
    assert not got["light"].any() and not ref["light"].any()
    assert _frac_close(got["image"], ref["image"]) >= 0.99
    assert got["rays"] == ref["rays"] > 0


def test_is_delta_kind_matches_reference():
    """The delta-vertex predicate over a table with delta kinds
    (cbox-mats: dielectric, conductor, ...), including -1 ids."""
    scene, _ = ref_scene.load_scene(
        os.path.join(ROOT, "data/scenes/cbox-mats/cbox-mats.xml"),
        {"width": "8", "height": "8"})
    ts = bridge.to_torch(scene, "cpu")
    M = int(scene.materials.kind.shape[0])
    ids = np.arange(-1, M, dtype=np.int32).repeat(3)
    ref = np.asarray(ref_bdpt._is_delta_kind(
        jax.device_put(scene.materials), jnp.asarray(ids)))
    got = bdpt._is_delta_kind(ts.materials, torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert ref.any() and not ref.all()


def _random_subpath(rng, N, D):
    def f32(*s):
        return torch.from_numpy(rng.standard_normal(s).astype(np.float32))

    def unit(*s):
        a = rng.standard_normal(s)
        return torch.from_numpy(
            (a / np.linalg.norm(a, axis=-1, keepdims=True)).astype(
                np.float32))
    sp = bdpt.SubPath(
        p=f32(N, D, 3), ng=unit(N, D, 3), ns=unit(N, D, 3),
        wi=unit(N, D, 3), uv=f32(N, D, 2).abs() % 1.0,
        bsdf_id=torch.zeros((N, D), dtype=torch.int32),
        emitter_id=torch.full((N, D), -1, dtype=torch.int32),
        beta=f32(N, D, 3).abs(), pdf_fwd=f32(N, D).abs() + 0.1,
        pdf_rev=f32(N, D).abs() + 0.1,
        delta=torch.zeros((N, D), dtype=torch.bool),
        valid=torch.ones((N, D), dtype=torch.bool))
    y0 = bdpt.LightStart(
        p=f32(N, 3), ng=unit(N, 3), rad=f32(N, 3).abs(),
        pdf_pos=f32(N).abs() + 0.1, beta=f32(N, 3).abs(),
        ok=torch.ones(N, dtype=torch.bool), pdf_rev=f32(N).abs() + 0.1)
    return sp, y0, f32, unit


def test_slot_overlay_matches_materialized_view():
    """SlotOverlay (G-BDPT's copy-free t=1 shifted view) is
    indistinguishable from a materialized view for every column reader:
    _col, _mis_sum, _eval_at and _pdf_toward_prev (tests/test_bdpt.py's
    check, on the port)."""
    scene, st = _settings()
    ts = bridge.to_torch(scene, "cpu")
    tr = bdpt.BDPTracer(ts, st)
    N, D, kl = 64, 3, 1
    sp, y0, f32, unit = _random_subpath(np.random.default_rng(7), N, D)
    over = {("p", kl): f32(N, 3), ("ns", kl): unit(N, 3),
            ("ng", kl): unit(N, 3), ("wi", kl): unit(N, 3),
            ("uv", kl): f32(N, 2).abs() % 1.0,
            ("bsdf_id", kl): torch.zeros(N, dtype=torch.int32),
            ("beta", kl): f32(N, 3).abs(),
            ("pdf_fwd", kl): f32(N).abs() + 0.1,
            ("pdf_rev", 0): f32(N).abs() + 0.1,
            ("delta", kl): torch.zeros(N, dtype=torch.bool),
            ("valid", kl): torch.ones(N, dtype=torch.bool)}
    ov = bdpt.SlotOverlay(sp, over)
    mat = sp._replace(**{name: getattr(sp, name).clone()
                         for name in sp._fields if name != "aux"})
    for (name, k), val in over.items():
        getattr(mat, name)[:, k] = val

    for name in ("p", "ns", "beta", "pdf_fwd", "pdf_rev", "delta",
                 "emitter_id"):
        for k in range(D):
            assert torch.equal(bdpt._col(ov, name, k),
                               getattr(mat, name)[:, k]), (name, k)

    args = [f32(N).abs() + 0.1 for _ in range(4)]
    a = tr._mis_sum(ov, ov, y0, 3, 1, *args)
    b = tr._mis_sum(mat, mat, y0, 3, 1, *args)
    torch.testing.assert_close(a, b, rtol=1e-6, atol=0)
    wo = unit(N, 3)
    for x, y in zip(tr._eval_at(ts, ov, kl, wo), tr._eval_at(ts, mat, kl,
                                                             wo)):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=0)
    torch.testing.assert_close(
        tr._pdf_toward_prev(ts, ov, kl, wo, y0.p, y0.ng),
        tr._pdf_toward_prev(ts, mat, kl, wo, y0.p, y0.ng), rtol=1e-6, atol=0)


def test_slot_overlay_whole_field_read_raises():
    """Reading an overridden field as a whole array raises instead of
    silently passing the base array through; other fields read through."""
    sp, _, f32, _ = _random_subpath(np.random.default_rng(1), 8, 2)
    ov = bdpt.SlotOverlay(sp, {("p", 1): f32(8, 3)})
    with pytest.raises(AttributeError, match="column by column"):
        ov.p
    assert ov.ns is sp.ns
    with pytest.raises(AttributeError):
        ov.p = sp.p


def test_max_bdpt_depth_caps_unlimited_depth():
    scene, st = _settings()
    st = copy.deepcopy(st)
    st.max_depth = -1
    tr = bdpt.BDPTracer(bridge.to_torch(scene, "cpu"), st)
    assert tr.depth == tr.TE == tr.SM == bdpt.MAX_BDPT_DEPTH == \
        ref_bdpt.MAX_BDPT_DEPTH
