"""The port's G-BDPT against the reference on the CPU: cbox 16^2, 2 spp,
maxDepth 3, seed 3.

The reference's intersectors are pinned to the linear-MT matmul sweeps,
as in test_torch_gpt.py.  primal (with the light image), very_direct, dx
and dy then agree at rtol 1e-3 / atol 1e-4 on >= 99% of pixels and the
measured ray counts are equal.  The L1 final (models/poisson.reconstruct
on the buffers, the reference CLI's post-pass) is compared by objective
and mean, because the reference's own L1 IRLS moves by more than that
tolerance under one-ulp input changes (test_torch_poisson.py).  One
reference render per configuration (default, and
lightImageGradients=false)."""
import copy
import os

import jax
import numpy as np
import pytest
import torch

from gradientdomain_mitsuba_tpu.models import gbdpt as ref_gbdpt
from gradientdomain_mitsuba_tpu.models import poisson as ref_poisson
from gradientdomain_mitsuba_tpu.ops import common as ref_common
from gradientdomain_mitsuba_tpu.ops import intersect as ref_isec
from gradientdomain_mitsuba_tpu.scene import scene as ref_scene
from gradientdomain_mitsuba_tpu_torch.models import bdpt, gbdpt, poisson
from gradientdomain_mitsuba_tpu_torch.scene import bridge
from gradientdomain_mitsuba_tpu_torch.scene import scene as port_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CBOX = os.path.join(ROOT, "data/scenes/cbox/cbox.xml")
VARS = {"width": "16", "height": "16", "spp": "2", "maxDepth": "3",
        "integrator": "gbdpt"}
SEED, SPP = 3, 2
BUFS = ("primal", "very_direct", "dx", "dy")


def _pinned_matmul(settings, n_tris, n_clusters=0):
    def closest(o, d, mint, maxt, geom):
        return ref_isec.intersect_matmul(o, d, mint, maxt, geom.linC)

    def occl(o, d, mint, maxt, geom):
        return ref_isec.occluded_matmul(o, d, mint, maxt, geom.linC)
    return ref_common.add_sphere_intersections(closest, occl)


def _settings(light_image_grads=True):
    scene, st = ref_scene.load_scene(CBOX, VARS)
    if not light_image_grads:
        st = copy.deepcopy(st)
        st.integrator_props["lightImageGradients"] = False
    return scene, st


def _reference(light_image_grads):
    mp = pytest.MonkeyPatch()
    mp.setattr(ref_common, "choose_intersector", _pinned_matmul)
    try:
        scene, st = _settings(light_image_grads)
        tracer = ref_gbdpt.GBDPTracer(scene, st)
        tracer.count_rays = True
        bufs = tracer.render(jax.device_put(scene), seed=SEED, spp=SPP)
    finally:
        mp.undo()
    out = {k: np.asarray(bufs[k]) for k in BUFS}
    out["rays"] = tracer.last_ray_count
    out["L1"] = np.asarray(ref_poisson.reconstruct(bufs, mode="L1"))
    return out


def _port(light_image_grads):
    scene, st = _settings(light_image_grads)
    ts = bridge.to_torch(scene, "cpu")
    tracer = gbdpt.GBDPTracer(ts, st)
    tracer.count_rays = True
    bufs = tracer.render(ts, seed=SEED, spp=SPP)
    assert tracer.kernels[0].launches == 0   # CPU: plain versions
    out = {k: bufs[k].numpy() for k in BUFS}
    out["rays"] = tracer.last_ray_count
    out["L1"] = poisson.reconstruct(bufs, mode="L1").numpy()
    return out


@pytest.fixture(scope="module")
def reference():
    return _reference(True)


@pytest.fixture(scope="module")
def port():
    return _port(True)


def _frac_close(got, ref):
    return np.isclose(got, ref, rtol=1e-3, atol=1e-4).all(-1).mean()


def _mean_close(got, ref):
    return abs(got.mean() - ref.mean()) <= 1e-4 * abs(ref.mean()) + 1e-6


@pytest.mark.parametrize("name", BUFS)
def test_gbdpt_buffers_match_reference(reference, port, name):
    got, ref = port[name], reference[name]
    assert got.shape == ref.shape == (16, 16, 3)
    assert np.isfinite(got).all()
    assert _frac_close(got, ref) >= 0.99
    assert _mean_close(got, ref)
    assert np.abs(ref).max() > 0


def test_gbdpt_ray_counts_equal(reference, port):
    assert port["rays"] == reference["rays"] > 0


def test_gbdpt_l1_final_matches_reference(reference, port):
    got, ref = port["L1"], reference["L1"]
    assert np.isfinite(got).all()
    assert abs(got.mean() - ref.mean()) < 5e-3 * abs(ref.mean())
    p, gx, gy = (reference[k] for k in ("primal", "dx", "dy"))
    vd = reference["very_direct"]

    def energy(x):
        gxm, gym = gx.copy(), gy.copy()
        gxm[:, -1] = 0.0
        gym[-1] = 0.0
        dx = np.pad(x[:, 1:] - x[:, :-1], ((0, 0), (0, 1), (0, 0)))
        dy = np.pad(x[1:] - x[:-1], ((0, 1), (0, 0), (0, 0)))
        return (np.abs(dx - gxm).sum() + np.abs(dy - gym).sum() +
                0.2 * np.abs(x - p).sum())

    e_ref, e_got = energy(ref - vd), energy(got - vd)
    assert abs(e_got - e_ref) <= 0.01 * e_ref, (e_got, e_ref)


def test_gbdpt_primal_equals_bdpt(port):
    """primal (incl. the light image) + very_direct == the BDPT image at
    the same seed: the gradient machinery does not perturb the primal
    estimator (tests/test_bdpt.py's identity, on the port)."""
    scene, st = _settings()
    ts = bridge.to_torch(scene, "cpu")
    img = bdpt.BDPTracer(ts, st).render(ts, seed=SEED, spp=SPP).numpy()
    np.testing.assert_allclose(port["primal"] + port["very_direct"], img,
                               rtol=2e-4, atol=2e-5)


def test_gbdpt_lightimage_grads_knob(port):
    """lightImageGradients=false leaves primal and very_direct
    bit-identical and takes the light image's share out of the gradients;
    its gradients match the reference's under the same knob."""
    off = _port(False)
    for k in ("primal", "very_direct"):
        np.testing.assert_array_equal(off[k], port[k])
    assert np.abs(off["dx"] - port["dx"]).max() > 0
    assert off["rays"] < port["rays"]
    ref_off = _reference(False)
    for k in ("dx", "dy"):
        assert _frac_close(off[k], ref_off[k]) >= 0.99, k
    assert off["rays"] == ref_off["rays"]


def test_gbdpt_render_is_deterministic():
    scene, st = _settings()
    ts = bridge.to_torch(scene, "cpu")
    a = gbdpt.GBDPTracer(ts, st).render_chunk(ts, SEED, 0, SPP)
    b = gbdpt.GBDPTracer(ts, st).render_chunk(ts, SEED, 0, SPP)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("scene_file,item", [
    ("cbox-mats/cbox-mats.xml", "item 12"),
    ("envmap/envmap.xml", "item 14")])
@pytest.mark.parametrize("cls", [bdpt.BDPTracer, gbdpt.GBDPTracer])
def test_unported_scenes_raise(scene_file, item, cls):
    """Both scenes that raised here build and render: envmap.xml (its
    environment emitter was item 14; the eye walk's aux family in BDPT,
    the aux-only G-PT pass in G-BDPT; against the reference:
    tests/test_torch_envmap_bdpt.py) and cbox-mats.xml (a roughconductor
    and a textured floor, item 12 before; against the reference:
    tests/test_torch_gbdpt_glossy.py), as woven cloth, item 12's last
    kind, now does (tests/test_torch_irawan.py)."""
    scene, st = port_scene.load_scene(
        os.path.join(ROOT, "data/scenes", scene_file),
        {"width": "8", "height": "8", "integrator": "gbdpt",
         "maxDepth": "3"})
    ts = bridge.to_torch(scene, "cpu")
    tracer = cls(ts, st)
    if "envmap" in scene_file:
        assert tracer.aux_nee
        assert tracer.aux_via_gpt == (cls is gbdpt.GBDPTracer)
    out = tracer.render(ts, seed=SEED, spp=1)
    for v in (out.values() if isinstance(out, dict) else [out]):
        assert torch.isfinite(v).all()


def test_any_specular_turns_the_replay_on(monkeypatch, port):
    """A specular or glossy vertex class selects the half-vector prefix
    replay and the full offset evaluation (no suffix factorization); the
    primal estimator does not move (the replay's parity with the
    reference: test_torch_gbdpt_specular.py)."""
    scene, st = port_scene.load_scene(CBOX, VARS)
    ts = bridge.to_torch(scene, "cpu")
    assert not gbdpt.GBDPTracer(ts, st).any_specular
    monkeypatch.setattr(gbdpt.bsdf_ops, "any_specular", lambda *a: True)
    tracer = gbdpt.GBDPTracer(ts, st)
    assert tracer.any_specular
    bufs = tracer.render(ts, seed=SEED, spp=SPP)
    for k in ("primal", "very_direct"):
        np.testing.assert_array_equal(bufs[k].numpy(), port[k], k)
