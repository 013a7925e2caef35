"""Every sensor kind of the reference's ops/sensor.py in the port
against the reference on the CPU, on tests/test_sensors.py's scenes:
orthographic, telecentric (with an aperture), spherical, the
radiancemeter, the fluencemeter and perspective_rdist (kc nonzero and
zero).  sample_ray and importance_sample_direct at rtol 1e-5 on seeded
film positions, lens samples and world points; each scene through path
in both packages at rtol 1e-3 on >= 99% of pixels with equal rays; and
each reference test's own expectation on the port: the spherical camera
in a constant environment reads 2 on >= 95% of pixels, the
radiancemeter (3, 2, 1), the fluencemeter 2 within 2%, rdist with
kc = 0 the perspective's rays.  The scenes are tools/sensor_scenes.py's
(tests/test_sensors.py's)."""
import importlib.util
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gradientdomain_mitsuba_tpu.ops import sensor as ref_sensor
from gradientdomain_mitsuba_tpu.scene import scene as ref_scene
from gradientdomain_mitsuba_tpu_torch.models.path import PathTracer
from gradientdomain_mitsuba_tpu_torch.ops import sensor
from gradientdomain_mitsuba_tpu_torch.scene import bridge
from gradientdomain_mitsuba_tpu_torch.scene import scene as port_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def sensor_scenes():
    """tools/sensor_scenes.py, loaded from its path."""
    spec = importlib.util.spec_from_file_location(
        "sensor_scenes", os.path.join(ROOT, "tools/sensor_scenes.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SCENES = sensor_scenes().SCENES
KIND = sensor_scenes().KIND


def _write(xml):
    fd, path = tempfile.mkstemp(suffix=".xml")
    with os.fdopen(fd, "w") as f:
        f.write(xml)
    return path


def load_port(xml):
    """The port's scene (CPU tensors) and settings of an XML string."""
    path = _write(xml)
    try:
        s, st = port_scene.load_scene(path)
    finally:
        os.unlink(path)
    return bridge.to_torch(s, "cpu"), st


@pytest.fixture(scope="module", params=sorted(SCENES))
def both(request):
    """(name, numpy scene, reference scene, port scene, settings) of one
    sensor scene, loaded once."""
    path = _write(SCENES[request.param])
    try:
        s, st = ref_scene.load_scene(path)
    finally:
        os.unlink(path)
    return (request.param, s, jax.device_put(s), bridge.to_torch(s, "cpu"),
            st)


def test_sample_ray_matches_reference(both):
    name, _, rs_scene, ts_scene, st = both
    desc = sensor.describe(ts_scene.camera)
    assert desc.kind == KIND[name]
    assert desc.lens == (name == "telecentric")
    assert desc.rdist == (name == "rdist")
    W, H = st.width, st.height
    rs = np.random.RandomState(11)
    pos = np.float32(rs.uniform(0, 1, (3000, 2)) * [W, H])
    u = np.float32(rs.uniform(size=(3000, 2)))
    ro, rd = ref_sensor.sample_ray(rs_scene.camera, W, H, jnp.asarray(pos),
                                   jnp.asarray(u))
    to, td = sensor.sample_ray(desc, W, H, torch.from_numpy(pos),
                               torch.from_numpy(u))
    np.testing.assert_allclose(to.numpy(), np.asarray(ro), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(td.numpy(), np.asarray(rd), rtol=1e-5,
                               atol=1e-5)


def test_importance_matches_reference(both):
    name, _, rs_scene, ts_scene, st = both
    W, H = st.width, st.height
    rs = np.random.RandomState(12)
    p = np.float32(rs.uniform(-6, 6, (3000, 3)))
    rf, rwe, rin = ref_sensor.importance_sample_direct(
        rs_scene.camera, W, H, jnp.asarray(p))
    tf, twe, tin = sensor.importance_sample_direct(
        sensor.describe(ts_scene.camera), W, H, torch.from_numpy(p))
    np.testing.assert_array_equal(tin.numpy(), np.asarray(rin))
    assert bool(tin.any()) == (KIND[name] < 3)
    np.testing.assert_allclose(tf.numpy(), np.asarray(rf), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(twe.numpy(), np.asarray(rwe), rtol=1e-5,
                               atol=1e-6)


def test_path_render_matches_reference(both):
    """The scene through path in both packages (the reference's
    intersectors pinned to the matmul sweeps), seed 1."""
    from torch_parity import make_both
    name, s, _, _, st = both
    rt, rs_scene, pt, ts_scene = make_both(s, st)
    rt.count_rays = pt.count_rays = True
    spp = min(st.spp, 16)
    ref = np.asarray(rt.render(rs_scene, seed=1, spp=spp))
    got = pt.render(ts_scene, seed=1, spp=spp).numpy()
    assert got.shape == ref.shape == (st.height, st.width, 3)
    assert np.isfinite(got).all()
    frac = np.isclose(got, ref, rtol=1e-3, atol=1e-4).all(-1).mean()
    assert frac >= 0.99, frac
    assert int(pt.last_ray_count) == int(rt.last_ray_count) > 0


def _render(name, spp, seed=0):
    ts, st = load_port(SCENES[name])
    return PathTracer(ts, st).render(ts, seed=seed, spp=spp).numpy()


def test_spherical_constant_env():
    img = _render("spherical", 4)
    frac = (np.abs(img - 2.0) < 1e-4).all(-1).mean()
    assert frac > 0.95, frac


def test_radiancemeter_reads_emitter_radiance():
    img = _render("radiancemeter", 4)
    assert img.shape[:2] == (1, 1)
    np.testing.assert_allclose(img[0, 0], [3, 2, 1], rtol=1e-5)


def test_fluencemeter_uniform_env():
    img = _render("fluencemeter", 256)
    np.testing.assert_allclose(img[0, 0], [2, 2, 2], rtol=0.02)


def test_rdist_zero_kc_equals_perspective():
    """perspective_rdist with kc = 0 renders the perspective sensor's
    image (perspective_rdist.cpp degenerates to perspective.cpp)."""
    ts, _ = load_port(SCENES["rdist0"])
    pos = torch.tensor([[16.0, 16.0], [3.0, 28.0], [30.0, 2.0]])
    u = torch.zeros(3, 2)
    desc = sensor.describe(ts.camera)
    assert not desc.rdist
    _, d1 = sensor.sample_ray(desc, 32, 32, pos, u)
    ts1, _ = load_port(SCENES["rdist"])
    desc1 = sensor.describe(ts1.camera._replace(kc=torch.zeros(2)))
    assert not desc1.rdist
    _, d0 = sensor.sample_ray(desc1, 32, 32, pos, u)
    np.testing.assert_allclose(d1.numpy(), d0.numpy(), atol=1e-6)
    np.testing.assert_array_equal(_render("rdist0", 4),
                                  _render("perspective", 4))
