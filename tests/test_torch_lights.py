"""The port's emitter and warp ops of ROADMAP step G2b against the
reference on the CPU: the uniform sphere / hemisphere / cone warps and
the tent (rtol 1e-6), sample_direct over area, delta (point, spot,
directional) lights and the constant environment, eval_env,
pdf_env_direct and pdf_area_direct (rtol 1e-5 on >= 99.9% of lanes, 1e-4
on all), the sunsky bake, the bridge's emitter and sensor tables, the
sensor description (no host read when rays are made), the delta
lights' photon starts (SPPM) and the new warps' chi^2 against their
own pdfs.  Inputs are made from numpy seeds; the scenes are the lights
board (tools/lights_board.py) and tests/test_sunsky.py's scene."""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gradientdomain_mitsuba_tpu.core import warp as ref_warp
from gradientdomain_mitsuba_tpu.ops import emitter as ref_em
from gradientdomain_mitsuba_tpu.scene import scene as ref_scene
from gradientdomain_mitsuba_tpu_torch.core import warp
from gradientdomain_mitsuba_tpu_torch.ops import emitter as em
from gradientdomain_mitsuba_tpu_torch.ops import sensor
from gradientdomain_mitsuba_tpu_torch.scene import bridge
from gradientdomain_mitsuba_tpu_torch.scene import scene as port_scene
from torch_parity import op_close
from torch_parity import one_thread  # noqa: F401

# torch on one thread: the suite runs six workers, and a multi-threaded
# CPU torch among them spends the renders' time contending for cores
pytestmark = pytest.mark.usefixtures("one_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 20000


def lights_board():
    """tools/lights_board.py, loaded from its path."""
    spec = importlib.util.spec_from_file_location(
        "lights_board", os.path.join(ROOT, "tools/lights_board.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def board(tmp_path_factory):
    """(board path, numpy scene, reference scene as jax arrays, port
    scene as CPU tensors, settings) from one load."""
    path = lights_board().write_board(str(tmp_path_factory.mktemp("lb")))
    s, st = ref_scene.load_scene(path, {"width": "16", "height": "16"})
    return path, s, jax.device_put(s), bridge.to_torch(s, "cpu"), st


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


# --------------------------------------------------------------- warps

@pytest.mark.parametrize("name", ["sphere", "hemisphere", "cone", "tent"])
def test_uniform_warps_match_reference(name):
    rs = np.random.RandomState(1)
    u = np.float32(rs.uniform(size=(N, 2)))
    if name == "cone":
        cos_c = np.float32(rs.uniform(-0.9, 0.99, size=N))
        got = warp.square_to_uniform_cone(*_t(u, cos_c))
        ref = ref_warp.square_to_uniform_cone(*_j(u, cos_c))
        np.testing.assert_allclose(
            warp.square_to_uniform_cone_pdf(*_t(cos_c)).numpy(),
            np.asarray(ref_warp.square_to_uniform_cone_pdf(*_j(cos_c))),
            rtol=1e-6)
    elif name == "tent":
        got = warp.interval_to_tent(*_t(u[:, 0]))
        ref = ref_warp.interval_to_tent(*_j(u[:, 0]))
    else:
        got = getattr(warp, f"square_to_uniform_{name}")(*_t(u))
        ref = getattr(ref_warp, f"square_to_uniform_{name}")(*_j(u))
        assert (getattr(warp, f"square_to_uniform_{name}_pdf")() ==
                pytest.approx(float(getattr(
                    ref_warp, f"square_to_uniform_{name}_pdf")()), rel=1e-7))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("name", ["sphere", "cone"])
def test_uniform_warp_chi2(name):
    """Each warp's samples against its own pdf: chi^2 over 8 x 16 bins
    of (cos theta, phi) at 200k lanes, below the 99.9% quantile of its
    127 degrees of freedom (the chip check runs 1M lanes)."""
    rs = np.random.RandomState(2)
    u = torch.from_numpy(np.float32(rs.uniform(size=(200000, 2))))
    cos_c = 0.6
    if name == "sphere":
        d = warp.square_to_uniform_sphere(u)
        lo = -1.0
    else:
        d = warp.square_to_uniform_cone(u, cos_c)
        lo = cos_c
    z = d[:, 2].numpy().astype(np.float64)
    phi = np.arctan2(d[:, 1].numpy(), d[:, 0].numpy()) % (2 * np.pi)
    hist, _, _ = np.histogram2d(z, phi, bins=(8, 16),
                                range=((lo, 1.0), (0, 2 * np.pi)))
    expect = len(z) / hist.size     # uniform in (z, phi) for both
    chi2 = ((hist - expect) ** 2 / expect).sum()
    assert chi2 < 181.99, chi2      # chi^2_{127}, p = 0.999
    assert np.allclose(np.linalg.norm(d.numpy(), axis=-1), 1.0, atol=1e-5)


# ---------------------------------------------------------- emitter ops

@pytest.mark.parametrize("n_area", [1, 0])
def test_sample_direct_with_deltas_and_constant_env(board, n_area):
    """NEE over the board's area light, its point, spot and directional
    lights and the constant environment, in the reference's pick order;
    n_area 0 is the aux family's draw (BDPT's aux NEE, G-BDPT's aux-only
    G-PT)."""
    _, _, rs_scene, ts_scene, st = board
    assert (st.n_delta, st.env_kind) == (3, em.ENV_CONSTANT)
    rs = np.random.RandomState(3)
    p_ref = np.float32(rs.uniform([20, 5, 20], [530, 500, 540], (N, 3)))
    u_sel = np.float32(rs.uniform(size=N))
    u_pos = np.float32(rs.uniform(size=(N, 2)))
    ref = ref_em.sample_direct(rs_scene, n_area, st.env_kind,
                               *_j(p_ref, u_sel, u_pos), n_delta=3)
    got = em.sample_direct(ts_scene, n_area, st.env_kind,
                           *_t(p_ref, u_sel, u_pos), n_delta=3)
    for name in ("is_env", "is_delta", "valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)), name)
    for name in ("d", "dist", "pdf", "radiance", "n", "p", "pdf_area"):
        op_close(getattr(got, name), getattr(ref, name), name)
    delta = got.is_delta.numpy()
    assert delta.mean() > 0.4 and got.is_env.any()
    # the spot's falloff zeroes some lanes, the others see 1/d^2
    assert (~got.valid.numpy() & delta).any()
    assert (got.valid.numpy() & delta).any()


def test_eval_env_and_pdfs_constant(board):
    _, _, rs_scene, ts_scene, st = board
    rs = np.random.RandomState(4)
    v = rs.normal(size=(N, 3))
    d = np.float32(v / np.linalg.norm(v, axis=-1, keepdims=True))
    op_close(em.eval_env(ts_scene, st.env_kind, *_t(d)),
             ref_em.eval_env(rs_scene, st.env_kind, *_j(d)), "eval_env")
    for n_area in (0, 1):
        op_close(em.pdf_env_direct(ts_scene, n_area, st.env_kind, *_t(d),
                                   n_delta=3),
                 ref_em.pdf_env_direct(rs_scene, n_area, st.env_kind,
                                       *_j(d), n_delta=3), "pdf_env")
    # the emitter-hit MIS density counts the delta lights and the env
    p_ref = np.float32(rs.uniform([20, 5, 20], [530, 500, 540], (N, 3)))
    ref = ref_em.sample_direct(rs_scene, 1, 0, *_j(p_ref, np.float32(
        rs.uniform(size=N)), np.float32(rs.uniform(size=(N, 2)))))
    eid = np.zeros(N, np.int32)
    eid[::4] = -1
    op_close(em.pdf_area_direct(ts_scene, 1, True, *_t(eid, p_ref, ref.p,
                                                       ref.n), n_delta=3),
             ref_em.pdf_area_direct(rs_scene, 1, True, *_j(eid, p_ref,
                                                           ref.p, ref.n),
                                    n_delta=3), "pdf_area_direct")


def test_delta_photon_starts(board):
    """SPPM's photon starts on the board's delta lights: the point
    light's from the uniform sphere, the spot's in its cone (power times
    the falloff), the directional's at zero power."""
    from gradientdomain_mitsuba_tpu_torch.models.sppm import SPPMTracer
    _, _, _, ts_scene, st = board
    st.integrator_props.update({"photonCount": 4096})
    tr = SPPMTracer(ts_scene, st)
    rs = np.random.RandomState(5)
    de = torch.from_numpy(rs.randint(0, 3, 4096))
    u = torch.from_numpy(np.float32(rs.uniform(size=(4096, 2))))
    pos, d, beta = tr._delta_photons(ts_scene.emitters, de, u, 4)
    em_t = ts_scene.emitters
    kind = em_t.delta_kind[de]
    np.testing.assert_allclose(pos.numpy(), em_t.delta_pos[de].numpy())
    cos_axis = (d * em_t.delta_dir[de]).sum(-1)
    spot = kind == 1
    assert (cos_axis[spot] >= em_t.delta_cos_total[de][spot] - 1e-6).all()
    assert (beta[kind == 2] == 0).all()
    point = kind == 0
    np.testing.assert_allclose(
        beta[point].numpy(),
        (em_t.delta_intensity[de][point] * 4 * np.pi * 4).numpy(),
        rtol=1e-6)
    assert (beta[spot] > 0).any()


# ------------------------------------------------------------- sunsky

SUNSKY_XML = """<scene version="0.5.0">
  <sensor type="perspective">
    <float name="fov" value="60"/>
    <transform name="toWorld">
      <lookat origin="0 1 -4" target="0 1 4" up="0 1 0"/>
    </transform>
    <film type="hdrfilm">
      <integer name="width" value="24"/><integer name="height" value="24"/>
    </film>
  </sensor>
  <emitter type="sunsky">
    <vector name="sunDirection" x="0.3" y="0.75" z="0.2"/>
    <integer name="resolution" value="128"/>
  </emitter>
  <shape type="rectangle">
    <transform name="toWorld">
      <rotate x="1" angle="-90"/><scale value="10"/>
    </transform>
    <bsdf type="diffuse"><rgb name="reflectance" value="0.5 0.5 0.5"/></bsdf>
  </shape>
</scene>"""


def test_sunsky_map_matches_reference(tmp_path):
    """The sunsky is baked on the host into an envmap (scene/sunsky.py):
    the port's loader bakes the reference's map, CDFs and pdf on
    tests/test_sunsky.py's scene."""
    path = tmp_path / "sunsky.xml"
    path.write_text(SUNSKY_XML)
    ref, rst = ref_scene.load_scene(str(path))
    got, st = port_scene.load_scene(str(path))
    assert st.env_kind == rst.env_kind == em.ENV_MAP
    for name in ("env_map", "env_cdf_rows", "env_cdf_cols", "env_pdf",
                 "env_radiance", "env_to_world"):
        np.testing.assert_allclose(getattr(got.emitters, name),
                                   getattr(ref.emitters, name), rtol=1e-6,
                                   atol=1e-7, err_msg=name)
    assert got.emitters.env_map.max() > 50 * np.median(
        got.emitters.env_map)


# ----------------------------------------------------- bridge, sensors

SENSOR_FIELDS = ("kind", "kc", "focus_distance", "aperture_radius",
                 "to_world", "sample_to_camera")
EMITTER_FIELDS = ("delta_kind", "delta_pos", "delta_dir", "delta_intensity",
                  "delta_cos_total", "delta_cos_falloff", "env_kind",
                  "env_radiance")


def _sensor_scenes():
    spec = importlib.util.spec_from_file_location(
        "sensor_scenes", os.path.join(ROOT, "tools/sensor_scenes.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.SCENES


@pytest.mark.parametrize("which", ["board", "sunsky_board"] +
                         sorted(_sensor_scenes()))
def test_bridge_carries_emitter_and_sensor_tables(tmp_path, which):
    """scene/bridge.to_torch carries every delta_* field, env_kind,
    env_radiance and the sensor's kind / kc / focus_distance as the
    reference's loader built them (port loader against reference loader,
    then through the bridge)."""
    if which.endswith("board"):
        path = lights_board().write_board(
            str(tmp_path), "sunsky" if which.startswith("sunsky")
            else "constant")
    else:
        path = tmp_path / "s.xml"
        path.write_text(_sensor_scenes()[which])
        path = str(path)
    ref, _ = ref_scene.load_scene(path)
    got, _ = port_scene.load_scene(path)
    ts = bridge.to_torch(got, "cpu")
    for group, names in (("emitters", EMITTER_FIELDS),
                         ("camera", SENSOR_FIELDS)):
        for name in names:
            r = np.asarray(getattr(getattr(ref, group), name))
            t = getattr(getattr(ts, group), name)
            assert isinstance(t, torch.Tensor), name
            assert t.dtype == torch.from_numpy(np.array(r)).dtype, name
            np.testing.assert_allclose(t.numpy(), r, rtol=1e-6, atol=1e-6,
                                       err_msg=name)


def test_sample_ray_makes_no_host_read(monkeypatch, tmp_path):
    """describe() reads the camera once; sample_ray and
    importance_sample_direct then read nothing back on any kind (every
    tensor-to-host conversion raises while they run)."""
    descs = []
    for name, xml in _sensor_scenes().items():
        path = tmp_path / f"{name}.xml"
        path.write_text(xml)
        s, _ = port_scene.load_scene(str(path))
        descs.append(sensor.describe(bridge.to_torch(s, "cpu").camera))
    assert sorted({d.kind for d in descs}) == [0, 1, 2, 3, 4]
    assert any(d.lens for d in descs) and any(d.rdist for d in descs)

    def no_read(*a, **k):
        raise AssertionError("host read")
    for name in ("tolist", "item", "__bool__", "__float__", "__int__",
                 "numpy", "__index__"):
        monkeypatch.setattr(torch.Tensor, name, no_read)
    pos = torch.rand(64, 2) * 8
    u = torch.rand(64, 2)
    for d in descs:
        o, w = sensor.sample_ray(d, 8, 8, pos, u)
        sensor.importance_sample_direct(d, 8, 8, o + 2.0 * w)
