"""Renders of ROADMAP step G2b's lights in the port against the reference
on the CPU: the lights board (tools/lights_board.py: an area, a point, a
spot and a directional light and a constant environment, a
roughconductor and a dielectric sphere) through path, G-PT (four
buffers and the L1 final), volpath, irrcache, VPL, SPPM (photons from
the point and spot lights; the board keeps its meshes off the hash
grid's cell boundaries) and PSSMLT; its sunsky
variant through path and G-PT; SPPM with spot and collimated photons on
a scene that keeps its surfaces off the hash grid's cell boundaries
(tests/test_torch_sppm.py), and the collimated beam's spot under SPPM.

16^2, 1-2 spp, seed 1, through both factories with the reference's
intersectors pinned to the linear-MT matmul sweeps, torch on one thread
with subnormals flushed (tests/torch_parity.py).  Images at rtol 1e-3 /
atol 1e-4 on >= 99% of pixels with means within 1e-3 relative and equal
rays, L1 finals by objective and mean, PSSMLT's acceptance decisions
agreeing on >= 99% (tests/test_torch_pssmlt.py)."""
import importlib.util
import os

import numpy as np
import pytest

from gradientdomain_mitsuba_tpu.models import poisson as ref_poisson
from gradientdomain_mitsuba_tpu_torch.models import poisson
from gradientdomain_mitsuba_tpu_torch.models.path import PathTracer
from gradientdomain_mitsuba_tpu_torch.models.sppm import SPPMTracer
from torch_parity import flush_subnormals, one_thread  # noqa: F401
from torch_parity import (assert_image_close, assert_l1_final_close,
                          frac_close, load, make_both, rel_mean_diff,
                          render_both, render_chains)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED, SPP = 1, 2
pytestmark = pytest.mark.usefixtures("flush_subnormals", "one_thread")


def lights_board():
    spec = importlib.util.spec_from_file_location(
        "lights_board", os.path.join(ROOT, "tools/lights_board.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def boards(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("lb"))
    mod = lights_board()
    return {env: mod.write_board(d, env) for env in ("constant", "sunsky")}


@pytest.mark.parametrize("integrator,props", [
    ("path", {}), ("volpath", {}), ("irrcache", {}),
    ("vpl", {"vplCount": 64, "vplChunk": 32}),
    ("sppm", {"photonCount": 8192})])
def test_board_matches_reference(boards, integrator, props):
    scene, st = load(boards["constant"], integrator, spp=SPP, depth=5,
                     props=props)
    assert (st.n_delta, st.env_kind) == (3, 1)
    count = integrator in ("path", "volpath")
    (ref,), (got,), rt, pt = render_both(scene, st, [SEED], SPP,
                                         count_rays=count)
    assert pt.n_delta == 3 and pt.env_kind == 1
    assert_image_close(got, ref)
    assert ref.mean() > 0.05
    if count:
        assert int(pt.last_ray_count) == int(rt.last_ray_count) > 0


def _gpt_both(path):
    scene, st = load(path, "gpt", spp=SPP, depth=5)
    rt, rs, pt, ts = make_both(scene, st)
    rt.count_rays = pt.count_rays = True
    rb = {k: np.asarray(v) for k, v in rt.render(rs, seed=SEED,
                                                  spp=SPP).items()}
    pb = pt.render(ts, seed=SEED, spp=SPP)
    rb["L1"] = np.asarray(ref_poisson.reconstruct(rb, mode="L1"))
    port_l1 = poisson.reconstruct(pb, mode="L1").numpy()
    pb = {k: v.numpy() for k, v in pb.items()}
    pb["L1"] = port_l1
    return rb, pb, rt, pt


@pytest.mark.parametrize("env", ["constant", "sunsky"])
def test_gpt_board_matches_reference(boards, env):
    """G-PT's NEE over the delta lights and the environment, its escape
    term and its shifts (the point / spot offset's own 1/d^2, the
    directional's shared direction), with the half-vector shift off the
    roughconductor sphere; the four buffers, rays and the L1 final.
    The sunsky's sun, seen through the spheres, reaches ~7,000 in a pixel
    and agrees there to ~1e-3 relative (float32 rounding over the sun
    disk's steep texels), which the L1 objective weighs by its absolute
    size, so the sunsky L1 final is held by its mean."""
    rb, pb, rt, pt = _gpt_both(boards[env])
    for k in ("primal", "very_direct", "dx", "dy"):
        assert np.isfinite(pb[k]).all(), k
        assert frac_close(pb[k], rb[k]) >= 0.99, k
        assert (rel_mean_diff(pb[k], rb[k]) < 1e-3 or
                abs(pb[k].mean() - rb[k].mean()) < 1e-6), k
    assert pt.last_ray_count == int(rt.last_ray_count) > 0
    if env == "constant":
        assert_l1_final_close(pb["L1"], rb)
    else:
        assert np.isfinite(pb["L1"]).all()
        assert rel_mean_diff(pb["L1"], rb["L1"]) < 5e-3
        assert pb["very_direct"].mean() > 1.0   # the sky, seen directly


def test_sunsky_board_path_matches_reference(boards):
    scene, st = load(boards["sunsky"], "path", spp=SPP, depth=5)
    assert st.env_kind == 2
    (ref,), (got,), rt, pt = render_both(scene, st, [SEED], SPP,
                                         count_rays=True)
    assert_image_close(got, ref)
    assert int(pt.last_ray_count) == int(rt.last_ray_count) > 0


def test_pssmlt_board_matches_reference(boards, record_property):
    """The chains' path tracer sees the delta lights and the
    environment (item 14 before: it raised)."""
    scene, st = load(boards["constant"], "pssmlt", spp=SPP, depth=4,
                     props=dict(chains=64, luminanceSamples=256))
    rt, rs, pt, ts = make_both(scene, st)
    assert pt.inner.n_delta == 3
    ref, got, ref_takes, port_takes = render_chains(rt, rs, pt, ts, SEED,
                                                    SPP)
    assert_image_close(got, ref)
    share = float((ref_takes == port_takes).mean())
    record_property("acceptance_agreement", share)
    assert share >= 0.99, share


SPPM_XML = """<scene version="0.5.0">
  <integrator type="sppm">
    <integer name="maxDepth" value="$maxDepth"/>
    <integer name="photonCount" value="8192"/>
    <float name="initialRadius" value="0.3"/>
  </integrator>
  <sensor type="perspective">
    <float name="fov" value="45"/>
    <transform name="toWorld">
      <lookat origin="0 1.2 4.5" target="0 0.5 0" up="0 1 0"/>
    </transform>
    <sampler type="independent">
      <integer name="sampleCount" value="$spp"/>
    </sampler>
    <film type="hdrfilm">
      <integer name="width" value="$width"/>
      <integer name="height" value="$height"/>
      <rfilter type="box"/>
    </film>
  </sensor>
  <shape type="rectangle">
    <transform name="toWorld">
      <rotate x="1" angle="-90"/><scale value="4"/><translate y="0.0371"/>
    </transform>
    <bsdf type="diffuse"><rgb name="reflectance" value="0.6 0.5 0.4"/></bsdf>
  </shape>
  <shape type="rectangle">
    <transform name="toWorld">
      <scale value="4"/><translate z="-1.9137"/>
    </transform>
    <bsdf type="diffuse"><rgb name="reflectance" value="0.5 0.5 0.5"/></bsdf>
  </shape>
  <emitter type="spot">
    <transform name="toWorld">
      <lookat origin="0.4 2.6 0.2" target="0 0 -0.3" up="0 0 1"/>
    </transform>
    <rgb name="intensity" value="8 7 6"/>
    <float name="cutoffAngle" value="25"/>
    <float name="beamWidth" value="18"/>
  </emitter>
  <emitter type="collimated">
    <transform name="toWorld">
      <lookat origin="-0.6 2.9 0.1" target="-0.6 0 0.1" up="1 0 0"/>
    </transform>
    <rgb name="power" value="3, 3, 3"/>
  </emitter>
</scene>"""


def test_sppm_spot_and_collimated_photons(tmp_path):
    """Spot photons from the uniform cone with the falloff factor and
    collimated photons along the beam's axis, against the reference."""
    path = tmp_path / "sppm.xml"
    path.write_text(SPPM_XML)
    scene, st = load(str(path), "sppm", spp=SPP, depth=4)
    assert st.n_delta == 2
    (ref,), (got,), rt, pt = render_both(scene, st, [SEED], SPP)
    assert type(pt) is SPPMTracer
    assert_image_close(got, ref)
    assert ref.mean() > 1e-3


def test_collimated_beam_via_photons(tmp_path):
    """tests/test_sensors.py's check on the port: the beam is invisible
    to NEE (doubly delta) but its photons light a spot on the floor
    under SPPM (centre > 20x border)."""
    from gradientdomain_mitsuba_tpu_torch.scene import bridge
    from gradientdomain_mitsuba_tpu_torch.scene import scene as port_scene
    board = lights_board()
    s, st = port_scene.load_scene(board.write_collimated(str(tmp_path)))
    ts = bridge.to_torch(s, "cpu")
    assert PathTracer(ts, st).render(ts, seed=0, spp=4).max() < 1e-6
    img = SPPMTracer(ts, st).render(ts, seed=0, spp=4).numpy()
    assert np.isfinite(img).all()
    center, border = board.beam_spot(img)
    assert center > 0.05, center
    assert center > 20 * max(border, 1e-9), (center, border)
