"""The port's photon-mapping family against the reference on the CPU,
through both factories at 16^2: SPPM (models/sppm.py: visible points,
area-light photon walks, the sorted hash-grid gather with its per-cell
cap) and VPL (models/vpl.py: the VPL walk and the [pixels x vplChunk]
shading with its N*K shadow batch).  Images at rtol 1e-3 / atol 1e-4 on
>= 99% of pixels.

The SPPM scene keeps every surface off the hash grid's cell boundaries
(multiples of the gather radius, 0 among them): a deposit within a few
ulps of a boundary falls into either cell depending on the last bit of
its hit point, and the two packages' transcendentals differ in the last
bit, so the cell, the order of its photons and which gatherCap of them
a scan reaches would differ too.  The photon count makes some cell hold
more than gatherCap photons, where that order decides the image."""
import math
import os

import numpy as np
import pytest
import torch

from gradientdomain_mitsuba_tpu.models import sppm as ref_sppm
from gradientdomain_mitsuba_tpu_torch.models.sppm import SPPMTracer
from gradientdomain_mitsuba_tpu_torch.models.vpl import VPLTracer
from gradientdomain_mitsuba_tpu_torch.scene import bridge
from torch_parity import (assert_image_close, load, make_both,
                          render_both)
from torch_parity import one_thread  # noqa: F401

# torch on one thread: the suite runs six workers, and a multi-threaded
# CPU torch among them spends the renders' time contending for cores
pytestmark = pytest.mark.usefixtures("one_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CBOX = os.path.join(ROOT, "data/scenes/cbox/cbox.xml")
SEED, SPP = 3, 2

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
  <shape type="rectangle">
    <transform name="toWorld">
      <rotate x="1" angle="90"/><scale value="0.8"/><translate y="2.9713"/>
    </transform>
    <emitter type="area"><rgb name="radiance" value="12 12 12"/></emitter>
  </shape>
  $light
</scene>"""

POINT_LIGHT = """<emitter type="point">
    <point name="position" x="0" y="2.5" z="0"/>
    <rgb name="intensity" value="6 6 6"/>
  </emitter>"""


@pytest.fixture
def sppm_scene(tmp_path):
    path = tmp_path / "sppm.xml"
    path.write_text(SPPM_XML.replace("$light", ""))
    return load(str(path), "sppm", spp=SPP, depth=4)


def test_sppm_matches_reference(sppm_scene):
    scene, st = sppm_scene
    (ref,), (got,), rt, pt = render_both(scene, st, [SEED], SPP)
    assert type(pt) is SPPMTracer
    assert_image_close(got, ref)
    assert np.abs(ref).mean() > 1e-3
    assert pt.last_radius == pytest.approx(rt.last_radius, rel=1e-12)

    # some hash key of the first pass (radius r0) holds more than
    # gatherCap photons
    ts = bridge.to_torch(scene, "cpu")
    pos, _, _, ok = pt._emit_photons(ts, SEED, 0)
    r = torch.tensor(math.sqrt(pt.r0 * pt.r0), dtype=torch.float32)
    key = pt._cell_hash(torch.floor(pos * (1.0 / r)).to(torch.int32))
    _, counts = torch.unique(key[ok], return_counts=True)
    assert int(counts.max()) > pt.gather_cap


def test_sppm_rerender_is_bit_identical(sppm_scene):
    scene, st = sppm_scene
    _, _, pt, ts = make_both(scene, st)
    a = pt.render(ts, seed=5, spp=1)
    b = pt.render(ts, seed=5, spp=1)
    assert torch.equal(a, b)


def test_cell_hash_bit_exact():
    """The uint32 multiply-xor hash on int32 cell coordinates, negative
    ones and the int32 extremes included."""
    rs = np.random.RandomState(0)
    q = rs.randint(-2 ** 31, 2 ** 31, size=(4096, 3), dtype=np.int64)
    q[:64] = rs.randint(-3, 3, size=(64, 3))
    q[64:70] = [[-2 ** 31, -1, 0], [2 ** 31 - 1, -2 ** 31, 1],
                [-1, -1, -1], [0, 0, 0], [1, 2, 3], [-7, 5, -9]]
    q = q.astype(np.int32)
    ref = np.asarray(ref_sppm.SPPMTracer._cell_hash(q)).astype(np.int64)
    got = SPPMTracer._cell_hash(torch.from_numpy(q)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert got.min() >= 0 and got.max() < 2 ** 32


def test_vpl_matches_reference():
    scene, st = load(CBOX, "vpl", spp=SPP,
                     props={"vplCount": 64, "vplChunk": 32})
    (ref,), (got,), rt, pt = render_both(scene, st, [SEED], SPP)
    assert type(pt) is VPLTracer
    assert (pt.n_photons, pt.vpl_chunk, pt.photon_depth) == (64, 32, 3)
    assert_image_close(got, ref)
    assert np.abs(ref).mean() > 1e-3


@pytest.mark.parametrize("integrator", ["sppm", "vpl"])
def test_point_light_raises_item_14(tmp_path, integrator):
    """Photons leave the point light too (item 14 before: it raised),
    from the uniform sphere; VPL's NEE samples it.  Against the
    reference (spot and collimated photons: tests/test_torch_lights_
    render.py)."""
    path = tmp_path / "point.xml"
    path.write_text(SPPM_XML.replace("$light", POINT_LIGHT))
    props = ({"photonCount": 64, "vplChunk": 32} if integrator == "vpl"
             else {})
    scene, st = load(str(path), integrator, spp=SPP, depth=4, props=props)
    assert st.n_delta == 1
    (ref,), (got,), rt, pt = render_both(scene, st, [SEED], SPP)
    assert pt.n_delta == 1
    assert_image_close(got, ref)
    assert np.abs(ref).mean() > 1e-3
