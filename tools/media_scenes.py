"""Two participating-media scenes for the volumetric path tracer, written
from code (nothing is downloaded): the Henyey-Greenstein slab of
tests/test_volpath.py::_slab_xml (a 4 x 4 x 0.5 null-bounded homogeneous
slab, sigmaS 1.2, g 0.6, between the camera and an area light) and the
same slab as a heterogeneous medium over a density-ramp .vol grid that
spans it.
Shared by chip_smoke.py and tests/test_torch_volpath.py, which load it
from its path (tools/ is not a package).  The XML keeps the loader's
$width / $height / $spp / $maxDepth variables."""
import os
import struct

import numpy as np

HEADER = """<scene version="0.5.0">
  <integrator type="volpath">
    <integer name="maxDepth" value="$maxDepth"/>
  </integrator>
  <sensor type="perspective">
    <float name="fov" value="45"/>
    <transform name="toWorld">
      <lookat origin="0 0 5" target="0 0 0" up="0 1 0"/>
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
    <transform name="toWorld"><scale value="4"/></transform>
    <emitter type="area"><rgb name="radiance" value="3 3 3"/></emitter>
  </shape>
"""

HG_MEDIUM = """<medium name="interior" type="homogeneous">
      <rgb name="sigmaA" value="0 0 0"/>
      <rgb name="sigmaS" value="1.2 1.2 1.2"/>
      <phase type="hg"><float name="g" value="0.6"/></phase>
    </medium>"""


def slab_xml(medium):
    """The slab scene with `medium` inside the null-bounded cube."""
    return HEADER + f"""  <shape type="cube">
    <transform name="toWorld">
      <scale x="4" y="4" z="0.5"/><translate z="1.5"/>
    </transform>
    <bsdf type="null"/>
    {medium}
  </shape>
</scene>"""


def het_medium(vol):
    """A heterogeneous HG medium (sigmaT 1.2 per unit density, albedo
    0.9 / 0.8 / 0.7) over the density grid in the .vol file `vol`."""
    return f"""<medium name="interior" type="heterogeneous">
      <float name="scale" value="1.2"/>
      <rgb name="albedo" value="0.9 0.8 0.7"/>
      <volume name="density" type="gridvolume">
        <string name="filename" value="{vol}"/>
      </volume>
      <phase type="hg"><float name="g" value="0.6"/></phase>
    </medium>"""


# the slab's world box: the cube [-1,1]^3 scaled by (4, 4, 0.5), moved to
# z = 1.5
SLAB_BOX = ((-4.0, -4.0, 1.0), (4.0, 4.0, 2.0))


def write_vol(path, data, bbox=SLAB_BOX):
    """data [nz, ny, nx] -> a Mitsuba .vol grid (version 3, float32, one
    channel) over the world box bbox, the layout scene/media.load_vol
    reads."""
    nz, ny, nx = data.shape
    with open(path, "wb") as f:
        f.write(b"VOL" + bytes([3]))
        f.write(struct.pack("<5i", 1, nx, ny, nz, 1))
        f.write(struct.pack("<6f", *bbox[0], *bbox[1]))
        data.astype("<f4").tofile(f)


def density_ramp(n=8):
    """Density rising linearly along x from 0.1 to 2 (a [n, n, n] grid)."""
    ramp = np.linspace(0.1, 2.0, n, dtype=np.float32)
    return np.broadcast_to(ramp, (n, n, n)).copy()


def write_slab_scenes(directory):
    """Writes both scenes (and the grid) into `directory`; returns
    {"hg_slab": xml path, "het_slab": xml path}."""
    vol = os.path.join(directory, "ramp.vol")
    write_vol(vol, density_ramp())
    out = {}
    for name, medium in (("hg_slab", HG_MEDIUM),
                         ("het_slab", het_medium(vol))):
        out[name] = os.path.join(directory, name + ".xml")
        with open(out[name], "w") as f:
            f.write(slab_xml(medium))
    return out
