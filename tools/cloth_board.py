"""A cloth-and-texture board: the materials of ROADMAP step G2a on flat
triangle quads in Cornell box's room, under its light.

Ten quads in a 4 x 3 grid in front of the back wall, each tilted 30
degrees up toward the light (row-major from the top left as the camera
sees it):

  - woven cloth (irawan): the denim twill and the charmeuse satin
    presets, each at repeatU / V 8 and 24;
  - a bumpmap over a checkerboard height;
  - a normalmap over a bitmap of a sine-ridge normal field (an EXR
    written here);
  - a mask whose opacity is a checkerboard (has_textures bit 1);
  - a blendbsdf whose weight is a grid texture (bit 3);
  - vertexcolors on a PLY grid written here;
  - wireframe on the same grid;

over a floor bitmap of stripes filtered with filterType "ewa" and seen
at a grazing angle toward the back, so the anisotropic footprint
matters.  Quads, not analytic spheres: a sphere lane gets a neutral
barycentric payload and no tangents, so bump maps and cloth would do
nothing there.

Written from code into a caller's directory (nothing is downloaded and
nothing lands under data/); the walls are the repo's
data/scenes/cbox/meshes.  Shared by chip_smoke.py and the port's tests,
which load it from its path (tools/ is not a package).  The XML keeps the
loader's $width / $height / $spp / $maxDepth variables, and $integrator.

lift=True shifts the whole board (every shape and the camera) by LIFT,
off the axis planes: the floor lies on y = 0 and the green wall on
x = 0, multiples of every SPPM gather radius, where a photon's last bit
picks its hash cell (the photon families' parity scenes and chip phases
use the lifted board; the default layout stays as it was).
"""
import os

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH = os.path.join(ROOT, "data/scenes/cbox/meshes")

# (label, shape XML: "rect" or "ply", material XML)
QUADS = (
    ("denim8", "rect", """<bsdf type="irawan">
        <string name="filename" value="cotton_denim.wif"/>
        <float name="repeatU" value="8"/><float name="repeatV" value="8"/>
      </bsdf>"""),
    ("denim24", "rect", """<bsdf type="irawan">
        <string name="filename" value="cotton_denim.wif"/>
        <float name="repeatU" value="24"/><float name="repeatV" value="24"/>
      </bsdf>"""),
    ("charmeuse8", "rect", """<bsdf type="irawan">
        <string name="filename" value="silk_charmeuse.wif"/>
        <float name="repeatU" value="8"/><float name="repeatV" value="8"/>
      </bsdf>"""),
    ("charmeuse24", "rect", """<bsdf type="irawan">
        <string name="filename" value="silk_charmeuse.wif"/>
        <float name="repeatU" value="24"/><float name="repeatV" value="24"/>
      </bsdf>"""),
    ("bumpmap", "rect", """<bsdf type="bumpmap">
        <texture type="checkerboard">
          <rgb name="color0" value="0.1 0.1 0.1"/>
          <rgb name="color1" value="0.9 0.9 0.9"/>
          <float name="uscale" value="4"/><float name="vscale" value="4"/>
        </texture>
        <bsdf type="diffuse"><rgb name="reflectance" value="0.6 0.55 0.5"/>
        </bsdf>
      </bsdf>"""),
    ("normalmap", "rect", """<bsdf type="normalmap">
        <texture type="bitmap">
          <string name="filename" value="{dir}/ridges.exr"/>
          <string name="filterType" value="trilinear"/>
        </texture>
        <bsdf type="roughplastic"><float name="alpha" value="0.2"/>
          <rgb name="diffuseReflectance" value="0.3 0.5 0.6"/></bsdf>
      </bsdf>"""),
    ("mask", "rect", """<bsdf type="mask">
        <texture name="opacity" type="checkerboard">
          <rgb name="color0" value="1 1 1"/><rgb name="color1" value="0.1 0.1 0.1"/>
          <float name="uscale" value="3"/><float name="vscale" value="3"/>
        </texture>
        <bsdf type="diffuse"><rgb name="reflectance" value="0.7 0.2 0.2"/>
        </bsdf>
      </bsdf>"""),
    ("blend", "rect", """<bsdf type="blendbsdf">
        <texture name="weight" type="gridtexture">
          <rgb name="color0" value="0 0 0"/><rgb name="color1" value="1 1 1"/>
          <float name="lineWidth" value="0.1"/>
          <float name="uscale" value="4"/><float name="vscale" value="4"/>
        </texture>
        <bsdf type="diffuse"><rgb name="reflectance" value="0.2 0.4 0.6"/>
        </bsdf>
        <bsdf type="roughconductor"><string name="material" value="Cu"/>
          <float name="alpha" value="0.2"/></bsdf>
      </bsdf>"""),
    ("vertexcolors", "ply", """<bsdf type="diffuse">
        <texture name="reflectance" type="vertexcolors"/>
      </bsdf>"""),
    ("wireframe", "ply", """<bsdf type="diffuse">
        <texture name="reflectance" type="wireframe">
          <rgb name="interiorColor" value="0.6 0.6 0.6"/>
          <rgb name="edgeColor" value="0.05 0.05 0.3"/>
          <float name="lineWidth" value="2"/>
        </texture>
      </bsdf>"""),
)

HEADER = """<scene version="0.5.0">
  <default name="integrator" value="path"/>
  <integrator type="$integrator">
    <integer name="maxDepth" value="$maxDepth"/>
  </integrator>
  <sensor type="perspective">
    <float name="fov" value="39.3077"/>
    <transform name="toWorld">
      <lookat origin="278, 273, -800" target="278, 273, -799" up="0, 1, 0"/>
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
      <rotate x="1" angle="-90"/><scale x="278" y="1" z="280"/>
      <translate x="278" y="0" z="280"/>
    </transform>
    <bsdf type="diffuse">
      <texture name="reflectance" type="bitmap">
        <string name="filename" value="{dir}/stripes.exr"/>
        <string name="filterType" value="ewa"/>
        <float name="uscale" value="4"/><float name="vscale" value="4"/>
      </texture>
    </bsdf>
  </shape>
  <shape type="obj">
    <string name="filename" value="{mesh}/cbox_back.obj"/>
    <bsdf type="diffuse"><rgb name="reflectance" value="0.5 0.5 0.5"/></bsdf>
  </shape>
  <shape type="obj">
    <string name="filename" value="{mesh}/cbox_redwall.obj"/>
    <bsdf type="diffuse"><rgb name="reflectance" value="0.63 0.065 0.05"/>
    </bsdf>
  </shape>
  <shape type="obj">
    <string name="filename" value="{mesh}/cbox_greenwall.obj"/>
    <bsdf type="diffuse"><rgb name="reflectance" value="0.14 0.45 0.091"/>
    </bsdf>
  </shape>
  <shape type="rectangle">
    <transform name="toWorld">
      <rotate x="1" angle="90"/><scale x="65" y="1" z="52"/>
      <translate x="278" y="548" z="279"/>
    </transform>
    <emitter type="area"><rgb name="radiance" value="18, 15, 8"/></emitter>
  </shape>
"""

# the unit quad [-1,1]^2 (normal +z) turned to face the camera (-z),
# tilted 30 degrees up toward the light, 50 units across its half-width
PLACE = """<transform name="toWorld">
      <scale x="50" y="50" z="1"/><rotate y="1" angle="180"/>
      <rotate x="1" angle="30"/><translate x="{x}" y="{y}" z="380"/>
    </transform>"""

SHAPE = {
    "rect": """  <shape type="rectangle">
    {place}
    {bsdf}
  </shape>
""",
    "ply": """  <shape type="ply">
    <string name="filename" value="{dir}/grid.ply"/>
    {place}
    {bsdf}
  </shape>
""",
}


def grid_ply(n=3):
    """An ASCII PLY of the unit quad [-1,1]^2 at z 0 split into n x n
    cells (2 n^2 triangles, counter-clockwise: normal +z), with uchar
    vertex colors that run red -> green along x and add blue along y."""
    t = np.linspace(-1.0, 1.0, n + 1)
    lines = ["ply", "format ascii 1.0", f"element vertex {(n + 1) ** 2}",
             "property float x", "property float y", "property float z",
             "property uchar red", "property uchar green",
             "property uchar blue", f"element face {2 * n * n}",
             "property list uchar int vertex_indices", "end_header"]
    for j, y in enumerate(t):
        for i, x in enumerate(t):
            a, b = i / n, j / n
            lines.append(f"{x:.6f} {y:.6f} 0 {int(255 * (1 - a))} "
                         f"{int(255 * a)} {int(255 * b)}")
    for j in range(n):
        for i in range(n):
            v0 = j * (n + 1) + i
            v1, v2, v3 = v0 + 1, v0 + n + 2, v0 + n + 1
            lines += [f"3 {v0} {v1} {v2}", f"3 {v0} {v2} {v3}"]
    return "\n".join(lines) + "\n"


def stripes(size=64, period=8):
    """Vertical stripes (constant along v), 0.2 / 0.8 grey, `period`
    texels per light-dark pair."""
    x = np.arange(size)
    row = np.where((x // (period // 2)) % 2 == 0, 0.2, 0.8)
    return np.broadcast_to(row[None, :, None],
                           (size, size, 3)).astype(np.float32)


def ridges(size=32, waves=2):
    """A tangent-space normal map (rgb = (n + 1) / 2) of the height
    0.15 sin(2 pi waves u): ridges that run along v."""
    u = (np.arange(size) + 0.5) / size
    dh = 0.15 * 2 * np.pi * waves * np.cos(2 * np.pi * waves * u)
    n = np.stack([-dh, np.zeros_like(dh), np.ones_like(dh)], -1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return np.broadcast_to(((n + 1) / 2)[None], (size, size, 3)).astype(
        np.float32)


CLOTH = ("denim8", "denim24", "charmeuse8", "charmeuse24")

# the shift of lift=True (tools/lights_board.py's)
LIFT = '<translate x="0.37" y="0.0371" z="0.29"/>'


def _lifted(xml):
    """`xml` shifted by LIFT: appended to every toWorld transform (the
    shapes' and the camera's), and given to the obj shapes, which have
    none."""
    xml = xml.replace("</transform>", LIFT + "</transform>")
    return xml.replace(
        '<shape type="obj">\n',
        '<shape type="obj">\n    <transform name="toWorld">' + LIFT +
        "</transform>\n")


def board_xml(directory, labels=None, lift=False):
    """The board's XML, reading its generated files from `directory`:
    the quads' centers 120 apart, the top row at y 440 (the camera looks
    down +z; x grows to the left in its image).  labels: the quads to
    keep (all by default; CLOTH keeps the woven cloth), in their
    places; lift: the whole board shifted by LIFT."""
    body = []
    for i, (label, shape, bsdf) in enumerate(QUADS):
        if labels is not None and label not in labels:
            continue
        row, col = divmod(i, 4)
        place = PLACE.format(x=458 - 120 * col, y=440 - 120 * row)
        body.append(SHAPE[shape].format(place=place, dir=directory,
                                        bsdf=bsdf.format(dir=directory)))
    xml = (HEADER.format(mesh=MESH, dir=directory) + "".join(body) +
           "</scene>\n")
    return _lifted(xml) if lift else xml


def write_board(directory, labels=None, lift=False):
    """Writes the board (the quads of `labels`, all by default; lift:
    shifted off the axis planes), its EXRs (with the port's
    utils/exr.write) and its PLY into `directory`; returns the XML's
    path."""
    from gradientdomain_mitsuba_tpu_torch.utils import exr
    exr.write(os.path.join(directory, "stripes.exr"), stripes(), half=False)
    exr.write(os.path.join(directory, "ridges.exr"), ridges(), half=False)
    with open(os.path.join(directory, "grid.ply"), "w") as f:
        f.write(grid_ply())
    path = os.path.join(directory, "cloth_board.xml")
    with open(path, "w") as f:
        f.write(board_xml(directory, labels, lift))
    return path
