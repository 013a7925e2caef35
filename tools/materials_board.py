"""A materials board: one analytic sphere for each BSDF kind and wrapper of
ROADMAP step G1 (roughdiffuse, difftrans, phong, ward, hk, a mask with a
constant opacity, blendbsdf, coating, roughcoating), in a 3 x 3 grid in
front of Cornell box's back wall, over a diffuse floor and under its
light, after the reference test scene of tests/test_bsdf_wrappers.py
(SCENE_XML).  Written from code (nothing is downloaded); the meshes are
the repo's data/scenes/cbox/meshes.

Shared by chip_smoke.py and tests/test_torch_bsdf_rest.py, which load it
from its path (tools/ is not a package).  The XML keeps the loader's
$width / $height / $spp / $maxDepth variables."""
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH = os.path.join(ROOT, "data/scenes/cbox/meshes")

# (label, bsdf XML), row-major from the top left as the camera sees it
BSDFS = (
    ("roughdiffuse", """<bsdf type="roughdiffuse">
        <rgb name="reflectance" value="0.6 0.4 0.3"/>
        <float name="alpha" value="0.5"/></bsdf>"""),
    ("difftrans", """<bsdf type="difftrans">
        <rgb name="transmittance" value="0.5 0.6 0.7"/></bsdf>"""),
    ("phong", """<bsdf type="phong">
        <float name="exponent" value="40"/>
        <rgb name="diffuseReflectance" value="0.3 0.3 0.5"/>
        <rgb name="specularReflectance" value="0.4 0.4 0.4"/></bsdf>"""),
    ("ward", """<bsdf type="ward">
        <float name="alphaU" value="0.1"/><float name="alphaV" value="0.3"/>
        <rgb name="diffuseReflectance" value="0.4 0.4 0.4"/>
        <rgb name="specularReflectance" value="0.3 0.3 0.3"/></bsdf>"""),
    ("hk", """<bsdf type="hk">
        <rgb name="sigmaS" value="1.0 0.8 0.6"/>
        <rgb name="sigmaA" value="0.05 0.1 0.2"/>
        <float name="thickness" value="1"/>
        <phase type="hg"><float name="g" value="0.6"/></phase></bsdf>"""),
    ("mask", """<bsdf type="mask">
        <rgb name="opacity" value="0.5 0.5 0.5"/>
        <bsdf type="diffuse"><rgb name="reflectance" value="0.7 0.2 0.2"/>
        </bsdf></bsdf>"""),
    ("blend", """<bsdf type="blendbsdf">
        <float name="weight" value="0.3"/>
        <bsdf type="diffuse"><rgb name="reflectance" value="0.2 0.4 0.6"/>
        </bsdf>
        <bsdf type="roughconductor"><string name="material" value="Cu"/>
          <float name="alpha" value="0.2"/></bsdf></bsdf>"""),
    ("coating", """<bsdf type="coating">
        <float name="intIOR" value="1.5"/>
        <rgb name="sigmaA" value="0.2 0.1 0.05"/>
        <bsdf type="diffuse"><rgb name="reflectance" value="0.5 0.3 0.2"/>
        </bsdf></bsdf>"""),
    ("roughcoating", """<bsdf type="roughcoating">
        <float name="intIOR" value="1.5"/><float name="alpha" value="0.15"/>
        <bsdf type="diffuse"><rgb name="reflectance" value="0.2 0.5 0.3"/>
        </bsdf></bsdf>"""),
)

HEADER = """<scene version="0.5.0">
  <integrator type="path">
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
    <bsdf type="diffuse"><rgb name="reflectance" value="0.5 0.5 0.5"/></bsdf>
  </shape>
  <shape type="obj">
    <string name="filename" value="{mesh}/cbox_back.obj"/>
    <bsdf type="diffuse"><rgb name="reflectance" value="0.5 0.5 0.5"/></bsdf>
  </shape>
  <shape type="rectangle">
    <transform name="toWorld">
      <rotate x="1" angle="90"/><scale x="65" y="1" z="52"/>
      <translate x="278" y="548" z="279"/>
    </transform>
    <emitter type="area"><rgb name="radiance" value="18, 15, 8"/></emitter>
  </shape>
"""

SPHERE = """  <shape type="sphere">
    <point name="center" x="{x}" y="{y}" z="330"/>
    <float name="radius" value="62"/>
    {bsdf}
  </shape>
"""


def board_xml():
    """The board's XML: the spheres' centers 140 apart, the top row at
    y 420 (the camera looks down +z; x grows to the left in its image)."""
    body = []
    for i, (_, bsdf) in enumerate(BSDFS):
        row, col = divmod(i, 3)
        body.append(SPHERE.format(x=418 - 140 * col, y=420 - 140 * row,
                                  bsdf=bsdf))
    return HEADER.format(mesh=MESH) + "".join(body) + "</scene>\n"


def write_board(directory):
    """Writes the board into `directory`; returns its path."""
    path = os.path.join(directory, "materials_board.xml")
    with open(path, "w") as f:
        f.write(board_xml())
    return path
