"""A lights board: every emitter kind of ROADMAP step G2b in one open
box, for the tracers' delta-light, environment and aux-family paths.

The box is Cornell box's floor, red wall and green wall (no ceiling, no
back wall: the environment is seen above and behind; shifted by LIFT
off the axis planes), lit by

  - cbox_luminaire.obj as an area light of radiance (17, 12, 4);
  - a point light at (278, 400, 250) of intensity 3e5;
  - a spot light aimed at the floor, cutoff 20 degrees, beamWidth 15;
  - a directional light;
  - a constant environment of radiance (0.3, 0.35, 0.45), or, in the
    `sunsky` variant, a Preetham sunsky (baked to an envmap by the
    loader);

with a roughconductor sphere (alpha 0.1) and a smooth dielectric
sphere, so that G-PT's half-vector shift and BDPT's delta vertices meet
the delta lights and the environment.

COLLIMATED is tests/test_sensors.py's collimated beam over a floor
under SPPM: the beam is doubly delta (NEE never reaches it), so only
its photons light the spot where it lands.  open_box_xml is
tests/test_bdpt_env.py's open box (floor and two walls, all white, 24^2,
maxDepth 4) with one of OPEN_BOX_LIGHTS, for its E[BDPT] = E[path] and
G-BDPT gradient checks.

Written from code into a caller's directory (nothing is downloaded and
nothing lands under data/); the meshes are the repo's
data/scenes/cbox/meshes.  Shared by chip_smoke.py and the port's tests,
which load it from its path (tools/ is not a package).  The XML keeps
the loader's $width / $height / $spp / $maxDepth variables, and
$integrator.
"""
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH = os.path.join(ROOT, "data/scenes/cbox/meshes")

ENVS = {
    "constant": """  <emitter type="constant">
    <rgb name="radiance" value="0.3, 0.35, 0.45"/>
  </emitter>
""",
    "sunsky": """  <emitter type="sunsky">
    <vector name="sunDirection" x="0.3" y="0.75" z="0.2"/>
    <integer name="resolution" value="128"/>
  </emitter>
""",
}

BOARD = """<scene version="0.5.0">
  <default name="integrator" value="path"/>
  <default name="width" value="128"/>
  <default name="height" value="128"/>
  <default name="spp" value="16"/>
  <default name="maxDepth" value="5"/>
  <integrator type="$integrator">
    <integer name="maxDepth" value="$maxDepth"/>
  </integrator>
  <sensor type="{sensor}">
    {sensor_body}
    <sampler type="independent">
      <integer name="sampleCount" value="$spp"/>
    </sampler>
    <film type="hdrfilm">
      <integer name="width" value="$width"/>
      <integer name="height" value="$height"/>
      <rfilter type="box"/>
    </film>
  </sensor>
  <shape type="obj">
    <string name="filename" value="{mesh}/cbox_floor.obj"/>
    {lift}
    <bsdf type="diffuse"><rgb name="reflectance" value="0.725 0.71 0.68"/>
    </bsdf>
  </shape>
  <shape type="obj">
    <string name="filename" value="{mesh}/cbox_redwall.obj"/>
    {lift}
    <bsdf type="diffuse"><rgb name="reflectance" value="0.63 0.065 0.05"/>
    </bsdf>
  </shape>
  <shape type="obj">
    <string name="filename" value="{mesh}/cbox_greenwall.obj"/>
    {lift}
    <bsdf type="diffuse"><rgb name="reflectance" value="0.14 0.45 0.091"/>
    </bsdf>
  </shape>
  <shape type="obj">
    <string name="filename" value="{mesh}/cbox_luminaire.obj"/>
    {lift}
    <bsdf type="diffuse"><rgb name="reflectance" value="0.725 0.71 0.68"/>
    </bsdf>
    <emitter type="area"><rgb name="radiance" value="17, 12, 4"/></emitter>
  </shape>
  <emitter type="point">
    <point name="position" x="278" y="400" z="250"/>
    <rgb name="intensity" value="3e5, 3e5, 3e5"/>
  </emitter>
  <emitter type="spot">
    <transform name="toWorld">
      <lookat origin="420, 420, 120" target="330, 0, 260" up="0, 0, 1"/>
    </transform>
    <rgb name="intensity" value="2e5, 1.8e5, 1.5e5"/>
    <float name="cutoffAngle" value="20"/>
    <float name="beamWidth" value="15"/>
  </emitter>
  <emitter type="directional">
    <vector name="direction" x="-0.3" y="-1" z="0.4"/>
    <rgb name="irradiance" value="0.8, 0.8, 0.75"/>
  </emitter>
{env}  <shape type="sphere">
    <point name="center" x="170" y="90" z="330"/>
    <float name="radius" value="90"/>
    <bsdf type="roughconductor">
      <string name="material" value="au"/>
      <float name="alpha" value="0.1"/>
    </bsdf>
  </shape>
  <shape type="sphere">
    <point name="center" x="390" y="80" z="200"/>
    <float name="radius" value="80"/>
    <bsdf type="dielectric">
      <float name="intIOR" value="1.5"/>
    </bsdf>
  </shape>
</scene>
"""


# the board's camera (perspective), and the other sensors that see the
# board's rays: parallel ones (orthographic, 600 units across) and ones
# that start inside the box (spherical, fluencemeter)
SENSORS = {
    "perspective": """<float name="fov" value="39.3077"/>
    <transform name="toWorld">
      <lookat origin="278, 273, -800" target="278, 273, -799" up="0, 1, 0"/>
    </transform>""",
    "orthographic": """<transform name="toWorld">
      <scale x="300" y="300" z="1"/>
      <lookat origin="278, 273, -800" target="278, 273, -799" up="0, 1, 0"/>
    </transform>""",
    "spherical": """<transform name="toWorld">
      <lookat origin="278, 200, 280" target="278, 200, 281" up="0, 1, 0"/>
    </transform>""",
    "fluencemeter": """<transform name="toWorld">
      <lookat origin="278, 200, 280" target="278, 200, 281" up="0, 1, 0"/>
    </transform>""",
}


# the meshes' small shift off the world's axis planes: cbox's floor and
# green wall lie on y = 0 and x = 0, multiples of every SPPM gather
# radius, where a photon's last bit picks its hash cell (the kernel and
# plain sweeps round a hit differently)
LIFT = ('<transform name="toWorld">'
        '<translate x="0.37" y="0.0371" z="0.29"/></transform>')


def board_xml(env="constant", sensor="perspective"):
    """The board's XML with the environment `env` ("constant" or
    "sunsky") seen by `sensor` (a key of SENSORS)."""
    return BOARD.format(mesh=MESH, env=ENVS[env], sensor=sensor,
                        sensor_body=SENSORS[sensor], lift=LIFT)


def write_board(directory, env="constant", sensor="perspective"):
    """Writes the board into `directory`; returns the XML's path."""
    suffix = "" if sensor == "perspective" else f"_{sensor}"
    path = os.path.join(directory, f"lights_board_{env}{suffix}.xml")
    with open(path, "w") as f:
        f.write(board_xml(env, sensor))
    return path


COLLIMATED = """<scene version="0.5.0">
  <integrator type="sppm">
    <integer name="maxDepth" value="3"/>
    <integer name="photonCount" value="512"/>
    <integer name="gatherCap" value="600"/>
    <float name="initialRadius" value="0.25"/>
  </integrator>
  <sensor type="perspective">
    <float name="fov" value="45"/>
    <transform name="toWorld">
      <lookat origin="0 2.5 -4" target="0 0 0" up="0 1 0"/>
    </transform>
    <sampler type="independent"><integer name="sampleCount" value="4"/></sampler>
    <film type="hdrfilm">
      <integer name="width" value="16"/><integer name="height" value="16"/>
      <rfilter type="box"/>
    </film>
  </sensor>
  <shape type="rectangle">
    <transform name="toWorld">
      <rotate x="1" angle="-90"/><scale value="4"/>
    </transform>
    <bsdf type="diffuse"><rgb name="reflectance" value="0.7 0.7 0.7"/></bsdf>
  </shape>
  <emitter type="collimated">
    <transform name="toWorld">
      <lookat origin="0 3 0" target="0 0 0" up="1 0 0"/>
    </transform>
    <rgb name="power" value="4, 4, 4"/>
  </emitter>
</scene>
"""


def write_collimated(directory):
    """Writes COLLIMATED into `directory`; returns the XML's path."""
    path = os.path.join(directory, "collimated.xml")
    with open(path, "w") as f:
        f.write(COLLIMATED)
    return path


def beam_spot(img):
    """(centre, border) of a COLLIMATED render [16, 16, 3]: the largest
    pixel of the middle 6 x 6 and the mean of the top and bottom two
    rows (tests/test_sensors.py's check: centre > 20 x border)."""
    return (float(img[5:11, 5:11].max()),
            float(img[:2].mean() + img[-2:].mean()))


OPEN_BOX = """<scene version="0.5.0">
  <integrator type="bdpt"><integer name="maxDepth" value="4"/></integrator>
  <sensor type="perspective">
    <float name="fov" value="39.3077"/>
    <transform name="toWorld">
      <lookat origin="278, 273, -800" target="278, 273, -799" up="0, 1, 0"/>
    </transform>
    <sampler type="independent"><integer name="sampleCount" value="8"/></sampler>
    <film type="hdrfilm">
      <integer name="width" value="24"/><integer name="height" value="24"/>
      <rfilter type="box"/>
    </film>
  </sensor>
  <bsdf type="diffuse" id="white"><rgb name="reflectance" value="0.725, 0.71, 0.68"/></bsdf>
  <shape type="obj"><string name="filename" value="{mesh}/cbox_floor.obj"/><ref id="white"/></shape>
  <shape type="obj"><string name="filename" value="{mesh}/cbox_greenwall.obj"/><ref id="white"/></shape>
  <shape type="obj"><string name="filename" value="{mesh}/cbox_redwall.obj"/><ref id="white"/></shape>
  {extra}
</scene>
"""
OPEN_BOX_LIGHTS = {
    "env_area": (
        '<emitter type="constant">'
        '<rgb name="radiance" value="0.3, 0.35, 0.45"/></emitter>'
        '<shape type="obj">'
        '<string name="filename" value="{mesh}/cbox_luminaire.obj"/>'
        '<ref id="white"/>'
        '<emitter type="area">'
        '<rgb name="radiance" value="17, 12, 4"/></emitter></shape>'),
    "point": (
        '<emitter type="point">'
        '<point name="position" x="278" y="400" z="250"/>'
        '<rgb name="intensity" value="3e5, 3e5, 3e5"/></emitter>'),
    "env_smallbox": (
        '<emitter type="constant">'
        '<rgb name="radiance" value="0.8, 0.8, 0.8"/></emitter>'
        '<shape type="obj"><string name="filename" '
        'value="{mesh}/cbox_smallbox.obj"/><ref id="white"/></shape>'),
}


def open_box_xml(lights):
    """tests/test_bdpt_env.py's open box lit by OPEN_BOX_LIGHTS[lights]."""
    return OPEN_BOX.format(mesh=MESH, extra=OPEN_BOX_LIGHTS[lights].format(
        mesh=MESH))


def write_open_box(directory, lights):
    """Writes open_box_xml(lights) into `directory`; returns its path."""
    path = os.path.join(directory, f"open_box_{lights}.xml")
    with open(path, "w") as f:
        f.write(open_box_xml(lights))
    return path
