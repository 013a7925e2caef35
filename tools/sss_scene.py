"""The dipole subsurface scenes: tests/test_sss.py's scene (a marble
sphere with a `dipole` attachment on a diffuse floor, lit by a small
spherical area light) with the loader's $width / $height / $spp /
$maxDepth and the cache's $samples / $irrSamples as variables (their
defaults are that test's values), and a variant with a second subsurface
sphere of another preset (skin1), so that the cache's round-robin rows
and eval_mo's same-row mask are exercised.

The subsurface spheres are tessellated by the loader (about 32k
triangles for the one-sphere scene: a large scene, so the clustered
traversal runs; the spherical light is tessellated too).  The "floor"
variant puts the dipole attachment on the floor rectangle instead, with
no sphere and a quad light in the light's place: a four-triangle scene
for tests that need a subsurface row but not the spheres' cost.
Written from code into a caller's directory (nothing is downloaded);
shared by chip_smoke.py and the port's tests, which load it from its
path (tools/ is not a package).
"""
import os

DEFAULTS = {"width": 32, "height": 32, "spp": 4, "maxDepth": 4,
            "samples": 256, "irrSamples": 4}

MARBLE = """ <shape type="sphere">
  <float name="radius" value="0.4"/>
  <point name="center" x="0" y="0.4" z="0"/>
  <subsurface type="dipole">
   <string name="material" value="marble"/>
   <float name="scale" value="10"/>
   <integer name="samples" value="$samples"/>
   <integer name="irrSamples" value="$irrSamples"/>
  </subsurface>
 </shape>
"""

SKIN = """ <shape type="sphere">
  <float name="radius" value="0.25"/>
  <point name="center" x="-0.75" y="0.25" z="0.2"/>
  <subsurface type="dipole">
   <string name="material" value="skin1"/>
   <float name="scale" value="10"/>
   <integer name="samples" value="$samples"/>
   <integer name="irrSamples" value="$irrSamples"/>
  </subsurface>
 </shape>
"""

SCENE = """<scene version="0.5.0">
{defaults} <integrator type="path"><integer name="maxDepth" value="$maxDepth"/></integrator>
 <sensor type="perspective">
  <float name="fov" value="60"/>
  <transform name="toWorld">
   <lookat origin="0, 0.6, 2.6" target="0, 0.4, 0" up="0, 1, 0"/>
  </transform>
  <film type="hdrfilm">
   <integer name="width" value="$width"/><integer name="height" value="$height"/>
  </film>
  <sampler type="independent"><integer name="sampleCount" value="$spp"/></sampler>
 </sensor>
{spheres} <shape type="rectangle">
  <transform name="toWorld">
   <rotate x="1" angle="-90"/><scale value="4"/>
  </transform>
{floor} </shape>
{light}</scene>
"""

SPHERE_LIGHT = """ <shape type="sphere">
  <float name="radius" value="0.15"/>
  <point name="center" x="1.2" y="1.6" z="1.0"/>
  <emitter type="area"><spectrum name="radiance" value="60"/></emitter>
 </shape>
"""

# a quad of the sphere light's cross-section, facing down
QUAD_LIGHT = """ <shape type="rectangle">
  <transform name="toWorld">
   <rotate x="1" angle="90"/><scale value="0.15"/>
   <translate x="1.2" y="1.6" z="1.0"/>
  </transform>
  <emitter type="area"><spectrum name="radiance" value="60"/></emitter>
 </shape>
"""

# the marble sphere as a pure absorber (a black diffuse sphere of the same
# shape): the reference test's oracle compares the dipole render with it
ABSORBER = """ <shape type="sphere">
  <float name="radius" value="0.4"/>
  <point name="center" x="0" y="0.4" z="0"/>
  <bsdf type="diffuse"><spectrum name="reflectance" value="0"/></bsdf>
 </shape>
"""


DIFFUSE_FLOOR = """  <bsdf type="diffuse"><spectrum name="reflectance" value="0.7"/></bsdf>
"""

MARBLE_FLOOR = """  <subsurface type="dipole">
   <string name="material" value="marble"/>
   <float name="scale" value="10"/>
   <integer name="samples" value="$samples"/>
   <integer name="irrSamples" value="$irrSamples"/>
  </subsurface>
"""


def scene_xml(variant="one"):
    """The XML of `variant`: "one" (test_sss.py's scene), "two" (with the
    skin sphere), "absorber" (the marble sphere black, no subsurface) or
    "floor" (no sphere, the floor marble, a quad light)."""
    spheres = {"one": MARBLE, "two": MARBLE + SKIN, "absorber": ABSORBER,
               "floor": ""}[variant]
    floor = MARBLE_FLOOR if variant == "floor" else DIFFUSE_FLOOR
    light = QUAD_LIGHT if variant == "floor" else SPHERE_LIGHT
    defaults = "".join(f' <default name="{k}" value="{v}"/>\n'
                       for k, v in DEFAULTS.items())
    return SCENE.format(defaults=defaults, spheres=spheres, floor=floor,
                        light=light)


def write_scene(directory, variant="one"):
    """Writes `variant` into `directory`; returns the XML's path."""
    path = os.path.join(directory, f"sss_{variant}.xml")
    with open(path, "w") as f:
        f.write(scene_xml(variant))
    return path
