"""The sensor scenes of tests/test_sensors.py as XML strings: one scene
for each sensor kind beyond the perspective camera.

  - spherical: a lat-long camera in a constant environment of radiance
    2 (a tiny sphere far away);
  - orthographic and telecentric (aperture 0.4, focus 1): a grey
    rectangle under a constant environment;
  - radiancemeter: one ray into an area light of radiance (3, 2, 1);
  - fluencemeter: uniform-sphere directions in the constant environment;
  - rdist / rdist0: perspective_rdist with kc (0.05, 0.01) and (0, 0),
    and `perspective`, the same camera as a perspective sensor.

Each keeps the loader's $width / $height / $spp / $maxDepth variables
(defaults: the reference test's film, sample count and depth) and
$integrator, so a caller can render it at another size through any
tracer.  Shared by chip_smoke.py and the port's tests, which load this
file from its path (tools/ is not a package).
"""

HEAD = """<scene version="0.5.0">
  <default name="integrator" value="path"/>
  <default name="width" value="{w}"/>
  <default name="height" value="{h}"/>
  <default name="spp" value="{spp}"/>
  <default name="maxDepth" value="{depth}"/>
  <integrator type="$integrator">
    <integer name="maxDepth" value="$maxDepth"/>
  </integrator>
  <sensor type="{kind}">
    {body}
    <sampler type="independent">
      <integer name="sampleCount" value="$spp"/>
    </sampler>
    <film type="hdrfilm">
      <integer name="width" value="$width"/>
      <integer name="height" value="$height"/>
      <rfilter type="box"/>
    </film>
  </sensor>
"""
SPHERE_ENV = """  <emitter type="constant"><rgb name="radiance" value="2, 2, 2"/></emitter>
  <shape type="sphere">
    <point name="center" x="50" y="0" z="0"/>
    <float name="radius" value="0.1"/>
    <bsdf type="diffuse"/>
  </shape>
</scene>
"""
ORTHO_BODY = """<transform name="toWorld">
      <scale x="3" y="3" z="1"/>
      <lookat origin="0 0 -5" target="0 0 0" up="0 1 0"/>
    </transform>"""
ORTHO_REST = """  <shape type="rectangle">
    <bsdf type="diffuse"><rgb name="reflectance" value="0.5 0.5 0.5"/></bsdf>
  </shape>
  <emitter type="constant"><rgb name="radiance" value="1, 1, 1"/></emitter>
</scene>
"""
RDIST_BODY = """<float name="fov" value="50"/>
    {kc}
    <transform name="toWorld">
      <lookat origin="0 0 4" target="0 0 0" up="0 1 0"/>
    </transform>"""
RDIST_REST = """  <shape type="rectangle">
    <transform name="toWorld"><scale value="3"/></transform>
    <bsdf type="diffuse"/>
  </shape>
  <emitter type="constant"><rgb name="radiance" value="1, 1, 1"/></emitter>
</scene>
"""
RADMETER_REST = """  <shape type="rectangle">
    <emitter type="area"><rgb name="radiance" value="3, 2, 1"/></emitter>
  </shape>
</scene>
"""


def _xml(kind, body, rest, w=16, h=16, spp=4, depth=2):
    return HEAD.format(kind=kind, body=body, w=w, h=h, spp=spp,
                       depth=depth) + rest


def _kc(kc):
    return f'<string name="kc" value="{kc}"/>'


SCENES = {
    "spherical": _xml("spherical", "", SPHERE_ENV, h=8),
    "orthographic": _xml("orthographic", ORTHO_BODY, ORTHO_REST, depth=3),
    "telecentric": _xml(
        "telecentric", ORTHO_BODY +
        '<float name="apertureRadius" value="0.4"/>'
        '<float name="focusDistance" value="1.0"/>', ORTHO_REST, depth=3),
    "radiancemeter": _xml(
        "radiancemeter", '<transform name="toWorld"><lookat origin="0 0 3" '
        'target="0 0 0" up="0 1 0"/></transform>', RADMETER_REST, w=1, h=1),
    "fluencemeter": _xml("fluencemeter", "", SPHERE_ENV, w=1, h=1,
                         spp=256),
    "rdist": _xml("perspective_rdist", RDIST_BODY.format(
        kc=_kc("0.05, 0.01")), RDIST_REST, w=32, h=32),
    "rdist0": _xml("perspective_rdist", RDIST_BODY.format(kc=_kc("0, 0")),
                   RDIST_REST, w=32, h=32),
    "perspective": _xml("perspective", RDIST_BODY.format(kc=""),
                        RDIST_REST, w=32, h=32),
}
# the camera kind each scene's loader builds (scene.Camera.kind)
KIND = {"spherical": 2, "orthographic": 1, "telecentric": 1,
        "radiancemeter": 3, "fluencemeter": 4, "rdist": 0, "rdist0": 0,
        "perspective": 0}
METERS = ("radiancemeter", "fluencemeter")


def write_scene(directory, name):
    """Writes scene `name` into `directory`; returns the XML's path."""
    import os
    path = os.path.join(directory, f"sensor_{name}.xml")
    with open(path, "w") as f:
        f.write(SCENES[name])
    return path
