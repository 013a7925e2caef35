"""The port's loader on every shape branch and scene table the reference
loads, held bit for bit against the reference's (the port keeps its own
numpy copy of the front end): PLY (ASCII with vertex colors, binary with
normals and uvs), serialized with shapeIndex 1, the cube / disk /
cylinder / rectangle / sphere primitives, hair (text and binary),
heightfields (from an EXR and flat), the media tables of
tools/media_scenes.py, the subsurface tables of tools/sss_scene.py, and
the scenes the reference's own tests build (test_instances.py,
test_vertexattr.py, test_scene_io.py, test_scenes.py, test_hair.py).
Every input file is written into the test's tmp_path."""
import dataclasses
import os
import struct
import textwrap

import numpy as np
import pytest

from gradientdomain_mitsuba_tpu.scene import meshes as ref_meshes
from gradientdomain_mitsuba_tpu.scene import scene as ref_scene
from gradientdomain_mitsuba_tpu.scene import xml_loader as ref_xml
from gradientdomain_mitsuba_tpu_torch.scene import meshes
from gradientdomain_mitsuba_tpu_torch.scene import scene as port_scene
from gradientdomain_mitsuba_tpu_torch.scene import xml_loader
from gradientdomain_mitsuba_tpu_torch.utils import exr

import torch_parity
from test_torch_scene import _assert_same_tree

SENSOR = """
  <sensor type="perspective">
    <float name="fov" value="45"/>
    <transform name="toWorld">
      <lookat origin="0, 0.5, 4" target="0, 0, 0" up="0, 1, 0"/>
    </transform>
    <sampler type="independent">
      <integer name="sampleCount" value="2"/>
    </sampler>
    <film type="hdrfilm">
      <integer name="width" value="8"/><integer name="height" value="8"/>
      <rfilter type="box"/>
    </film>
  </sensor>
  <emitter type="constant"><spectrum name="radiance" value="1"/></emitter>
"""


def _write(directory, name, body, integrator="path"):
    xml = (f'<scene version="0.5.0">\n  <integrator type="{integrator}">'
           '<integer name="maxDepth" value="3"/></integrator>' + SENSOR +
           body + "\n</scene>\n")
    path = os.path.join(directory, name + ".xml")
    with open(path, "w") as f:
        f.write(xml)
    return path


def _assert_same_scene(path, variables=None):
    """Both loaders on `path`: every SceneData array and every
    RenderSettings field but the wall-clock prep_times identical."""
    rs, rst = ref_scene.load_scene(path, dict(variables or {}))
    ps, pst = port_scene.load_scene(path, dict(variables or {}))
    _assert_same_tree(rs, ps)
    for f in dataclasses.fields(rst):
        if f.name != "prep_times":
            assert getattr(rst, f.name) == getattr(pst, f.name), f.name
    return ps, pst


def _quad_ply(path, colors):
    """tests/test_vertexattr.py's quad: ASCII, uchar vertex colors."""
    verts = [(-1, -1, 0), (1, -1, 0), (1, 1, 0), (-1, 1, 0)]
    lines = ["ply", "format ascii 1.0", "element vertex 4",
             "property float x", "property float y", "property float z",
             "property uchar red", "property uchar green",
             "property uchar blue", "element face 2",
             "property list uchar int vertex_indices", "end_header"]
    for (x, y, z), (r, g, b) in zip(verts, colors):
        lines.append(f"{x} {y} {z} {r} {g} {b}")
    lines += ["3 0 1 2", "3 0 2 3"]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def _binary_ply(path):
    """A binary little-endian PLY: a seeded 12-vertex soup with normals
    and uvs, triangles and one quad (split by the loader)."""
    rs = np.random.RandomState(5)
    n = 12
    pos = rs.normal(size=(n, 3)).astype(np.float32)
    nrm = rs.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    uv = rs.uniform(size=(n, 2)).astype(np.float32)
    faces = [(0, 1, 2), (3, 4, 5), (6, 7, 8, 9), (9, 10, 11)]
    head = "\n".join([
        "ply", "format binary_little_endian 1.0", f"element vertex {n}",
        "property float x", "property float y", "property float z",
        "property float nx", "property float ny", "property float nz",
        "property float u", "property float v", f"element face {len(faces)}",
        "property list uchar int vertex_indices", "end_header"]) + "\n"
    body = b"".join(struct.pack("<8f", *pos[i], *nrm[i], *uv[i])
                    for i in range(n))
    for f in faces:
        body += struct.pack("<B", len(f)) + struct.pack(f"<{len(f)}i", *f)
    with open(path, "wb") as fh:
        fh.write(head.encode("ascii") + body)


def _serialized(path):
    """Two meshes in Mitsuba's serialized format (the reference's
    writer, as tests/test_scene_io.py uses it)."""
    rs = np.random.RandomState(1)
    mk = [ref_meshes.Mesh(
        positions=rs.normal(size=(10, 3)).astype(np.float32),
        indices=np.array([[0, 1, 2], [3, 4, 5], [6, 7, 8]], np.int32),
        normals=rs.normal(size=(10, 3)).astype(np.float32),
        uvs=rs.uniform(size=(10, 2)).astype(np.float32)) for _ in range(2)]
    ref_meshes.save_serialized(path, mk)


def _hair_text(path):
    lines = []
    for y in np.linspace(-0.3, 0.3, 7):
        lines += [f"-0.5 {y:.3f} 0", f"0 {y + 0.05:.3f} 0.1",
                  f"0.5 {y:.3f} 0", ""]
    with open(path, "w") as f:
        f.write("\n".join(lines))


def _hair_binary(path):
    verts = [(0, 0, 0), (1, 0, 0), None, (0, 1, 0), (1, 1.2, 0), (2, 1, 0.3)]
    buf = b"BINARY_HAIR" + struct.pack("<I", 5)
    for v in verts:
        buf += struct.pack("<f", np.inf) if v is None else \
            struct.pack("<3f", *v)
    with open(path, "wb") as f:
        f.write(buf)


DIFFUSE = ('<bsdf type="diffuse"><rgb name="reflectance" '
           'value="0.6, 0.4, 0.2"/></bsdf>')


def _shape_scene(d, kind):
    """One scene a shape branch: its input files and XML."""
    if kind == "ply_ascii":
        _quad_ply(os.path.join(d, "quad.ply"),
                  [(255, 0, 0), (0, 255, 0), (0, 0, 255), (255, 255, 255)])
        body = ('<shape type="ply"><string name="filename" value="quad.ply"/>'
                '<bsdf type="diffuse"><texture name="reflectance" '
                'type="vertexcolors"/></bsdf></shape>')
    elif kind == "ply_binary":
        _binary_ply(os.path.join(d, "soup.ply"))
        body = ('<shape type="ply"><string name="filename" value="soup.ply"/>'
                f'{DIFFUSE}</shape>')
    elif kind == "serialized":
        _serialized(os.path.join(d, "m.serialized"))
        body = ('<shape type="serialized"><string name="filename" '
                'value="m.serialized"/><integer name="shapeIndex" value="1"/>'
                '<transform name="toWorld"><scale value="0.5"/></transform>'
                f'{DIFFUSE}</shape>')
    elif kind == "primitives":
        body = "".join(
            f'<shape type="{t}"><transform name="toWorld"><scale value="0.3"/>'
            f'<translate x="{x}" y="0" z="0"/></transform>{DIFFUSE}</shape>'
            for t, x in (("cube", -1.2), ("disk", -0.4), ("rectangle", 0.4)))
        body += ('<shape type="cylinder"><point name="p0" x="1" y="-0.5" '
                 'z="0"/><point name="p1" x="1.2" y="0.5" z="0.1"/>'
                 f'<float name="radius" value="0.2"/>{DIFFUSE}</shape>'
                 '<shape type="sphere"><point name="center" x="0" y="1" '
                 'z="0"/><float name="radius" value="0.3"/><integer '
                 'name="nTheta" value="8"/><integer name="nPhi" value="12"/>'
                 f'{DIFFUSE}</shape>')
    elif kind in ("hair_text", "hair_binary"):
        (_hair_text if kind == "hair_text" else _hair_binary)(
            os.path.join(d, "h.hair"))
        body = ('<shape type="hair"><string name="filename" value="h.hair"/>'
                '<float name="radius" value="0.04"/><integer name="nSeg" '
                f'value="5"/>{DIFFUSE}</shape>')
    elif kind == "heightfield_exr":
        yy, xx = np.mgrid[0:9, 0:7].astype(np.float32)
        img = np.stack([np.sin(xx) * 0.5 + 0.5, yy / 8, xx * yy / 56], -1)
        exr.write(os.path.join(d, "h.exr"), img.astype(np.float32),
                  half=False)
        body = ('<shape type="heightfield"><string name="filename" '
                'value="h.exr"/><float name="scale" value="0.4"/>'
                f'{DIFFUSE}</shape>')
    elif kind == "heightfield_flat":
        body = ('<shape type="heightfield"><integer name="resolution" '
                'value="5"/><boolean name="shadingNormals" value="false"/>'
                f'{DIFFUSE}</shape>')
    else:
        raise ValueError(kind)
    return _write(d, kind, body)


@pytest.mark.parametrize("kind", [
    "ply_ascii", "ply_binary", "serialized", "primitives", "hair_text",
    "hair_binary", "heightfield_exr", "heightfield_flat"])
def test_shape_branch_matches_reference(tmp_path, kind):
    _assert_same_scene(_shape_scene(str(tmp_path), kind))


def test_mesh_readers_match_reference(tmp_path):
    """The readers behind the branches, field by field."""
    d = str(tmp_path)
    _quad_ply(os.path.join(d, "q.ply"), [(9, 8, 7)] * 4)
    _binary_ply(os.path.join(d, "b.ply"))
    _serialized(os.path.join(d, "m.serialized"))
    pairs = [(meshes.load_ply(os.path.join(d, f)),
              ref_meshes.load_ply(os.path.join(d, f)))
             for f in ("q.ply", "b.ply")]
    for idx in (0, 1):
        pairs.append((meshes.load_serialized(os.path.join(d, "m.serialized"),
                                             shape_index=idx),
                      ref_meshes.load_serialized(
                          os.path.join(d, "m.serialized"), shape_index=idx)))
    for got, ref in pairs:
        for f in dataclasses.fields(ref):
            a, b = getattr(got, f.name), getattr(ref, f.name)
            if b is None:
                assert a is None, f.name
            else:
                np.testing.assert_array_equal(a, b, err_msg=f.name)
    for writer in (_hair_text, _hair_binary):
        writer(os.path.join(d, "h.hair"))
        got = meshes.load_hair(os.path.join(d, "h.hair"))
        ref = ref_meshes.load_hair(os.path.join(d, "h.hair"))
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["hg_slab", "het_slab"])
def test_media_tables_match_reference(tmp_path, name):
    path = torch_parity.load_tool("media_scenes").write_slab_scenes(
        str(tmp_path))[name]
    _assert_same_scene(path, {"width": "8", "height": "8", "spp": "2",
                              "maxDepth": "3"})


@pytest.mark.parametrize("variant", ["floor", "absorber", "one"])
def test_sss_tables_match_reference(tmp_path, variant):
    path = torch_parity.load_tool("sss_scene").write_scene(str(tmp_path),
                                                          variant)
    _, st = _assert_same_scene(path, {"width": "8", "height": "8"})
    assert st.has_sss == (variant in ("floor", "one"))


INSTANCES = textwrap.dedent("""\
    <shape type="shapegroup" id="grp">
      <shape type="rectangle">
        <bsdf type="diffuse"><rgb name="reflectance" value="0.8, 0.2, 0.2"/></bsdf>
      </shape>
      <shape type="cube">
        <transform name="toWorld"><scale value="0.25"/><translate x="0" y="1.5" z="0"/></transform>
        <bsdf type="diffuse"><rgb name="reflectance" value="0.2, 0.8, 0.2"/></bsdf>
      </shape>
    </shape>
    <shape type="instance">
      <ref id="grp"/>
      <transform name="toWorld"><translate x="-1.5" y="0" z="0"/></transform>
    </shape>
    <shape type="instance">
      <ref id="grp"/>
      <transform name="toWorld"><rotate y="1" angle="30"/><translate x="1.5" y="0" z="0"/></transform>
    </shape>""")

CURVATURE = textwrap.dedent("""\
    <shape type="sphere">
      <float name="radius" value="1"/>
      <bsdf type="diffuse">
        <texture name="reflectance" type="curvature">
          <string name="curvature" value="mean"/>
          <float name="scale" value="0.5"/>
        </texture>
      </bsdf>
    </shape>
    <shape type="rectangle">
      <transform name="toWorld">
        <scale x="4" y="4" z="1"/><translate z="-3"/>
      </transform>
      <bsdf type="diffuse"><rgb name="reflectance" value="0 1 0"/></bsdf>
    </shape>""")

ORTHO = """<scene version="0.5.0">
  <integrator type="path"/>
  <sensor type="orthographic">
    <transform name="toWorld">
      <scale x="2" y="2" z="1"/>
      <lookat origin="0,0,-5" target="0,0,0" up="0,1,0"/>
    </transform>
    <film type="hdrfilm">
      <integer name="width" value="8"/><integer name="height" value="8"/>
    </film>
  </sensor>
  <shape type="rectangle"><bsdf type="diffuse"/></shape>
</scene>"""


def _test_scene(d, name):
    """The scenes of the reference's own tests."""
    if name == "instances":          # tests/test_instances.py
        return _write(d, name, INSTANCES)
    if name in ("vertexcolors", "wireframe"):   # tests/test_vertexattr.py
        _quad_ply(os.path.join(d, "quad.ply"),
                  [(255, 0, 0), (0, 255, 0), (0, 0, 255), (255, 255, 255)])
        tex = ('<texture name="reflectance" type="vertexcolors"/>'
               if name == "vertexcolors" else
               '<texture name="reflectance" type="wireframe">'
               '<rgb name="interiorColor" value="0.2"/>'
               '<rgb name="edgeColor" value="0.9"/>'
               '<float name="lineWidth" value="0.1"/></texture>')
        return _write(d, name, '<shape type="ply"><string name="filename" '
                      'value="quad.ply"/><boolean name="faceNormals" '
                      f'value="true"/><bsdf type="diffuse">{tex}</bsdf>'
                      '</shape>', integrator="field")
    if name == "curvature":          # tests/test_vertexattr.py
        return _write(d, name, CURVATURE, integrator="field")
    if name == "ortho":              # tests/test_scenes.py
        path = os.path.join(d, "ortho.xml")
        with open(path, "w") as f:
            f.write(ORTHO)
        return path
    if name == "hair_comb":          # tests/test_hair.py
        lines = []
        for y in np.linspace(-0.3, 0.3, 7):
            lines += [f"-0.5 {y:.3f} 0", f"0.5 {y:.3f} 0", ""]
        with open(os.path.join(d, "strand.hair"), "w") as f:
            f.write("\n".join(lines))
        return _write(d, name, '<shape type="hair"><string name="filename" '
                      'value="strand.hair"/><float name="radius" '
                      'value="0.04"/><bsdf type="diffuse"><spectrum '
                      'name="reflectance" value="0.8"/></bsdf></shape>')
    if name == "transform":          # tests/test_scene_io.py
        return _write(d, name, '<shape type="rectangle"><transform '
                      'name="toWorld"><scale value="2"/><translate x="1" '
                      'y="0" z="0"/></transform></shape>')
    raise ValueError(name)


@pytest.mark.parametrize("name", ["instances", "vertexcolors", "wireframe",
                                  "curvature", "ortho", "hair_comb",
                                  "transform"])
def test_reference_test_scenes_match(tmp_path, name):
    _assert_same_scene(_test_scene(str(tmp_path), name))


def test_xml_descriptions_match(tmp_path):
    """The parsed descriptions (xml_loader.load) of the test scenes,
    shape by shape: types, ids and every property."""
    d = str(tmp_path)
    for name in ("instances", "vertexcolors", "hair_comb", "transform"):
        path = _test_scene(d, name)
        got, ref = xml_loader.load(path), ref_xml.load(path)
        assert len(got.shapes) == len(ref.shapes), name
        for a, b in zip(got.shapes, ref.shapes):
            assert a.type == b.type
            assert sorted(a.props) == sorted(b.props)
            for k in b.props:
                np.testing.assert_array_equal(np.asarray(a.props[k]),
                                              np.asarray(b.props[k]))
