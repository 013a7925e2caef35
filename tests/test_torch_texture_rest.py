"""The rest of ROADMAP item 13 in the port against the reference on the
CPU: the barycentric payload of the hit fill (vertex colors, wireframe
edge distance, the yarn azimuth; neutral on analytic spheres), the bump
and normal map perturbation, textured opacity and blend weights, the
primary hits' footprint ellipse and the anisotropic (EWA-class) filter,
on the cloth board of tools/cloth_board.py (loaded by path) and on
seeded inputs; the reference's own checks of these features, ported
(tests/test_vertexattr.py, tests/test_bsdf_wrappers.py's identities of a
flat normal map and a constant bump, tests/test_texture.py's EWA against
trilinear and against quadrature); and path (maxDepth 5) and G-PT + L1
(maxDepth 2, the shifts of direct light: the reference's compile grows
with the depth, ~50 s here and ~90 s at maxDepth 3, as the mask makes
it unroll the full offset bounces) renders of the board (16x12, 2 spp,
seed 1) through both factories, the reference's intersectors pinned to
the linear-MT matmul sweeps.

Tolerances: ids, payload colors and booleans exactly where both sides
compute the same float expression; ops at rtol 1e-5 (a small atol for
values near 0), the filter at rtol 1e-5 on >= 99.9% of lanes and 1e-4
on all (log2 and the wraps differ in the last bit between frameworks);
images at rtol 1e-3 / atol 1e-4 on >= 99% of pixels with means within
1e-3 relative and equal rays; the L1 final by objective and mean
(torch_parity.assert_l1_final_close).  torch runs on one thread with
subnormals flushed, as XLA's CPU arithmetic does."""
import copy
import importlib.util
import os
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gradientdomain_mitsuba_tpu.ops import common as ref_common
from gradientdomain_mitsuba_tpu.ops import sensor as ref_sensor
from gradientdomain_mitsuba_tpu.ops import texture as ref_tex
from gradientdomain_mitsuba_tpu.scene import scene as ref_scene
from gradientdomain_mitsuba_tpu.scene.ir import Plugin
from gradientdomain_mitsuba_tpu_torch.core.records import Intersection
from gradientdomain_mitsuba_tpu_torch.models import factory
from gradientdomain_mitsuba_tpu_torch.models import poisson
from gradientdomain_mitsuba_tpu_torch.ops import common
from gradientdomain_mitsuba_tpu_torch.ops import intersect as isec
from gradientdomain_mitsuba_tpu_torch.ops import texture as tex
from gradientdomain_mitsuba_tpu_torch.scene import bridge
from gradientdomain_mitsuba_tpu_torch.scene import scene as port_scene
from gradientdomain_mitsuba_tpu_torch.utils import exr
from torch_parity import flush_subnormals, one_thread  # noqa: F401
from torch_parity import (assert_l1_final_close, frac_close, make_both,
                          op_close, pinned_matmul, rel_mean_diff)

pytestmark = pytest.mark.usefixtures("flush_subnormals", "one_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH = os.path.join(ROOT, "data/scenes/cbox/meshes")
W, H, SPP, SEED = 16, 12, 2, 1
BUFS = ("primal", "very_direct", "dx", "dy")


def _board_module():
    spec = importlib.util.spec_from_file_location(
        "cloth_board", os.path.join(ROOT, "tools/cloth_board.py"))
    board = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(board)
    return board


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _load(path, integrator="path", size=(W, H), depth=5):
    scene, st = ref_scene.load_scene(path, {
        "width": str(size[0]), "height": str(size[1]), "spp": str(SPP),
        "maxDepth": str(depth)})
    st.integrator = integrator
    return scene, st


@pytest.fixture(scope="module")
def board(tmp_path_factory):
    """(numpy scene, reference scene, port scene, settings) of the board
    from ONE load, and its XML's path."""
    path = _board_module().write_board(str(tmp_path_factory.mktemp("b")))
    s, st = _load(path)
    return s, jax.device_put(s), bridge.to_torch(s, "cpu"), st, path


def _camera_hits(rs_scene, n=4000, seed=5, size=(W, H)):
    """Pinhole camera rays over the film and their reference hit records
    (the matmul sweep)."""
    rs = np.random.RandomState(seed)
    pos = np.float32(rs.uniform(0, 1, (n, 2)) * size)
    u_ap = np.float32(rs.uniform(size=(n, 2)))
    o, d = ref_sensor.sample_ray(rs_scene.camera, size[0], size[1],
                                 jnp.asarray(pos), jnp.asarray(u_ap))
    closest, _ = pinned_matmul(None, 2)
    hit = closest(o, d, jnp.zeros(n), jnp.full(n, 3e38), rs_scene.geom)
    return o, d, hit


def _port_hit(hit):
    return isec.Hit(*[_t(v) for v in hit])


def _check_fill(rs_scene, ts_scene, size=(W, H)):
    o, d, hit = _camera_hits(rs_scene, size=size)
    ref = ref_common.fill_intersection(rs_scene, o, d, hit)
    got = common.fill_intersection(ts_scene, _t(o), _t(d), _port_hit(hit))
    assert got.bary is not None and got.bary.shape == (o.shape[0], 6)
    for f in ("valid", "prim_id", "shape_id", "bsdf_id", "emitter_id"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), f)
    for f in ("p", "ng", "ns", "uv"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)),
                                   rtol=1e-5, atol=1e-5, err_msg=f)
    # vertex colors, edge distance, azimuth
    np.testing.assert_allclose(got.bary.numpy(), np.asarray(ref.bary),
                               rtol=1e-5, atol=1e-5)
    return ref, got


# ------------------------------------------------------------- hit fill

def test_fill_intersection_payload(board):
    """The board's primary hits: the payload's columns and the perturbed
    shading normals against the reference's, on the same hit records."""
    _, rs_scene, ts_scene, st, _ = board
    assert ts_scene.geom.tri_shade.shape[-1] == 41
    assert ts_scene.materials.packed.shape[1] == 32
    ref, got = _check_fill(rs_scene, ts_scene)
    valid = got.valid.numpy()
    bary = got.bary.numpy()[valid]
    # the payload carries information on the board: vertex colors off
    # white, finite edge distances, unit azimuths not all (1, 0)
    assert (bary[:, :3] < 0.99).any() and np.isfinite(bary[:, 3]).all()
    np.testing.assert_allclose(np.hypot(bary[:, 4], bary[:, 5]), 1.0,
                               rtol=1e-5)
    assert (np.abs(bary[:, 5]) > 0.1).any()
    # bump / normal map lanes moved their shading normal off ng
    ns, ng = got.ns.numpy()[valid], got.ng.numpy()[valid]
    assert (np.abs((ns * ng).sum(-1)) < 0.999).any()


SPHERE = """  <shape type="sphere">
    <point name="center" x="150" y="100" z="250"/>
    <float name="radius" value="60"/>
    <bsdf type="irawan"><string name="filename" value="plain.wif"/></bsdf>
  </shape>
"""


def test_fill_intersection_payload_on_spheres(board, tmp_path):
    """With an analytic sphere beside the quads, sphere lanes get the
    neutral payload (white, no edge, azimuth (1, 0)) and keep their
    quadric normal; the triangles' payload is unchanged."""
    xml = open(board[4]).read().replace("</scene>", SPHERE + "</scene>")
    path = tmp_path / "with_sphere.xml"
    path.write_text(xml)
    s, _ = _load(str(path))
    ref, got = _check_fill(jax.device_put(s), bridge.to_torch(s, "cpu"))
    sph = (got.valid & (got.prim_id >= common.SPHERE_PRIM_BASE)).numpy()
    assert sph.any()
    np.testing.assert_array_equal(
        got.bary.numpy()[sph],
        np.tile(np.float32([1, 1, 1, 3.4e38, 1, 0]), (sph.sum(), 1)))


def test_narrow_scene_has_no_payload():
    """cbox (no payload texture, no cloth, no perturbation): the 29- and
    28-column tables, bary None, as before."""
    s, _ = port_scene.load_scene(os.path.join(ROOT,
                                              "data/scenes/cbox/cbox.xml"),
                                 {"width": "8", "height": "8"})
    ts = bridge.to_torch(s, "cpu")
    assert ts.geom.tri_shade.shape[-1] == 29
    assert ts.materials.packed.shape[1] == 28
    n = 64
    hit = isec.Hit(t=torch.ones(n), u=torch.full((n,), 0.25),
                   v=torch.full((n,), 0.25),
                   prim=torch.arange(n, dtype=torch.int32) % 30,
                   valid=torch.ones(n, dtype=torch.bool))
    its = common.fill_intersection(ts, torch.zeros(n, 3),
                                   torch.tensor([[0.0, 0.0, 1.0]]).expand(
                                       n, 3), hit)
    assert its.bary is None


def test_perturb_normal(board):
    """_perturb_normal on every board triangle at seeded barycentrics,
    with seeded unit shading normals near ng."""
    _, rs_scene, ts_scene, _, _ = board
    ts_np = np.asarray(rs_scene.geom.tri_shade)
    rs = np.random.RandomState(11)
    n = 6000
    # half the lanes on the bump / normal map quads
    mode = np.asarray(rs_scene.materials.packed)[
        ts_np[:, 18].astype(int), 28]
    perturbed = np.flatnonzero(mode > 0)
    prim = np.where(np.arange(n) % 2 == 0,
                    rs.choice(perturbed, n),
                    rs.randint(0, ts_np.shape[0], n)).astype(np.int32)
    row = ts_np[prim]
    uv = np.float32(rs.uniform(-0.2, 1.2, (n, 2)))
    ns = row[:, 0:3] + np.float32(rs.normal(scale=0.05, size=(n, 3)))
    ns = np.float32(ns / np.linalg.norm(ns, axis=-1, keepdims=True))
    bsdf_id = row[:, 18].astype(np.int32)
    ref = ref_common._perturb_normal(rs_scene, *map(jnp.asarray,
                                                    (row, bsdf_id, uv, ns)))
    got = common._perturb_normal(ts_scene, *map(_t, (row, bsdf_id, uv, ns)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    moved = np.abs(np.asarray(ref) - ns).max(-1) > 1e-3
    assert moved.mean() > 0.3


def test_primary_uv_jacobian(board):
    _, rs_scene, ts_scene, _, _ = board
    o, d, hit = _camera_hits(rs_scene)
    its = ref_common.fill_intersection(rs_scene, o, d, hit)
    ref = np.asarray(ref_common.primary_uv_jacobian(rs_scene, W, H, d, its))
    t_its = Intersection(*[_t(v) for v in its])
    got = common.primary_uv_jacobian(ts_scene, W, H, _t(d), t_its).numpy()
    assert got.shape == (d.shape[0], 2, 2)
    scale = np.abs(ref).max(axis=(1, 2), keepdims=True) + 1e-12
    np.testing.assert_allclose(got / scale, ref / scale, rtol=1e-5,
                               atol=1e-5)
    assert np.abs(ref[np.asarray(its.valid)]).max() > 0


# -------------------------------------------------------------- textures

def _bitmap_table(tmp_path, img, ewa=True):
    path = str(tmp_path / "img.exr")
    exr.write(path, img, half=False)
    node = Plugin(kind="texture", type="bitmap", props={
        "filename": "img.exr", "filterType": "ewa" if ewa else "trilinear",
        "uscale": 1.3, "vscale": 0.8})
    table = ref_tex.build_table([node], str(tmp_path))
    return table, jax.device_put(table), bridge.to_torch(table, "cpu")


def test_aniso_sample(tmp_path):
    """eval_texture with footprint ellipses (isotropic to anisotropy past
    the clamp, every mip level and beyond) on a 37x29 noise bitmap."""
    rs = np.random.RandomState(21)
    _, r_tab, t_tab = _bitmap_table(
        tmp_path, np.float32(rs.uniform(0, 1, (29, 37, 3))))
    n = 6000
    uv = np.float32(rs.uniform(-2, 3, (n, 2)))
    jac = np.float32(rs.normal(size=(n, 2, 2)) *
                     10.0 ** rs.uniform(-4, 0, (n, 1, 1)))
    jac[::3, :, 1] *= np.float32(10.0 ** rs.uniform(-3, 0, (len(jac[::3]),
                                                           1)))
    area = np.float32(np.abs(np.linalg.det(jac)))
    tid = np.zeros(n, np.int32)
    ref = ref_tex.eval_texture(r_tab, jnp.asarray(tid), jnp.asarray(uv),
                               (jnp.asarray(area), jnp.asarray(jac)))
    got = tex.eval_texture(t_tab, _t(tid), _t(uv), (_t(area), _t(jac)))
    op_close(got.numpy(), np.asarray(ref), "aniso", atol=1e-6)
    iso = tex.eval_texture(t_tab, _t(tid), _t(uv), _t(area))
    assert not torch.allclose(iso, got)


def test_aniso_isotropic_matches_trilinear(tmp_path):
    """tests/test_texture.py's check on the port: an isotropic footprint
    filters as trilinear does, closely."""
    rs = np.random.RandomState(0)
    _, _, t_tab = _bitmap_table(tmp_path,
                                rs.rand(32, 32, 3).astype(np.float32))
    uv = torch.from_numpy(rs.rand(64, 2).astype(np.float32))
    tid = torch.zeros(64, dtype=torch.int32)
    s = 0.1
    area = torch.full((64,), s * s)
    jac = torch.tensor([[s, 0.0], [0.0, s]]).expand(64, 2, 2)
    aniso = tex.eval_texture(t_tab, tid, uv, (area, jac))
    tri = tex.eval_texture(t_tab, tid, uv, area)
    np.testing.assert_allclose(aniso.numpy(), tri.numpy(), atol=0.12)


def test_aniso_filter_vs_ewa_quadrature(tmp_path):
    """tests/test_texture.py's check on the port: on a footprint whose
    major axis runs along vertical stripes, the 8-tap filter tracks an
    elliptical-Gaussian quadrature of the level-0 image much closer than
    trilinear filtering, and keeps more of the stripes' contrast."""
    Wt = Ht = 64
    x = np.arange(Wt)
    img = np.broadcast_to((0.25 + 0.5 * ((x // 4) % 2))[None, :, None],
                          (Ht, Wt, 3)).astype(np.float32)
    exr.write(str(tmp_path / "stripes.exr"), img, half=False)
    node = Plugin(kind="texture", type="bitmap",
                  props={"filename": "stripes.exr", "filterType": "ewa"})
    t_tab = bridge.to_torch(ref_tex.build_table([node], str(tmp_path)),
                            "cpu")
    n_pts = 16
    uv = np.stack([np.linspace(0.1, 0.9, n_pts),
                   np.full(n_pts, 0.5)], -1).astype(np.float32)
    major = np.array([0.0, 16.0 / Ht], np.float32)
    minor = np.array([1.0 / Wt, 0.0], np.float32)
    jac = np.broadcast_to(np.stack([major, minor], -1),
                          (n_pts, 2, 2)).copy()
    area = float(np.linalg.norm(major) * np.linalg.norm(minor))
    tid = torch.zeros(n_pts, dtype=torch.int32)
    aniso = tex.eval_texture(t_tab, tid, _t(uv), (torch.full(
        (n_pts,), area), _t(jac))).numpy()[:, 0]
    iso = tex.eval_texture(t_tab, tid, _t(uv),
                           torch.full((n_pts,), area)).numpy()[:, 0]

    def bilin(u, v):
        xx = (u % 1.0) * Wt - 0.5
        yy = ((1.0 - v) % 1.0) * Ht - 0.5
        x0 = np.floor(xx).astype(int)
        y0 = np.floor(yy).astype(int)
        fx, fy = xx - x0, yy - y0
        p = img[..., 0]
        g = lambda yi, xi: p[np.mod(yi, Ht), np.mod(xi, Wt)]
        return (g(y0, x0) * (1 - fx) * (1 - fy) +
                g(y0, x0 + 1) * fx * (1 - fy) +
                g(y0 + 1, x0) * (1 - fx) * fy +
                g(y0 + 1, x0 + 1) * fx * fy)

    ts = np.linspace(-0.5, 0.5, 41)
    T, S = np.meshgrid(ts, ts, indexing="ij")
    wq = np.exp(-8.0 * (T * T + S * S))
    ref = np.array([
        (wq * bilin(uv[i, 0] + T * major[0] + S * minor[0],
                    uv[i, 1] + T * major[1] + S * minor[1])).sum() / wq.sum()
        for i in range(n_pts)])
    err_aniso = np.abs(aniso - ref).mean()
    err_iso = np.abs(iso - ref).mean()
    assert err_aniso < 0.5 * err_iso, (err_aniso, err_iso)
    assert err_aniso < 0.06, err_aniso
    assert aniso.std() > 1.25 * iso.std(), (aniso.std(), iso.std())


def test_eval_texture_bary(board):
    """vertexcolors / wireframe read the payload; without one they give
    their flat color0, on the board's texture table and seeded
    payloads."""
    _, rs_scene, ts_scene, _, _ = board
    kinds = np.asarray(rs_scene.textures.kind)
    rs = np.random.RandomState(3)
    n = 4000
    tid = rs.randint(0, len(kinds), n).astype(np.int32)
    uv = np.float32(rs.uniform(-1, 2, (n, 2)))
    bary = np.float32(np.concatenate([
        rs.uniform(0, 1, (n, 3)), rs.uniform(0, 4, (n, 1)),
        rs.normal(size=(n, 2))], -1))
    for b in (bary, None):
        ref = ref_tex.eval_texture(rs_scene.textures, jnp.asarray(tid),
                                   jnp.asarray(uv),
                                   bary=None if b is None else
                                   jnp.asarray(b))
        got = tex.eval_texture(ts_scene.textures, _t(tid), _t(uv),
                               bary=_t(b))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-6)
    assert {ref_tex.TEX_VERTEXCOLOR, ref_tex.TEX_WIREFRAME} <= set(kinds)


def test_eval_texture_bary_dispatch():
    """tests/test_vertexattr.py's dispatch check on the port."""
    vc = Plugin(kind="texture", type="vertexcolors", props={})
    wf = Plugin(kind="texture", type="wireframe", props={
        "interiorColor": np.array([0.2, 0.2, 0.2], np.float32),
        "edgeColor": np.array([1.0, 0.0, 0.0], np.float32),
        "lineWidth": 0.1})
    table = bridge.to_torch(ref_tex.build_table([vc, wf], "."), "cpu")
    uv = torch.zeros((2, 2))
    ids = torch.tensor([0, 1], dtype=torch.int32)
    bary = torch.tensor([[0.1, 0.9, 0.3, 5.0], [0.5, 0.5, 0.5, 0.05]])
    out = tex.eval_texture(table, ids, uv, bary=bary).numpy()
    np.testing.assert_allclose(out[0], [0.1, 0.9, 0.3], atol=1e-6)
    np.testing.assert_allclose(out[1], [1.0, 0.0, 0.0], atol=1e-6)
    out2 = tex.eval_texture(table, ids, uv).numpy()
    np.testing.assert_allclose(out2[0], [1, 1, 1], atol=1e-6)
    np.testing.assert_allclose(out2[1], [0.2, 0.2, 0.2], atol=1e-6)


@pytest.mark.parametrize("fn", ["resolve_opacity", "resolve_blend_weight"])
def test_resolve_textured_weights(board, fn):
    """The mask's textured opacity and the blendbsdf's textured weight on
    every board row at seeded uv (untextured rows keep their scalar)."""
    _, rs_scene, ts_scene, _, _ = board
    rs = np.random.RandomState(7)
    n = 4000
    mid = rs.randint(0, ts_scene.materials.packed.shape[0],
                     n).astype(np.int32)
    uv = np.float32(rs.uniform(-1, 2, (n, 2)))
    ref = np.asarray(getattr(ref_tex, fn)(rs_scene, jnp.asarray(mid),
                                          jnp.asarray(uv)))
    got = getattr(tex, fn)(ts_scene, _t(mid), _t(uv)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    # the textured rows differ from their scalar somewhere
    col = 22 if fn == "resolve_opacity" else 26
    assert (ref != np.asarray(rs_scene.materials.packed)[mid, col]).any()


def test_material_params_all_bits(board):
    """material_params under has_textures 31 at the board's primary hits
    (payload included): every field, the wrapper's second child and the
    cloth features."""
    _, rs_scene, ts_scene, st, _ = board
    assert st.has_textures == 31 and st.has_ewa
    o, d, hit = _camera_hits(rs_scene)
    its = ref_common.fill_intersection(rs_scene, o, d, hit)
    fp = ref_common.primary_uv_footprint(rs_scene, W, H, d, its)
    jac = ref_common.primary_uv_jacobian(rs_scene, W, H, d, its)
    ref = ref_common.material_params(rs_scene, 31, its.bsdf_id, its.uv,
                                     uv_footprint=(fp, jac), bary=its.bary)
    got = common.material_params(ts_scene, 31, _t(its.bsdf_id), _t(its.uv),
                                 uv_footprint=(_t(fp), _t(jac)),
                                 bary=_t(its.bary))
    for p_ref, p_got in ((ref, got), (ref.blend, got.blend)):
        for f in ("kind", "reflectance", "specular", "opacity", "blend_w",
                  "alpha", "alpha_v", "spec_weight"):
            r = getattr(p_ref, f)
            if r is None:
                continue
            op_close(getattr(p_got, f).numpy(), np.asarray(r), f,
                     atol=1e-6)
        op_close(p_got.cloth.numpy(), np.asarray(p_ref.cloth), "cloth",
                 atol=1e-6)
    assert (np.asarray(ref.opacity) < 1).any()
    assert ((np.asarray(ref.blend_w) > 0) &
            (np.asarray(ref.blend_w) < 1)).any() or \
        (np.asarray(ref.blend_w) == 1).any()


# ---------------------------------------- the reference's render checks

WRAP_XML = textwrap.dedent("""\
    <scene version="0.5.0">
      <integrator type="path"><integer name="maxDepth" value="3"/></integrator>
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
      {floor_bsdf}
      <shape type="rectangle">
        <transform name="toWorld">
          <rotate x="1" angle="-90"/><scale x="278" y="1" z="280"/>
          <translate x="278" y="0" z="280"/>
        </transform>
        <ref id="floor"/></shape>
      <shape type="obj"><string name="filename" value="{mesh}/cbox_back.obj"/>
        <bsdf type="diffuse"><rgb name="reflectance" value="0.5 0.5 0.5"/></bsdf>
      </shape>
      <shape type="rectangle">
        <transform name="toWorld">
          <rotate x="1" angle="90"/><scale x="65" y="1" z="52"/>
          <translate x="278" y="548" z="279"/>
        </transform>
        <emitter type="area"><rgb name="radiance" value="18, 15, 8"/></emitter>
      </shape>
    </scene>
""")

PLAIN_FLOOR = """<bsdf type="diffuse" id="floor">
    <rgb name="reflectance" value="0.6 0.55 0.5"/></bsdf>"""


def _port_render(tmp_path, xml, name, spp=8, seed=3):
    path = tmp_path / f"{name}.xml"
    path.write_text(xml)
    scene, st = port_scene.load_scene(str(path))
    ts = bridge.to_torch(scene, "cpu")
    return factory.make_integrator(ts, st).render(ts, seed=seed,
                                                  spp=spp).numpy(), ts


@pytest.mark.parametrize("wrapper,color", [("normalmap", "0.5 0.5 1.0"),
                                           ("bumpmap", "0.5 0.5 0.5")])
def test_constant_perturbation_is_identity(tmp_path, wrapper, color):
    """tests/test_bsdf_wrappers.py's identities on the port: a flat normal
    map and a constant bump height leave the render as it is."""
    wrapped = f"""<bsdf type="{wrapper}" id="floor">
        <texture type="checkerboard">
          <rgb name="color0" value="{color}"/><rgb name="color1" value="{color}"/>
        </texture>
        <bsdf type="diffuse"><rgb name="reflectance" value="0.6 0.55 0.5"/></bsdf>
      </bsdf>"""
    a, _ = _port_render(tmp_path, WRAP_XML.format(
        mesh=MESH, floor_bsdf=PLAIN_FLOOR), "plain")
    b, ts = _port_render(tmp_path, WRAP_XML.format(
        mesh=MESH, floor_bsdf=wrapped), wrapper)
    assert ts.materials.packed.shape[1] == 32   # perturbation compiled in
    np.testing.assert_allclose(b, a, rtol=2e-3, atol=2e-4)


def test_tilted_normalmap_changes_shading(tmp_path):
    wrapped = """<bsdf type="normalmap" id="floor">
        <texture type="checkerboard">
          <rgb name="color0" value="0.8 0.5 0.8"/><rgb name="color1" value="0.8 0.5 0.8"/>
        </texture>
        <bsdf type="diffuse"><rgb name="reflectance" value="0.6 0.55 0.5"/></bsdf>
      </bsdf>"""
    a, _ = _port_render(tmp_path, WRAP_XML.format(
        mesh=MESH, floor_bsdf=PLAIN_FLOOR), "plain")
    b, _ = _port_render(tmp_path, WRAP_XML.format(
        mesh=MESH, floor_bsdf=wrapped), "tilted")
    assert np.isfinite(b).all() and np.abs(a - b).mean() > 1e-3


def _write_quad_ply(path, colors):
    """[-1,1]^2 quad at z=0, two triangles split along the (-1,-1)-(1,1)
    diagonal, uchar vertex colors (tests/test_vertexattr.py's)."""
    verts = [(-1, -1, 0), (1, -1, 0), (1, 1, 0), (-1, 1, 0)]
    lines = ["ply", "format ascii 1.0", "element vertex 4",
             "property float x", "property float y", "property float z",
             "property uchar red", "property uchar green",
             "property uchar blue", "element face 2",
             "property list uchar int vertex_indices", "end_header"]
    for (x, y, z), (r, g, b) in zip(verts, colors):
        lines.append(f"{x} {y} {z} {r} {g} {b}")
    lines += ["3 0 1 2", "3 0 2 3"]
    path.write_text("\n".join(lines) + "\n")


ALBEDO_XML = textwrap.dedent("""\
    <scene version="0.5.0">
      <integrator type="field"><string name="field" value="albedo"/></integrator>
      <sensor type="perspective">
        <float name="fov" value="50"/>
        <transform name="toWorld">
          <lookat origin="0, 0, 3" target="0, 0, 0" up="0, 1, 0"/>
        </transform>
        <sampler type="independent"><integer name="sampleCount" value="1"/></sampler>
        <film type="hdrfilm">
          <integer name="width" value="32"/><integer name="height" value="32"/>
          <rfilter type="box"/>
        </film>
      </sensor>
      <shape type="ply">
        <string name="filename" value="{ply}"/>
        <boolean name="faceNormals" value="true"/>
        <bsdf type="diffuse">{tex}</bsdf>
      </shape>
    </scene>
""")


def test_vertexcolors_interpolates(tmp_path):
    """tests/test_vertexattr.py's field-albedo check on the port."""
    _write_quad_ply(tmp_path / "quad.ply", [(255, 0, 0), (0, 255, 0),
                                            (0, 0, 255), (255, 255, 255)])
    img, _ = _port_render(tmp_path, ALBEDO_XML.format(
        ply=tmp_path / "quad.ply",
        tex='<texture name="reflectance" type="vertexcolors"/>'), "vc",
        spp=1, seed=0)
    assert np.isfinite(img).all()
    assert (img.sum(-1) > 0).mean() > 0.2
    h, w = img.shape[:2]
    quads = [img[:h // 2, :w // 2], img[:h // 2, w // 2:],
             img[h // 2:, :w // 2], img[h // 2:, w // 2:]]
    dom = {int(np.argmax(q.reshape(-1, 3).mean(0))) for q in quads}
    assert {0, 1, 2} <= dom | {int(np.argmax(img.reshape(-1, 3).mean(0)))}
    assert img.max() <= 1.0 + 1e-5


def test_wireframe_edges(tmp_path):
    """tests/test_vertexattr.py's wireframe check on the port."""
    _write_quad_ply(tmp_path / "quad.ply", [(255, 255, 255)] * 4)
    img, _ = _port_render(tmp_path, ALBEDO_XML.format(
        ply=tmp_path / "quad.ply", tex="""<texture name="reflectance"
          type="wireframe"><rgb name="interiorColor" value="0, 0, 0"/>
          <rgb name="edgeColor" value="1, 1, 1"/>
          <float name="lineWidth" value="0.08"/></texture>"""), "wf",
        spp=1, seed=0)
    assert np.isfinite(img).all()
    lum = img.mean(-1)
    cy, cx = lum.shape[0] // 2, lum.shape[1] // 2
    assert lum[cy, cx] > 0.5
    assert lum[cy // 2, cx + cx // 2] < 0.1 or \
        lum[cy + cy // 2, cx // 2] < 0.1
    assert 0.02 < (lum > 0.5).mean() < 0.6


# ----------------------------------------------------------- the board

@pytest.fixture(scope="module")
def board_renders(board):
    """Path and G-PT (+ L1) of the board in both packages, rays counted."""
    from gradientdomain_mitsuba_tpu.models import poisson as ref_poisson
    out = {}
    for integ, depth in (("path", 5), ("gpt", 2)):
        scene, st = _load(board[4], integ, depth=depth)
        rt, rs, pt, ts = make_both(scene, st)
        rt.count_rays = pt.count_rays = True
        ref = rt.render(rs, seed=SEED, spp=SPP)
        got = pt.render(ts, seed=SEED, spp=SPP)
        if integ == "path":
            ref, got = {"img": np.asarray(ref)}, {"img": got.numpy()}
        else:
            ref["L1"] = ref_poisson.reconstruct(ref, mode="L1")
            got["L1"] = poisson.reconstruct(got, mode="L1")
            ref = {k: np.asarray(v) for k, v in ref.items()}
            got = {k: v.numpy() for k, v in got.items()}
        out[integ] = dict(ref=ref, got=got, rays=(int(rt.last_ray_count),
                                                  int(pt.last_ray_count)),
                          tracer=pt)
    return out


def _check_image(got, ref, lit=None):
    assert got.shape == ref.shape == (H, W, 3)
    assert np.isfinite(got).all()
    if lit is not None:
        assert (ref.max(-1) > 1e-4).mean() > lit
    assert frac_close(got, ref) >= 0.99
    assert rel_mean_diff(got, ref) <= 1e-3


def test_board_path_matches_reference(board_renders):
    r = board_renders["path"]
    assert r["tracer"].has_ewa and r["tracer"].has_textures == 31
    _check_image(r["got"]["img"], r["ref"]["img"], lit=0.5)
    assert r["rays"][0] == r["rays"][1] > 0


@pytest.mark.parametrize("name", BUFS)
def test_board_gpt_buffers_match_reference(board_renders, name):
    r = board_renders["gpt"]
    got, ref = r["got"][name], r["ref"][name]
    if name == "very_direct":
        _check_image(got, ref)
    elif name == "primal":
        _check_image(got, ref, lit=0.5)
    else:
        # gradients: pixel rule; the mean of a signed image near 0 is
        # held against the buffer's scale
        assert np.isfinite(got).all() and got.shape == ref.shape
        assert frac_close(got, ref) >= 0.99
        assert abs(got.mean() - ref.mean()) <= 1e-3 * np.abs(ref).mean()


def test_board_gpt_rays_and_l1(board_renders):
    r = board_renders["gpt"]
    assert r["tracer"].any_specular   # the mask classes as specular
    assert r["rays"][0] == r["rays"][1] > 0
    assert_l1_final_close(r["got"]["L1"], r["ref"])


def test_factory_builds_every_tracer_on_the_board(board):
    """Every type of KNOWN builds on the board, the tracers with their
    own loops (volpath, irrcache, sppm / ppm / photonmapper, vpl, the
    chains) included since step G2b-2 (their parity:
    tests/test_torch_texture_loops.py, _photons.py, _chains.py)."""
    s, _, ts, st, _ = board
    assert st.has_textures == 31
    own = {"volpath": "VolPathTracer", "volpath_simple": "VolPathTracer",
           "irrcache": "IrrCacheTracer", "sppm": "SPPMTracer",
           "ppm": "SPPMTracer", "photonmapper": "SPPMTracer",
           "vpl": "VPLTracer", "pssmlt": "PSSMLTracer",
           "erpt": "ERPTracer", "mlt": "MLTracer"}
    for integ in factory.KNOWN:
        st2 = copy.deepcopy(st)
        st2.integrator = integ
        tracer = factory.make_integrator(ts, st2)
        if integ in own:
            assert type(tracer).__name__ == own[integ]
            inner = getattr(tracer, "inner", tracer)
            assert inner.has_textures == 31
