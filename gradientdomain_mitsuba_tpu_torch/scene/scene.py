"""Scene compilation: plugin IR -> frozen tree of numpy arrays.

Counterpart of gradientdomain_mitsuba_tpu/scene/scene.py, numpy only (the
reference's copy imports its JAX ops package).  Replaces
Scene::initialize + plugin instantiation (src/librender/scene.cpp,
src/libcore/plugin.cpp): instead of an object graph, the scene becomes
flat SoA arrays (triangle soup in BVH order, material table, emitter
tables, camera matrices); scene/bridge.to_torch moves them to a device.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np

from ..core import math as cm
from ..ops.intersect import BVHArrays, ClusterArrays, TriSoup
from . import bvh as bvh_mod
from . import meshes as mesh_mod
from .ir import Plugin, SceneDesc, spectrum_value
from .materials import MaterialBuilder, Materials
from ..ops.texture import TextureTable, build_table
from ..utils import stats


class Geometry(NamedTuple):
    tris: TriSoup            # BVH leaf order (window-padded, degenerate tail)
    bvh: BVHArrays
    clusters: ClusterArrays  # two-level traversal (ops/intersect.py)
    tri9: np.ndarray         # [K, 16, window] cluster slabs (pallas_trace.py)
    cbounds: np.ndarray      # [K, 6] packed cluster bounds (pallas_trace.py)
    linC: np.ndarray         # [10, 4*Tp] linear-MT matmul coefficients
    #                          (ops/intersect.py; [10,4] dummy when unused)
    mt_slabs: np.ndarray     # [K, 8, 4*window] per-cluster linear-MT DMA
    #                          slabs (pallas_trace.py; dummy when small)
    # packed per-triangle shading rows in BVH ORDER — ONE gather per hit
    # instead of a 13-gather dependent chain (TPU gathers are the wavefront
    # hot spot; see ops/common.fill_intersection):
    # [0:3] ng, [3:12] n0 n1 n2, [12:18] uv0 uv1 uv2,
    # [18] bsdf_id, [19] emitter_id, [20] shape_id, [21] use_face_normals,
    # [22] uv-area per world-area (mipmap LOD)
    tri_shade: np.ndarray    # [T, 23] f32
    positions: np.ndarray    # [V, 3] (original order)
    normals: np.ndarray      # [V, 3] shading normals
    uvs: np.ndarray          # [V, 2]
    indices: np.ndarray      # [T, 3] i32 (original tri order)
    tri_shape: np.ndarray    # [T] i32
    shape_bsdf: np.ndarray   # [S] i32
    shape_emitter: np.ndarray  # [S] i32 (-1 = not an emitter)
    shape_use_face_normals: np.ndarray  # [S] bool
    # analytic spheres (src/shapes/sphere.cpp quadric path): merged into
    # every traversal by ops/common.add_sphere_intersections; exact
    # normals.  Emissive spheres stay tessellated (triangle-based emitter
    # sampling) — a documented deviation.
    sph_center: np.ndarray   # [A, 3]
    sph_radius: np.ndarray   # [A]
    sph_bsdf: np.ndarray     # [A] i32
    sph_shape: np.ndarray    # [A] i32
    # participating media attachment (scene/media.py): per-shape medium
    # ids, -1 = vacuum (Shape::{get,set}{Interior,Exterior}Medium)
    shape_interior: np.ndarray = np.zeros(0, np.int32)  # [S] i32
    shape_exterior: np.ndarray = np.zeros(0, np.int32)  # [S] i32


class EmitterTable(NamedTuple):
    """Area emitters + scene-level constant/env emitter."""
    radiance: np.ndarray      # [E, 3] area emitter radiance
    shape: np.ndarray         # [E] i32 owning shape
    tri_offset: np.ndarray    # [E] i32 into tri_cdf/tri_index
    tri_count: np.ndarray     # [E] i32
    tri_cdf: np.ndarray       # [sumT] normalized per-emitter cumulative area
    tri_index: np.ndarray     # [sumT] i32 original tri ids
    total_area: np.ndarray    # [E]
    # delta emitters (point/spot/directional): kind 0/1/2
    delta_kind: np.ndarray    # [D] i32
    delta_pos: np.ndarray     # [D, 3]
    delta_dir: np.ndarray     # [D, 3] (spot/directional)
    delta_intensity: np.ndarray  # [D, 3] (directional: irradiance)
    delta_cos_total: np.ndarray  # [D] spot total cutoff cosine
    delta_cos_falloff: np.ndarray  # [D] spot falloff-begin cosine
    # environment: kind 0=none, 1=constant, 2=envmap
    env_kind: np.ndarray      # scalar i32
    env_radiance: np.ndarray  # [3] constant radiance / envmap scale
    env_to_world: np.ndarray  # [4, 4]
    env_world_to_local: np.ndarray  # [4, 4]
    env_map: np.ndarray       # [He, We, 3] (1x1 dummy when unused)
    env_cdf_rows: np.ndarray  # [He+1] marginal CDF over rows
    env_cdf_cols: np.ndarray  # [He, We+1] conditional CDF per row
    env_pdf: np.ndarray       # [He, We] solid-angle pdf per texel
    # packed per-emitter-triangle geometry [sumT, 12]: p0 | p1-p0 | p2-p0 |
    # unit ng — ONE row gather per NEE/emission sample instead of the
    # 4-gather dependent chain tri_index->indices->positions x3 (see
    # ops/emitter.py)
    tri_geo: np.ndarray = np.zeros((1, 12), np.float32)


class SSSTable(NamedTuple):
    """Dipole subsurface attachments (src/subsurface/dipole.cpp): one row
    per <subsurface>-carrying shape, with a per-row triangle area CDF for
    irradiance-sample placement (mirrors EmitterTable's layout)."""
    sigma_s: np.ndarray     # [R, 3] reduced-rate inputs (unscaled)
    sigma_a: np.ndarray     # [R, 3]
    g: np.ndarray           # [R] phase asymmetry (sigma_s' = sigma_s(1-g))
    eta: np.ndarray         # [R] relative IOR
    shape: np.ndarray       # [R] i32 owning shape
    shape_sss: np.ndarray   # [S] i32 shape -> row (-1 = none)
    tri_offset: np.ndarray  # [R] i32 into tri_cdf/tri_index
    tri_count: np.ndarray   # [R] i32
    tri_cdf: np.ndarray     # [sumT] per-row normalized cumulative area
    tri_index: np.ndarray   # [sumT] i32 original tri ids
    total_area: np.ndarray  # [R]


class Camera(NamedTuple):
    to_world: np.ndarray          # [4, 4]
    world_to_camera: np.ndarray   # [4, 4]
    sample_to_camera: np.ndarray  # [4, 4]
    camera_to_sample: np.ndarray  # [4, 4]
    aperture_radius: np.ndarray   # scalar
    focus_distance: np.ndarray    # scalar
    # projection kind (scalar f32): 0=perspective/thinlens,
    # 1=orthographic/telecentric, 2=spherical (lat-long), 3=radiancemeter,
    # 4=fluencemeter — covering src/sensors/{perspective,thinlens,
    # orthographic,telecentric,spherical,radiancemeter,fluencemeter}.cpp
    kind: np.ndarray
    # radial distortion [k1, k2] (perspective_rdist.cpp, Zhang model);
    # zeros = undistorted
    kc: np.ndarray = np.zeros(2, np.float32)


class SceneData(NamedTuple):
    """The full device scene pytree."""
    geom: Geometry
    materials: Materials
    emitters: EmitterTable
    camera: Camera
    textures: TextureTable
    ray_eps: np.ndarray  # scalar: min-t epsilon scaled to scene extent
    media: Any = None    # MediumTable (scene/media.py); None = no media
    sss: Any = None      # SSSTable; None = no subsurface attachments


@dataclass
class RenderSettings:
    """Static (host) configuration — not traced."""
    width: int = 256
    height: int = 256
    spp: int = 16
    integrator: str = "path"
    integrator_props: Dict[str, Any] = field(default_factory=dict)
    max_depth: int = -1          # -1 = unlimited (Mitsuba convention)
    rr_depth: int = 5
    sampler: str = "independent"
    rfilter: str = "gaussian"
    stack_depth: int = 64        # BVH traversal stack bound (static)
    num_emitters: int = 0
    has_env: bool = False
    env_kind: int = 0
    has_textures: bool = False
    has_ewa: bool = False
    n_delta: int = 0
    cluster_window: int = 64
    fov_x_deg: float = 45.0
    banner: bool = False
    output: str = "output.exr"
    strict_normals: bool = False
    has_media: bool = False      # any medium rows bound to shapes/sensor
    has_het_media: bool = False  # any density-grid medium rows
    has_sss: bool = False        # any dipole subsurface attachments
    sss_props: Dict[str, Any] = field(default_factory=dict)
    sensor_medium: int = -1      # camera-ray starting medium id
    # nested <integrator> children as (type, props) pairs (multichannel/
    # adaptive wrappers)
    integrator_children: List[Any] = field(default_factory=list)
    # host prep-phase wall-clock breakdown (parse/mesh/bvh_build/clusters/
    # layout/slabs/shade + geometry-cache state) — SURVEY §6.4/§6.5
    prep_times: Dict[str, Any] = field(default_factory=dict)


_BSDF_KINDS = ("bsdf",)


def _shape_mesh(shape: Plugin, base_dir: str) -> mesh_mod.Mesh:
    t = shape.type
    fn = bool(shape.get("faceNormals", False))
    if t == "obj":
        return mesh_mod.load_obj(
            os.path.join(base_dir, shape.get("filename")), face_normals=fn)
    if t == "ply":
        return mesh_mod.load_ply(
            os.path.join(base_dir, shape.get("filename")), face_normals=fn)
    if t == "serialized":
        return mesh_mod.load_serialized(
            os.path.join(base_dir, shape.get("filename")),
            shape_index=int(shape.get("shapeIndex", 0)), face_normals=fn)
    if t == "rectangle":
        return mesh_mod.make_rectangle()
    if t == "cube":
        return mesh_mod.make_cube()
    if t == "sphere":
        center = shape.get("center", np.zeros(3, np.float32))
        radius = float(shape.get("radius", 1.0))
        # nTheta/nPhi: extension props controlling tessellation density
        return mesh_mod.make_sphere(
            center, radius, n_theta=int(shape.get("nTheta", 64)),
            n_phi=int(shape.get("nPhi", 128)))
    if t == "disk":
        return mesh_mod.make_disk()
    if t == "cylinder":
        return mesh_mod.make_cylinder(
            p0=shape.get("p0", np.array([0, 0, 0], np.float32)),
            p1=shape.get("p1", np.array([0, 0, 1], np.float32)),
            radius=float(shape.get("radius", 1.0)))
    if t == "hair":
        fibers = mesh_mod.load_hair(
            os.path.join(base_dir, shape.get("filename")))
        # angleThreshold simplification not carried over (it only merges
        # near-collinear segments — a perf knob for the reference's
        # HairKDTree, moot under the shared BVH)
        return mesh_mod.make_hair(
            fibers, radius=float(shape.get("radius", 0.025)),
            n_seg=int(shape.get("nSeg", 6)),
            reduction=float(shape.get("reduction", 0.0)))
    if t == "heightfield":
        fn_img = shape.get("filename")
        scale = float(shape.get("scale", 1.0))
        if fn_img is not None:
            path = os.path.join(base_dir, fn_img)
            if path.lower().endswith((".exr", ".pfm")):
                from ..utils import exr as exr_mod
                img = exr_mod.read_rgb(path)
            else:
                from PIL import Image
                img = np.asarray(Image.open(path).convert("RGB"),
                                 np.float32) / 255.0
            # luminance drives the displacement (heightfield.cpp reads a
            # single-channel texture; RGB collapses via Rec.709 luma)
            vals = (img @ np.asarray([0.2126, 0.7152, 0.0722],
                                     np.float32)) * scale
        else:
            res = int(shape.get("resolution", 2))
            vals = np.zeros((res, res), np.float32)
        return mesh_mod.make_heightfield(
            vals, shading_normals=bool(shape.get("shadingNormals", True)))
    raise ValueError(f"unsupported shape type '{t}'")


def _expand_instances(shapes):
    """shapegroup/instance support (reference: src/shapes/shapegroup.cpp,
    instance.cpp): instances are baked at compile time — each <instance>
    emits transformed copies of its group's shapes into the global
    triangle soup (our flattened SoA design has no two-level BVH; baking
    keeps every traversal path unchanged and costs only memory)."""
    out = []
    for shape in shapes:
        if shape.type == "shapegroup":
            continue  # rendered only via <instance>
        if shape.type != "instance":
            out.append(shape)
            continue
        grp = None
        for ch in shape.children:
            if ch.kind == "shape" and ch.type == "shapegroup":
                grp = ch
                break
        if grp is None:
            raise ValueError("<instance> must reference a <shapegroup>")
        iw = np.asarray(shape.get("toWorld", np.eye(4)), np.float64)
        for j, sub in enumerate(grp.children):
            if sub.kind != "shape":
                continue
            sw = np.asarray(sub.get("toWorld", np.eye(4)), np.float64)
            props = dict(sub.props)
            props["toWorld"] = iw @ sw
            # instances of one shapegroup share the object-space mesh:
            # tag them so compile_scene tessellates/loads it ONCE
            props["_mesh_key"] = (id(grp), j)
            out.append(Plugin(kind="shape", type=sub.type, props=props,
                              children=sub.children, id=None))
    return out


def _pack_tri_shade(tris, order, psel, valid_slot, indices, normals, uvs,
                    vcolors, tri_shape, sb, se, sf, needs_bary):
    """Packed per-triangle shading rows [Tp, 29|41], computed DIRECTLY in
    the padded cluster-major layout (one fused [Tp] gather per attribute;
    building in original order then permuting cost two full [T, 29]
    permute copies plus 29 strided column writes).

    Columns: [0:3] geometric normal, [3:12] vertex normals, [12:18]
    vertex UVs, [18] bsdf id, [19] emitter id, [20] shape id, [21]
    face-normal flag, [22] UV area per world area (mipmap LOD), [23:29]
    dp/du + dp/dv tangents; bary extension: [29:38] vertex colors,
    [38:41] triangle heights (wireframe edge distances)."""
    opsel = order[psel]                         # [Tp] original tri per slot
    idxp = indices[opsel]                       # [Tp, 3] vertex ids
    e1w = np.asarray(tris.e1, np.float32)
    e2w = np.asarray(tris.e2, np.float32)
    ng_all = np.cross(e1w, e2w)
    area2 = np.linalg.norm(ng_all, axis=-1)        # 2x world area
    ng_all /= np.maximum(area2[..., None], 1e-20)
    shape_of_tri = tri_shape[opsel]
    uv0 = uvs[idxp[:, 0]]
    uv1 = uvs[idxp[:, 1]]
    uv2 = uvs[idxp[:, 2]]
    e1uv = uv1 - uv0
    e2uv = uv2 - uv0
    uv_area2 = np.abs(e1uv[:, 0] * e2uv[:, 1] - e1uv[:, 1] * e2uv[:, 0])
    # dp/du, dp/dv — UV-aligned tangents (bumpmap/normalmap perturbation
    # + EWA anisotropy; zero when UVs degenerate)
    det_uv = e1uv[:, 0] * e2uv[:, 1] - e1uv[:, 1] * e2uv[:, 0]
    ok_uv = np.abs(det_uv) > 1e-12
    inv_det = np.where(ok_uv, 1.0 / np.where(ok_uv, det_uv, 1.0), 0.0)
    cols = [ng_all,
            normals[idxp[:, 0]], normals[idxp[:, 1]], normals[idxp[:, 2]],
            uv0, uv1, uv2,
            sb[shape_of_tri][:, None], se[shape_of_tri][:, None],
            shape_of_tri[:, None], sf[shape_of_tri][:, None],
            (uv_area2 / np.maximum(area2, 1e-20))[:, None],
            (e2uv[:, 1:2] * e1w - e1uv[:, 1:2] * e2w) * inv_det[:, None],
            (-e2uv[:, 0:1] * e1w + e1uv[:, 0:1] * e2w) * inv_det[:, None]]
    if needs_bary:
        # per-vertex colors + triangle heights 2A/|edge_i| with edge_i
        # opposite vertex i — bary_i * h_i = world distance to edge_i
        # (wireframe's edge test needs only these 3 scalars)
        cols += [vcolors[idxp[:, 0]], vcolors[idxp[:, 1]],
                 vcolors[idxp[:, 2]]]
        v0w = np.asarray(tris.v0, np.float32)
        p1w = v0w + e1w
        p2w = v0w + e2w
        for (ea, eb) in ((p1w, p2w), (p2w, v0w), (v0w, p1w)):
            elen = np.linalg.norm(eb - ea, axis=-1)
            cols.append((area2 / np.maximum(elen, 1e-20))[:, None])
    tri_shade = np.concatenate(
        [np.asarray(c, np.float32) for c in cols], axis=1)
    tri_shade[~valid_slot] = 0.0
    tri_shade[~valid_slot, 18:20] = -1.0  # bsdf/emitter ids
    return tri_shade


def compile_scene(desc: SceneDesc,
                  overrides: Optional[Dict[str, Any]] = None):
    """SceneDesc -> (SceneData numpy pytree, RenderSettings).

    The caller moves SceneData to a device with scene/bridge.to_torch.
    """
    import time as _time
    from .media import MediaBuilder, medium_node, unnamed_medium
    prep_times: Dict[str, Any] = {}
    _t_mesh0 = _time.time()
    mb = MaterialBuilder()
    medb = MediaBuilder(desc.base_dir)

    all_pos, all_nrm, all_uv, all_idx = [], [], [], []
    all_col = []
    tri_shape, shape_bsdf, shape_emitter, shape_face_n = [], [], [], []
    shape_interior, shape_exterior = [], []

    def _shape_media(shape):
        """(interior_mid, exterior_mid) for a shape Plugin, -1 = vacuum."""
        inner = medium_node(shape, "interior")
        outer = medium_node(shape, "exterior")
        if inner is None and outer is None:
            # unnamed single medium child: Mitsuba binds it as interior
            inner = unnamed_medium(shape)
        return (medb.from_plugin(inner) if inner is not None else -1,
                medb.from_plugin(outer) if outer is not None else -1)
    area_emitters = []  # (shape_id, radiance rgb)
    ana_spheres = []    # (center, radius, material id, shape id)
    v_off = 0

    def _shape_curvature_node(shape):
        """Find a 'curvature' texture anywhere in the shape's BSDF
        subtree (its per-vertex bake happens at mesh-load time)."""
        stack = [v for v in shape.props.values() if hasattr(v, "kind")]
        stack += list(shape.children)
        while stack:
            n = stack.pop()
            if getattr(n, "kind", None) == "texture" and \
                    getattr(n, "type", None) == "curvature":
                return n
            stack += [v for v in getattr(n, "props", {}).values()
                      if hasattr(v, "kind")]
            stack += list(getattr(n, "children", []) or [])
        return None

    def _shape_bsdf_node(shape):
        node = shape.child("bsdf")
        if node is None:
            for v in shape.props.values():
                if isinstance(v, Plugin) and v.kind == "bsdf":
                    return v
        return node

    def _shape_emitter_node(shape):
        node = shape.child("emitter")
        if node is None:
            for v in shape.props.values():
                if isinstance(v, Plugin) and v.kind == "emitter":
                    return v
        return node

    def _shape_sss_node(shape):
        node = shape.child("subsurface")
        if node is None:
            for v in shape.props.values():
                if isinstance(v, Plugin) and v.kind == "subsurface":
                    return v
        return node
    sss_shapes = []  # (shape_id, subsurface Plugin node)

    def _similarity_scale(tw):
        """Uniform scale of a similarity transform, or None."""
        R = np.asarray(tw, np.float64)[:3, :3]
        s = abs(np.linalg.det(R)) ** (1.0 / 3.0)
        if s < 1e-12:
            return None
        Q = R / s
        if np.max(np.abs(Q @ Q.T - np.eye(3))) > 1e-4:
            return None
        return s

    expanded = _expand_instances(desc.shapes)

    def _is_analytic_sphere(shape):
        # subsurface attachments need triangles for irradiance-sample
        # placement, so SSS spheres stay tessellated; curvature textures
        # need the mesh one-ring for their per-vertex bake
        return (shape.type == "sphere" and
                _shape_emitter_node(shape) is None and
                _shape_sss_node(shape) is None and
                _shape_curvature_node(shape) is None and
                _similarity_scale(shape.get("toWorld", np.eye(4)))
                is not None)

    # analytic spheres need triangle geometry to exist alongside them
    # (film/BVH plumbing assumes a non-empty soup); all-sphere scenes
    # fall back to tessellation
    any_tris = any(not _is_analytic_sphere(s) for s in expanded)

    _mesh_memo: Dict[Any, Any] = {}
    for s_id, shape in enumerate(expanded):
        if any_tris and _is_analytic_sphere(shape):
            tw = np.asarray(shape.get("toWorld", np.eye(4)), np.float64)
            c = np.asarray(shape.get("center", np.zeros(3)), np.float64)
            c = cm.transform_point(tw, c[None])[0]
            r = float(shape.get("radius", 1.0)) * _similarity_scale(tw)
            bnode = _shape_bsdf_node(shape)
            mid = mb.from_plugin(bnode) if bnode is not None \
                else mb.default_id()
            ana_spheres.append((c.astype(np.float32), np.float32(r),
                                mid, s_id))
            shape_bsdf.append(mid)
            shape_emitter.append(-1)
            shape_face_n.append(False)
            im, em = _shape_media(shape)
            shape_interior.append(im)
            shape_exterior.append(em)
            continue
        mkey = shape.props.get("_mesh_key")
        if mkey is not None and mkey in _mesh_memo:
            mesh = _mesh_memo[mkey]
        else:
            with stats.span("tessellate"):
                mesh = _shape_mesh(shape, desc.base_dir)
            if mkey is not None:
                _mesh_memo[mkey] = mesh
        to_world = shape.get("toWorld", np.eye(4))
        pos = cm.transform_point(
            np.asarray(to_world, np.float64), mesh.positions.astype(np.float64))
        inv = np.linalg.inv(np.asarray(to_world, np.float64))
        use_face_n = mesh.normals is None
        if mesh.normals is not None:
            nrm = mesh.normals.astype(np.float64) @ inv[:3, :3]
            nlen = np.linalg.norm(nrm, axis=-1, keepdims=True)
            nrm = nrm / np.maximum(nlen, 1e-20)
        else:
            nrm = np.zeros_like(pos)
        if bool(shape.get("flipNormals", False)):
            nrm = -nrm
        # winding flip if the transform mirrors (negative determinant)
        idx = mesh.indices.copy()
        if np.linalg.det(np.asarray(to_world, np.float64)[:3, :3]) < 0:
            idx = idx[:, ::-1]
        uv = mesh.uvs if mesh.uvs is not None else np.zeros(
            (len(pos), 2), np.float32)

        # material
        bsdf_node = shape.child("bsdf")
        if bsdf_node is None:
            for v in shape.props.values():
                if isinstance(v, Plugin) and v.kind == "bsdf":
                    bsdf_node = v
                    break
        sss_node = _shape_sss_node(shape)
        if sss_node is not None:
            sss_shapes.append((s_id, sss_node))
        if bsdf_node is not None:
            mid = mb.from_plugin(bsdf_node)
        elif sss_node is not None:
            # BSDF-less subsurface shape: the surface is an absorber and
            # ALL outgoing light comes from the diffusion term
            # (dipole.cpp with no BSDF attached)
            mid = mb.add_row(kind=0, reflectance=(0.0, 0.0, 0.0))
        else:
            mid = mb.default_id()

        # area emitter?
        em_node = shape.child("emitter")
        e_id = -1
        if em_node is not None:
            if em_node.type != "area":
                raise ValueError(
                    f"shape-attached emitter '{em_node.type}' not supported")
            e_id = len(area_emitters)
            area_emitters.append(
                (s_id, spectrum_value(em_node.get("radiance"), (1, 1, 1))))

        all_pos.append(pos.astype(np.float32))
        all_nrm.append(nrm.astype(np.float32))
        all_uv.append(uv.astype(np.float32))
        curv_node = _shape_curvature_node(shape)
        if curv_node is not None:
            # curvature texture (src/textures/curvature.cpp): bake the
            # per-vertex estimate into the vertex-color channel this
            # shape's TEX_VERTEXCOLOR row reads (positive -> red,
            # negative -> blue, like the reference's visualization)
            from .meshes import vertex_curvature
            c = vertex_curvature(
                pos.astype(np.float32), idx,
                str(curv_node.get("curvature", "mean")))
            col = np.zeros((len(pos), 3), np.float32)
            col[:, 0] = np.maximum(c, 0.0)
            col[:, 2] = np.maximum(-c, 0.0)
            all_col.append(col)
        elif mesh.colors is not None:
            all_col.append(mesh.colors.astype(np.float32))
        else:
            all_col.append(np.ones((len(pos), 3), np.float32))
        all_idx.append(idx.astype(np.int32) + v_off)
        tri_shape.append(np.full(len(idx), s_id, np.int32))
        shape_bsdf.append(mid)
        shape_emitter.append(e_id)
        shape_face_n.append(use_face_n or bool(shape.get("faceNormals", False)))
        im, em = _shape_media(shape)
        shape_interior.append(im)
        shape_exterior.append(em)
        v_off += len(pos)

    if not all_pos:
        raise ValueError("scene contains no shapes")
    positions = np.concatenate(all_pos)
    normals = np.concatenate(all_nrm)
    uvs = np.concatenate(all_uv)
    indices = np.concatenate(all_idx)
    vcolors = np.concatenate(all_col)
    tri_shape = np.concatenate(tri_shape)
    prep_times["mesh"] = _time.time() - _t_mesh0

    # --- BVH over all triangles -------------------------------------------
    # Built (or loaded from the disk cache keyed by geometry hash) by
    # scene/prep_cache.py: BVH, cluster decomposition, padded
    # cluster-major layout, traversal slabs, linear-MT table.
    p0 = positions[indices[:, 0]]
    p1 = positions[indices[:, 1]]
    p2 = positions[indices[:, 2]]
    T = len(p0)
    # cluster decomposition for the TPU traversal; window grows with the
    # scene so K stays bounded (phase-1 cost is O(N*K))
    import os as _os
    _tgt = _os.environ.get("GDMT_CLUSTER_TARGET")
    if _tgt:
        target = int(_tgt)
    else:
        # window capped at 256: beyond that the in-kernel [RBLK, 4W]
        # matmul epilogue exceeds the VMEM budget.  Large scenes instead
        # grow K; the supercluster worklist build (ops/pallas_trace.py)
        # is O(N*S) with S = K/SUPER_FACTOR, so the XLA-side cull scales
        # to multi-million-triangle scenes.
        # cap 128: the in-kernel epilogue + matmul cost per pending
        # cluster is linear in the window, and per-ray pending counts
        # grow sublinearly as windows shrink (the reference's choice for
        # its 3M-tri forest scene)
        target = int(np.clip(-(-T // 1024), 64, 128)) if T > 64 \
            else max(T, 1)
    from . import prep_cache
    with stats.span("geometry"):
        geo = prep_cache.load_or_build(p0, p1, p2, target, prep_times)
    window = int(geo["window"])
    order = np.asarray(geo["order"])
    psel = np.asarray(geo["psel"])
    valid_slot = np.asarray(geo["valid_slot"])
    K = len(geo["c_off"])

    tris = TriSoup(v0=geo["v0"], e1=geo["e1"], e2=geo["e2"],
                   orig_id=geo["orig_id"])
    clusters = ClusterArrays(
        bmin=geo["c_min"], bmax=geo["c_max"],
        offset=(np.arange(K, dtype=np.int32) * window))
    # tri9 feeds only the reference's v2 comparison kernel; it grows
    # with the soup (16 floats per slot), so it is capped at 2M tris
    tri9 = geo["tri9"] if T <= 2_000_000 else np.zeros((1, 16, 4),
                                                       np.float32)

    # packed shading rows — computed DIRECTLY in the padded cluster-major
    # layout (one fused [Tp] gather per attribute; the previous
    # build-in-original-order-then-permute form cost two full [T, 29]
    # permute copies plus 29 strided column writes)
    _t_shade0 = _time.time()
    from .materials import IRAWAN as _IRAWAN
    needs_bary = (any(n.type in ("vertexcolors", "wireframe", "curvature")
                      for n in mb.texture_nodes) or
                  any(r["kind"] == _IRAWAN for r in mb.rows))
    sb = np.asarray(shape_bsdf, np.int32)
    se = np.asarray(shape_emitter, np.int32)
    sf = np.asarray(shape_face_n, bool)

    def _build_tri_shade():
        return _pack_tri_shade(tris, order, psel, valid_slot, indices,
                               normals, uvs, vcolors, tri_shape,
                               sb, se, sf, needs_bary)

    _geo_key = prep_times.get("geom_key")
    with stats.span("shade_table"):
        if _geo_key is not None:
            _shade_key = prep_cache.hash_arrays(
                indices, normals, uvs, vcolors if needs_bary else None,
                tri_shape, sb, se, sf,
                extra=f"{_geo_key}|bary={needs_bary}|shade-v1")
            tri_shade = prep_cache.load_or_build_array(
                _shade_key, _build_tri_shade, T, prep_times, tag="shade")
        else:
            tri_shade = _build_tri_shade()
    prep_times["shade"] = _time.time() - _t_shade0
    bvh_arrays = BVHArrays(
        child0_min=geo["tree_c0min"], child0_max=geo["tree_c0max"],
        child1_min=geo["tree_c1min"], child1_max=geo["tree_c1max"],
        child0=geo["tree_c0"], child1=geo["tree_c1"])

    # linear-MT coefficient table (small scenes) / per-cluster traversal
    # slabs (large scenes) — built by prep_cache alongside the BVH.
    linC = geo["linC"]
    mt_slabs = geo["mt_slabs"]

    if ana_spheres:
        sph_center = np.stack([a[0] for a in ana_spheres])
        sph_radius = np.asarray([a[1] for a in ana_spheres], np.float32)
        sph_bsdf = np.asarray([a[2] for a in ana_spheres], np.int32)
        sph_shape = np.asarray([a[3] for a in ana_spheres], np.int32)
    else:
        sph_center = np.zeros((0, 3), np.float32)
        sph_radius = np.zeros(0, np.float32)
        sph_bsdf = np.zeros(0, np.int32)
        sph_shape = np.zeros(0, np.int32)

    geom = Geometry(
        tris=tris, bvh=bvh_arrays, clusters=clusters,
        tri9=tri9, cbounds=geo["cbounds"],
        linC=linC, mt_slabs=mt_slabs,
        tri_shade=tri_shade,
        positions=positions, normals=normals,
        uvs=uvs, indices=indices, tri_shape=tri_shape,
        shape_bsdf=np.asarray(shape_bsdf, np.int32),
        shape_emitter=np.asarray(shape_emitter, np.int32),
        shape_use_face_normals=np.asarray(shape_face_n, bool),
        sph_center=sph_center, sph_radius=sph_radius,
        sph_bsdf=sph_bsdf, sph_shape=sph_shape,
        shape_interior=np.asarray(shape_interior, np.int32),
        shape_exterior=np.asarray(shape_exterior, np.int32))

    # --- emitter tables ----------------------------------------------------
    emitters = _build_emitters(desc, area_emitters, tri_shape, p0, p1, p2)

    # --- camera + film ------------------------------------------------------
    camera, settings = _build_sensor(desc)
    settings.stack_depth = 2 * int(geo["tree_depth"]) + 4
    settings.prep_times = prep_times
    settings.cluster_window = window
    settings.num_emitters = len(area_emitters)
    settings.env_kind = int(emitters.env_kind)
    settings.has_env = settings.env_kind != 0
    settings.n_delta = int((np.asarray(emitters.delta_intensity).sum(-1)
                            > 0).sum())

    # --- integrator ---------------------------------------------------------
    integ = desc.integrator
    if integ is not None:
        settings.integrator = integ.type
        settings.integrator_props = dict(integ.props)
        settings.max_depth = int(integ.get("maxDepth", -1))
        settings.rr_depth = int(integ.get("rrDepth", 5))
        settings.strict_normals = bool(integ.get("strictNormals", False))
        # nested integrators (multichannel.cpp children, adaptive.cpp's
        # wrapped integrator): (type, props) pairs — host-only config
        settings.integrator_children = [
            (c.type, dict(c.props)) for c in integ.children
            if c.kind == "integrator"]
        if settings.integrator == "adaptive" and \
                settings.integrator_children:
            # adaptive wraps a child integrator; inherit its depth knobs
            ct, cp = settings.integrator_children[0]
            settings.max_depth = int(cp.get("maxDepth",
                                            settings.max_depth))
            settings.rr_depth = int(cp.get("rrDepth", settings.rr_depth))

    if overrides:
        for k, v in overrides.items():
            # coerce to the field's declared type so string values (CLI,
            # tests) cannot poison static shapes downstream
            cur = getattr(settings, k, None)
            if cur is not None and not isinstance(v, type(cur)):
                v = type(cur)(v)
            setattr(settings, k, v)

    scene_lo = np.minimum(np.minimum(p0, p1), p2).min(0)
    scene_hi = np.maximum(np.maximum(p0, p1), p2).max(0)
    extent = float(np.linalg.norm(scene_hi - scene_lo))
    textures = build_table(mb.texture_nodes, desc.base_dir)
    from ..ops.texture import TEX_WIREFRAME as _TEX_WIRE
    if any(int(k) == _TEX_WIRE and gwv == 0.0
           for k, gwv in zip(textures.kind, textures.grid_width)):
        # wireframe lineWidth auto default: 10% of the mean edge length
        # (wireframe.cpp computes this per-mesh; scene-wide mean here)
        mean_edge = float(np.mean([np.linalg.norm(p1 - p0, axis=-1),
                                   np.linalg.norm(p2 - p1, axis=-1),
                                   np.linalg.norm(p0 - p2, axis=-1)]))
        gw = np.where((textures.kind == _TEX_WIRE) &
                      (textures.grid_width == 0.0),
                      np.float32(0.1 * mean_edge), textures.grid_width)
        textures = textures._replace(grid_width=gw.astype(np.float32))
    # bitmask: bit 0 = any textures bound; bit 1 = textured mask opacity;
    # bit 2 = blend BSDFs present; bit 3 = textured blend weight
    # (ops/common.material_params gates the extra gathers on these)
    from .materials import BLEND as _BLEND, COATING as _COATING
    from .materials import IRAWAN as _IRW
    settings.has_textures = (
        (1 if mb.texture_nodes else 0) |
        (2 if any(r.get("tex_opacity", -1) >= 0 for r in mb.rows) else 0) |
        (4 if any(r["kind"] in (_BLEND, _COATING) for r in mb.rows)
         else 0) |
        (8 if any(r.get("tex_blend", -1) >= 0 for r in mb.rows) else 0) |
        (16 if any(r["kind"] == _IRW for r in mb.rows) else 0))
    # anisotropic texture filtering (bitmap filterType "ewa", the
    # Mitsuba default): primary hits carry a footprint ellipse
    settings.has_ewa = any(
        n.type == "bitmap" and
        str(n.get("filterType", "ewa")).lower() == "ewa"
        for n in mb.texture_nodes)
    # --- participating media ------------------------------------------------
    if desc.sensor is not None:
        snode = (medium_node(desc.sensor, "exterior") or
                 unnamed_medium(desc.sensor))
        if snode is not None:
            settings.sensor_medium = medb.from_plugin(snode)
    media = medb.finalize()
    settings.has_media = len(medb.rows) > 0
    settings.has_het_media = any(r[4] for r in medb.rows)

    sss = None
    if sss_shapes:
        sss, sss_props = _build_sss(sss_shapes, len(shape_bsdf),
                                    tri_shape, p0, p1, p2)
        settings.has_sss = True
        settings.sss_props = sss_props

    scene = SceneData(
        geom=geom, materials=mb.finalize(), emitters=emitters, camera=camera,
        textures=textures,
        ray_eps=np.float32(max(extent, 1e-3) * 1e-4),
        media=media, sss=sss)
    prep_times["total"] = _time.time() - _t_mesh0
    return scene, settings


def _build_emitters(desc, area_emitters, tri_shape, p0, p1, p2):
    E = len(area_emitters)
    tri_areas = 0.5 * np.linalg.norm(
        np.cross(p1 - p0, p2 - p0), axis=-1)

    radiance = np.zeros((max(E, 1), 3), np.float32)
    shape_ids = np.zeros(max(E, 1), np.int32)
    offs, cnts, cdfs, tidx, totals = [], [], [], [], []
    off = 0
    for e, (s_id, rad) in enumerate(area_emitters):
        radiance[e] = rad
        shape_ids[e] = s_id
        ids = np.nonzero(tri_shape == s_id)[0].astype(np.int32)
        a = tri_areas[ids]
        total = float(a.sum())
        cdf = np.cumsum(a) / max(total, 1e-30)
        offs.append(off); cnts.append(len(ids))
        cdfs.append(cdf.astype(np.float32)); tidx.append(ids)
        totals.append(total)
        off += len(ids)
    if E == 0:
        offs, cnts, totals = [0], [0], [1.0]
        cdfs, tidx = [np.ones(1, np.float32)], [np.zeros(1, np.int32)]

    # scene-level delta emitters
    dk, dp, dd, di, dct, dcf = [], [], [], [], [], []
    for em in desc.emitters:
        if em.type == "collimated":
            # collimated.cpp: zero-radius beam at toWorld origin along
            # its +z axis; 'power' is the beam's radiant power
            to_world = np.asarray(em.get("toWorld", np.eye(4)), np.float64)
            dk.append(3)
            dp.append(to_world[:3, 3])
            dz = to_world[:3, 2]
            dd.append(dz / np.linalg.norm(dz))
            di.append(spectrum_value(em.get("power"), (1, 1, 1)))
            dct.append(-1.0); dcf.append(-1.0)
            continue
        if em.type in ("point", "spot", "directional"):
            to_world = np.asarray(em.get("toWorld", np.eye(4)), np.float64)
            if em.type == "point":
                dk.append(0)
                pos = em.get("position")
                pos = (np.asarray(pos, np.float64) if pos is not None
                       else to_world[:3, 3])
                dp.append(pos)
                dd.append((0, 0, 1))
                di.append(spectrum_value(em.get("intensity"), (1, 1, 1)))
                dct.append(-1.0); dcf.append(-1.0)
            elif em.type == "spot":
                dk.append(1)
                dp.append(to_world[:3, 3])
                dd.append(to_world[:3, 2] / np.linalg.norm(to_world[:3, 2]))
                di.append(spectrum_value(em.get("intensity"), (1, 1, 1)))
                cut = float(em.get("cutoffAngle", 20.0))
                beam = float(em.get("beamWidth", cut * 0.75))
                dct.append(np.cos(np.deg2rad(cut)))
                dcf.append(np.cos(np.deg2rad(beam)))
            else:  # directional
                dk.append(2)
                dp.append((0, 0, 0))
                dv = em.get("direction")
                if dv is None:
                    dv = to_world[:3, 2]
                dv = np.asarray(dv, np.float64)
                dd.append(dv / np.linalg.norm(dv))
                di.append(spectrum_value(em.get("irradiance"), (1, 1, 1)))
                dct.append(-1.0); dcf.append(-1.0)
    n_delta = len(dk)
    if n_delta == 0:
        dk, dp, dd = [0], [(0, 0, 0)], [(0, 0, 1)]
        di, dct, dcf = [(0, 0, 0)], [-1.0], [-1.0]

    # scene-level environment emitter
    env_kind = 0
    env_rad = np.zeros(3, np.float32)
    env_to_world = np.eye(4, dtype=np.float32)
    env_map = np.zeros((1, 1, 3), np.float32)
    for em in desc.emitters:
        if em.type == "constant":
            env_kind = 1
            env_rad = spectrum_value(em.get("radiance"), (1, 1, 1))
        elif em.type == "envmap":
            env_kind = 2
            from ..utils import exr as exr_mod
            path = os.path.join(desc.base_dir, em.get("filename"))
            if path.lower().endswith(".exr"):
                env_map = exr_mod.read_rgb(path).astype(np.float32)
            else:
                from PIL import Image
                img = np.asarray(Image.open(path).convert("RGB"),
                                 np.float32) / 255.0
                env_map = (img ** 2.2).astype(np.float32)
            env_rad = spectrum_value(em.get("scale", 1.0), (1, 1, 1))
            env_to_world = np.asarray(
                em.get("toWorld", np.eye(4)), np.float32)
        elif em.type in ("sun", "sky", "sunsky"):
            # Preetham model baked to the standard envmap grid on the
            # host (scene/sunsky.py); device-side sampling/eval is the
            # shared envmap path
            from . import sunsky as sunsky_mod
            env_kind = 2
            env_map = sunsky_mod.bake(em.type, em)
            env_rad = np.ones(3, np.float32)
            env_to_world = np.asarray(
                em.get("toWorld", np.eye(4)), np.float32)
        elif em.type == "collimated":
            pass  # delta table above

    He, We = env_map.shape[:2]
    # luminance-weighted, sin(theta)-weighted 2D CDF for envmap sampling
    lum = env_map @ np.array([0.212671, 0.715160, 0.072169], np.float32)
    theta = (np.arange(He) + 0.5) / He * np.pi
    w = lum * np.sin(theta)[:, None] + 1e-12
    row_sums = w.sum(1)
    cdf_rows = np.concatenate([[0.0], np.cumsum(row_sums)])
    cdf_rows = (cdf_rows / cdf_rows[-1]).astype(np.float32)
    cdf_cols = np.concatenate(
        [np.zeros((He, 1)), np.cumsum(w, 1)], axis=1)
    cdf_cols = (cdf_cols / cdf_cols[:, -1:]).astype(np.float32)
    # solid-angle pdf per texel: p(w) = w / (sum * texel_solid_angle)
    texel_sa = (2 * np.pi / We) * (np.pi / He) * np.sin(theta)[:, None]
    env_pdf = (w / w.sum() / np.maximum(texel_sa, 1e-12)).astype(np.float32)

    flat_ids = np.concatenate(tidx).astype(np.int64)
    if len(p0) > 0:
        g0 = p0[flat_ids]
        ge1 = p1[flat_ids] - g0
        ge2 = p2[flat_ids] - g0
        gng = np.cross(ge1, ge2)
        gng = gng / np.maximum(np.linalg.norm(gng, axis=-1, keepdims=True),
                               1e-30)
        tri_geo = np.concatenate([g0, ge1, ge2, gng], 1).astype(np.float32)
    else:
        tri_geo = np.zeros((len(flat_ids), 12), np.float32)

    return EmitterTable(
        tri_geo=tri_geo,
        delta_kind=np.asarray(dk, np.int32),
        delta_pos=np.asarray(dp, np.float32),
        delta_dir=np.asarray(dd, np.float32),
        delta_intensity=np.asarray(di, np.float32),
        delta_cos_total=np.asarray(dct, np.float32),
        delta_cos_falloff=np.asarray(dcf, np.float32),
        radiance=radiance, shape=shape_ids,
        tri_offset=np.asarray(offs, np.int32),
        tri_count=np.asarray(cnts, np.int32),
        tri_cdf=np.concatenate(cdfs).astype(np.float32),
        tri_index=np.concatenate(tidx).astype(np.int32),
        total_area=np.asarray(totals, np.float32),
        env_kind=np.int32(env_kind), env_radiance=env_rad.astype(np.float32),
        env_to_world=env_to_world.astype(np.float32),
        env_world_to_local=np.linalg.inv(env_to_world).astype(np.float32),
        env_map=env_map, env_cdf_rows=cdf_rows, env_cdf_cols=cdf_cols,
        env_pdf=env_pdf)


# Jensen et al. 2001 measured media (the reference ships these as its
# material LUT, src/libcore/sse/ssemath-adjacent data/materials.h via
# lookupMaterial in dipole.cpp): REDUCED scattering sigma_s' and sigma_a
# in 1/mm, relative IOR.  Stored with g=0 since sigma_s' already folds
# the asymmetry (similarity relation).
SSS_MATERIALS = {
    "apple":     ((2.29, 2.39, 1.97), (0.0030, 0.0034, 0.046), 1.3),
    "chicken1":  ((0.15, 0.21, 0.38), (0.015, 0.077, 0.19), 1.3),
    "chicken2":  ((0.19, 0.25, 0.32), (0.018, 0.088, 0.20), 1.3),
    "cream":     ((7.38, 5.47, 3.15), (0.0002, 0.0028, 0.0163), 1.3),
    "ketchup":   ((0.18, 0.07, 0.03), (0.061, 0.97, 1.45), 1.3),
    "marble":    ((2.19, 2.62, 3.00), (0.0021, 0.0041, 0.0071), 1.5),
    "potato":    ((0.68, 0.70, 0.55), (0.0024, 0.0090, 0.12), 1.3),
    "skimmilk":  ((0.70, 1.22, 1.90), (0.0014, 0.0025, 0.0142), 1.3),
    "wholemilk": ((2.55, 3.21, 3.77), (0.0011, 0.0024, 0.014), 1.3),
    "skin1":     ((0.74, 0.88, 1.01), (0.032, 0.17, 0.48), 1.3),
    "skin2":     ((1.09, 1.59, 1.79), (0.013, 0.070, 0.145), 1.3),
}


def _build_sss(sss_shapes, n_shapes, tri_shape, p0, p1, p2):
    """SSSTable from (shape_id, <subsurface> node) pairs.

    Per-row medium parameters follow dipole.cpp's property set: either a
    `material` preset (Jensen 2001 table above), or explicit sigmaS/
    sigmaA (world units already reduced via g), or sigmaT+albedo; all
    scaled by `scale`.  The per-row triangle area CDF places irradiance
    samples uniformly over the attached surface (the analog of the
    reference's blue-noise sample_placement in subsurface preprocess)."""
    tri_areas = 0.5 * np.linalg.norm(np.cross(p1 - p0, p2 - p0), axis=-1)
    R = len(sss_shapes)
    sig_s = np.zeros((R, 3), np.float32)
    sig_a = np.zeros((R, 3), np.float32)
    gs = np.zeros(R, np.float32)
    etas = np.ones(R, np.float32)
    rows_shape = np.zeros(R, np.int32)
    shape_sss = np.full(n_shapes, -1, np.int32)
    offs, cnts, cdfs, tidx, totals = [], [], [], [], []
    off = 0
    n_points = 0
    irr_samples = 0
    for r, (s_id, node) in enumerate(sss_shapes):
        scale = float(node.get("scale", 1.0))
        mat = node.get("material")
        if mat is not None and str(mat) in SSS_MATERIALS:
            ss, sa, eta = SSS_MATERIALS[str(mat)]
            ss, sa = np.asarray(ss, np.float32), np.asarray(sa, np.float32)
            g = 0.0
        else:
            ss_v = node.get("sigmaS")
            sa_v = node.get("sigmaA")
            if ss_v is None and node.get("sigmaT") is not None:
                st_v = spectrum_value(node.get("sigmaT"), (1, 1, 1))
                al_v = spectrum_value(node.get("albedo"), (0.8, 0.8, 0.8))
                ss, sa = st_v * al_v, st_v * (1.0 - al_v)
            else:
                ss = spectrum_value(ss_v, SSS_MATERIALS["skin1"][0])
                sa = spectrum_value(sa_v, SSS_MATERIALS["skin1"][1])
            g = float(node.get("g", 0.0))
            eta = None
        int_ior = node.get("intIOR")
        ext_ior = float(node.get("extIOR", 1.000277))
        if int_ior is not None:
            eta = float(int_ior) / ext_ior
        elif eta is None:
            eta = 1.3
        sig_s[r] = np.asarray(ss, np.float32) * scale
        sig_a[r] = np.asarray(sa, np.float32) * scale
        gs[r] = g
        etas[r] = eta
        rows_shape[r] = s_id
        shape_sss[s_id] = r
        n_points = max(n_points, int(node.get("samples", 2048)))
        irr_samples = max(irr_samples, int(node.get("irrSamples", 16)))

        ids = np.nonzero(tri_shape == s_id)[0].astype(np.int32)
        if len(ids) == 0:
            ids = np.zeros(1, np.int32)
        a = np.maximum(tri_areas[ids].astype(np.float64), 1e-30)
        total = float(a.sum())
        cdf = np.cumsum(a) / total
        cdf[-1] = 1.0
        offs.append(off); cnts.append(len(ids))
        cdfs.append(cdf.astype(np.float32)); tidx.append(ids)
        totals.append(total)
        off += len(ids)

    table = SSSTable(
        sigma_s=sig_s, sigma_a=sig_a, g=gs, eta=etas,
        shape=rows_shape, shape_sss=shape_sss,
        tri_offset=np.asarray(offs, np.int32),
        tri_count=np.asarray(cnts, np.int32),
        tri_cdf=np.concatenate(cdfs).astype(np.float32),
        tri_index=np.concatenate(tidx).astype(np.int32),
        total_area=np.asarray(totals, np.float32))
    return table, {"samples": n_points, "irr_samples": irr_samples}


def _build_sensor(desc):
    settings = RenderSettings()
    sensor = desc.sensor
    to_world = np.eye(4)
    fov = 45.0
    near, far = 1e-2, 1e4
    aperture, focus = 0.0, 1.0
    ortho = False
    kind = 0.0
    kc = np.zeros(2, np.float32)
    if sensor is not None:
        to_world = np.asarray(sensor.get("toWorld", np.eye(4)), np.float64)
        film = sensor.child("film")
        if film is not None:
            settings.width = int(film.get("width", 768))
            settings.height = int(film.get("height", 576))
            rf = film.child("rfilter")
            if rf is not None:
                settings.rfilter = rf.type
            settings.banner = bool(film.get("banner", False))
        sampler = sensor.child("sampler")
        if sampler is not None:
            settings.sampler = sampler.type
            settings.spp = int(sampler.get("sampleCount", 16))
        near = float(sensor.get("nearClip", 1e-2))
        far = float(sensor.get("farClip", 1e4))
        if sensor.type in ("perspective", "thinlens", "perspective_rdist"):
            fov = _resolve_fov(sensor, settings.width, settings.height)
            if sensor.type == "thinlens":
                aperture = float(sensor.get("apertureRadius", 0.0))
                focus = float(sensor.get("focusDistance", 1.0))
            if sensor.type == "perspective_rdist":
                # perspective_rdist.cpp: comma/space-separated polynomial
                # coefficients (Zhang's model, 2 terms honored)
                raw = str(sensor.get("kc", "0, 0")).replace(",", " ")
                vals = [float(v) for v in raw.split()]
                vals = (vals + [0.0, 0.0])[:2]
                kc = np.asarray(vals, np.float32)
        elif sensor.type in ("orthographic", "telecentric"):
            ortho = True
            if sensor.type == "telecentric":
                aperture = float(sensor.get("apertureRadius", 0.0))
                focus = float(sensor.get("focusDistance", 1.0))
        elif sensor.type in ("spherical", "radiancemeter", "fluencemeter"):
            kind = {"spherical": 2.0, "radiancemeter": 3.0,
                    "fluencemeter": 4.0}[sensor.type]
        elif sensor.type is not None and sensor.type != "":
            raise ValueError(f"sensor '{sensor.type}' not yet supported")
    settings.fov_x_deg = fov

    aspect = settings.width / settings.height
    if ortho:
        # src/sensors/orthographic.cpp: parallel projection, the world
        # extent of the film comes entirely from toWorld's scale
        proj = np.eye(4)
        proj[2, 2] = 1.0 / (far - near)
        proj[2, 3] = -near / (far - near)
    else:
        proj = cm.np_perspective(fov, near, far)
    # Mitsuba perspective.cpp: cameraToSample =
    #   scale(-0.5, -0.5*aspect, 1) * translate(-1, -1/aspect, 0) * proj
    cam_to_sample = (cm.np_scale([-0.5, -0.5 * aspect, 1.0])
                     @ cm.np_translate([-1.0, -1.0 / aspect, 0.0])
                     @ proj)
    sample_to_cam = np.linalg.inv(cam_to_sample)
    camera = Camera(
        to_world=to_world.astype(np.float32),
        world_to_camera=np.linalg.inv(to_world).astype(np.float32),
        sample_to_camera=sample_to_cam.astype(np.float32),
        camera_to_sample=cam_to_sample.astype(np.float32),
        aperture_radius=np.float32(aperture),
        focus_distance=np.float32(focus),
        kind=np.float32(1.0 if ortho else kind),
        kc=kc)
    return camera, settings


def _resolve_fov(sensor, width, height):
    fov = float(sensor.get("fov", 45.0))
    axis = sensor.get("fovAxis", "x")
    aspect = width / height
    if axis == "x":
        return fov
    if axis == "y":
        return np.rad2deg(2 * np.arctan(np.tan(np.deg2rad(fov) / 2) * aspect))
    if axis == "smaller":
        return fov if aspect >= 1 else np.rad2deg(
            2 * np.arctan(np.tan(np.deg2rad(fov) / 2) * aspect))
    if axis == "larger":
        return fov if aspect <= 1 else np.rad2deg(
            2 * np.arctan(np.tan(np.deg2rad(fov) / 2) * aspect))
    if axis == "diagonal":
        d = np.sqrt(1 + 1 / aspect ** 2)
        return np.rad2deg(2 * np.arctan(np.tan(np.deg2rad(fov) / 2) / d))
    return fov


def load_scene(path, variables=None, overrides=None):
    """Convenience: XML file -> (SceneData, RenderSettings)."""
    import time as _time
    from . import xml_loader
    with stats.span("load_scene"):
        t0 = _time.time()
        with stats.span("parse"):
            desc = xml_loader.load(path, variables)
        parse_s = _time.time() - t0
        scene, settings = compile_scene(desc, overrides)
    settings.prep_times["parse"] = parse_s
    return scene, settings
