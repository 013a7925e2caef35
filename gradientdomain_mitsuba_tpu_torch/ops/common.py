"""Scene-level intersection wrappers: traversal + hit-record fill.

Counterpart of gradientdomain_mitsuba_tpu/ops/common.py (Scene::
rayIntersect + Shape::fillIntersectionRecord, src/librender/scene.cpp,
shape.cpp, trimesh.cpp): traversal returns (t, u, v, prim); this module
gathers vertex attributes and material/emitter ids into the flat
Intersection record every integrator uses.

Ported: the small-scene (<= 2048 triangles) traversal through the sweep
kernels, the large-scene traversal through the pair kernels (or, under
GDMT_KERNEL=v4, the v4 block kernels), analytic spheres merged by
closest t (their exact normals and lat-long uv in the hit fill), the
material gather with reflectance textures and the blend / coating
wrappers' child rows (has_textures bits 0 and 2), the primary hits' uv
footprint, and the hit fill without the barycentric payload or normal
perturbation.  Textured opacity and blend weights (bits 1 and 3, item
13) and woven cloth (bit 4, item 12) raise.  The reference's one-hot
matmul gather (fast_row_gather) is a TPU workaround; here it is plain
indexing.
"""
from __future__ import annotations

import math
import os

import torch

from ..core import math as m
from ..core.records import Intersection
from . import intersect as isec
from . import sweep, trace

BRUTE_FORCE_MAX_TRIS = 2048


# prim-id namespace for analytic spheres (above any padded triangle count)
SPHERE_PRIM_BASE = 1 << 28


def add_sphere_intersections(closest_tri, occl_tri):
    """Merge analytic-sphere hits (intersect.intersect_spheres) into the
    triangle traversal by closest t: the sphere test runs with the
    triangle hit's t as its maxt, so a sphere hit is the nearer one.
    Scenes without analytic spheres pass straight through."""

    def closest(o, d, mint, maxt, geom):
        hit = closest_tri(o, d, mint, maxt, geom)
        if geom.sph_center.shape[0] == 0:
            return hit
        tri_t = torch.where(hit.valid, hit.t, maxt)
        ts, sid = isec.intersect_spheres(o, d, mint, tri_t,
                                         geom.sph_center, geom.sph_radius)
        sph = sid >= 0
        return isec.Hit(
            t=torch.where(sph, ts, hit.t),
            u=torch.where(sph, 0.0, hit.u),
            v=torch.where(sph, 0.0, hit.v),
            prim=torch.where(sph, SPHERE_PRIM_BASE + sid, hit.prim),
            valid=hit.valid | sph)

    def occluded(o, d, mint, maxt, geom):
        occ = occl_tri(o, d, mint, maxt, geom)
        if geom.sph_center.shape[0] == 0:
            return occ
        return occ | isec.occluded_spheres(o, d, mint, maxt,
                                           geom.sph_center, geom.sph_radius)

    closest.kernel = getattr(closest_tri, "kernel", None)
    occluded.kernel = getattr(occl_tri, "kernel", None)
    return closest, occluded


def choose_intersector(settings, n_tris: int, n_clusters: int = 0):
    """Returns (closest, occluded) with signature (o, d, mint, maxt, geom).

    Scenes of at most BRUTE_FORCE_MAX_TRIS triangles sweep the whole soup
    (ops/sweep.py: the CUDA kernels on a CUDA tensor, the plain linear-MT
    version on a CPU tensor).  Larger scenes walk the clustered soup with
    the pair kernels (ops/trace.py, the reference's default v7 kernel):
    the CUDA kernels on a CUDA tensor, their plain version on a CPU
    tensor.  GDMT_KERNEL, read here at each call as the reference reads
    it, selects the traversal: "pairs" (the default) the pair kernels,
    any other value the v4 block kernels (make_mt_intersector /
    make_mt_occluder, same tables, same results).  Each returned function
    carries the kernel wrapper it calls as `.kernel` (its `.launches`
    counts launches).

    Deviation: on the CPU the reference walks large scenes with its jnp
    two-level traversal (make_cluster_intersector); the port runs the
    pair kernels' plain version there, as it runs the sweep kernels'
    plain version for small scenes, so the CPU path checks the arithmetic
    the card runs.  The jnp traversals are not ported (ROADMAP Queue 1
    item 11), so a large scene without clusters raises."""
    if n_tris <= BRUTE_FORCE_MAX_TRIS:
        closest_k = sweep.make_sweep_intersector(n_tris)
        occl_k = sweep.make_sweep_occluder(n_tris)

        def closest(o, d, mint, maxt, geom):
            return closest_k(o, d, mint, maxt, geom.linC)

        def occl(o, d, mint, maxt, geom):
            return occl_k(o, d, mint, maxt, geom.linC)
    elif n_clusters > 0:
        if os.environ.get("GDMT_KERNEL", "pairs") == "pairs":
            make_closest = trace.make_pair_intersector
            make_occl = trace.make_pair_occluder
        else:
            make_closest = trace.make_mt_intersector
            make_occl = trace.make_mt_occluder
        closest_k = make_closest(settings.cluster_window, n_clusters)
        occl_k = make_occl(settings.cluster_window, n_clusters)

        def closest(o, d, mint, maxt, geom):
            return closest_k(o, d, mint, maxt, geom.mt_slabs, geom.cbounds)

        def occl(o, d, mint, maxt, geom):
            return occl_k(o, d, mint, maxt, geom.mt_slabs, geom.cbounds)
    else:
        raise NotImplementedError(
            "large scene without clusters (jnp cluster traversal): "
            "ROADMAP Queue 1 item 11")
    closest.kernel = closest_k
    occl.kernel = occl_k
    return add_sphere_intersections(closest, occl)


def instrument_intersectors(tracer, closest, occluded):
    """Wrap the intersectors with a device-side ray counter: while
    `tracer.ray_tally` is a tensor, every traversal call adds the number
    of lanes with positive extent (maxt > 0; dead wavefront lanes carry
    maxt = -1).  The count stays on the device until the caller reads
    it once at the end."""

    def closest_w(o, d, mint, maxt, geom):
        if tracer.ray_tally is not None:
            tracer.ray_tally += (maxt > 0).sum()
        return closest(o, d, mint, maxt, geom)

    def occluded_w(o, d, mint, maxt, geom):
        if tracer.ray_tally is not None:
            tracer.ray_tally += (maxt > 0).sum()
        return occluded(o, d, mint, maxt, geom)

    return closest_w, occluded_w


def fast_row_gather(table, idx):
    """table[idx] for a [T, C] table and integer idx [...].  The
    reference routes small tables through a one-hot matmul on the TPU,
    where row gathers are latency-bound; on the GPU a gather is the
    fast path, so this is plain indexing."""
    return table[idx.long()]


def fill_intersection(scene, o, d, hit) -> Intersection:
    """Shading data for Hit records via ONE packed-row gather of the
    BVH-ordered tri_shade table (see scene.Geometry)."""
    g = scene.geom
    if scene.materials.packed.shape[1] >= 32:
        raise NotImplementedError(
            "bump/normal maps: ROADMAP Queue 1 item 13")
    if g.tri_shade.shape[-1] >= 41:
        raise NotImplementedError(
            "barycentric payload: ROADMAP Queue 1 item 13")
    prim = torch.clamp(hit.prim, 0, g.tri_shade.shape[0] - 1)
    row = g.tri_shade[prim.long()]     # [N, 29]

    u = hit.u[..., None]
    v = hit.v[..., None]
    w = 1.0 - u - v
    # missed lanes carry t = F32_MAX; an inf position would turn later
    # masked arithmetic into 0*NaN — keep them finite instead
    t_safe = torch.where(hit.valid, hit.t, 1.0)
    p = o + t_safe[..., None] * d
    ng = row[..., 0:3]
    ns = row[..., 3:6] * w + row[..., 6:9] * u + row[..., 9:12] * v
    ns = m.normalize(ns)
    ns_ok = m.squared_length(ns) > 0.5
    use_face_n = row[..., 21] > 0.5
    ns = torch.where((use_face_n | ~ns_ok)[..., None], ng, ns)
    uv = row[..., 12:14] * w + row[..., 14:16] * u + row[..., 16:18] * v

    bsdf_id = row[..., 18].to(torch.int32)
    emitter_id = row[..., 19].to(torch.int32)
    shape_id = row[..., 20].to(torch.int32)

    if g.sph_center.shape[0] > 0:
        # analytic-sphere lanes: exact quadric normals + lat-long uv
        # (z-up, matching meshes.make_sphere / sphere.cpp)
        is_sph = hit.prim >= SPHERE_PRIM_BASE
        sid = torch.clamp(hit.prim - SPHERE_PRIM_BASE, 0,
                          g.sph_center.shape[0] - 1).long()
        cen = g.sph_center[sid]
        rad = g.sph_radius[sid]
        n_s = m.normalize((p - cen) / torch.clamp_min(rad, 1e-12)[..., None])
        theta = torch.arccos(torch.clamp(n_s[..., 2], -1.0, 1.0))
        phi = torch.atan2(n_s[..., 1], n_s[..., 0])
        phi = torch.where(phi < 0, phi + 2 * math.pi, phi)
        uv_s = torch.stack([phi / (2 * math.pi), 1.0 - theta / math.pi], -1)
        s3 = is_sph[..., None]
        # sphere lanes must not inherit the clamped triangle row's
        # tangents (columns 23 and up)
        keep = (torch.arange(row.shape[-1], device=row.device) < 23).to(
            row.dtype)
        row = torch.where(s3, row * keep, row)
        ng = torch.where(s3, n_s, ng)
        ns = torch.where(s3, n_s, ns)
        uv = torch.where(s3, uv_s, uv)
        bsdf_id = torch.where(is_sph, g.sph_bsdf[sid], bsdf_id)
        emitter_id = torch.where(is_sph, -1, emitter_id)
        shape_id = torch.where(is_sph, g.sph_shape[sid], shape_id)
    return Intersection(
        valid=hit.valid,
        t=hit.t,
        p=p,
        ng=ng,
        ns=ns,
        uv=uv,
        prim_id=torch.where(hit.valid, hit.prim, -1),
        shape_id=torch.where(hit.valid, shape_id, -1),
        bsdf_id=torch.where(hit.valid, bsdf_id, -1),
        emitter_id=torch.where(hit.valid, emitter_id, -1),
        bary=None,
    )


# has_textures bits (scene.compile_scene) the port does not resolve yet,
# with the ROADMAP Queue 1 item each waits for
_UNPORTED_TEXTURE_BITS = ((2, "textured mask opacity", 13),
                          (8, "textured blend weights", 13),
                          (16, "woven-cloth (irawan) BSDFs", 12))


def check_texture_bits(has_textures):
    """Raise for the has_textures bits the port does not resolve yet."""
    for bit, what, item in _UNPORTED_TEXTURE_BITS:
        if int(has_textures) & bit:
            raise NotImplementedError(
                f"{what} (has_textures bit {bit.bit_length() - 1}): "
                f"ROADMAP Queue 1 item {item}")


def material_params(scene, has_textures, bsdf_id, uv, uv_footprint=None):
    """BSDF parameters of a batch of hits under the static has_textures
    mask: bit 0 resolves reflectance textures (uv_footprint: the primary
    hits' UV-space footprint for the mip level, None = finest), bit 2
    (BLEND / COATING rows present) resolves the wrapper rows' children
    one level deep, as the reference does: the params are child0's (the
    lane's own row where it is not a wrapper), with MatParams.blend the
    second child's (blend weight 0 off BLEND lanes) and the coat* fields
    the COATING row's layer.  Textured opacity, textured blend weights
    and woven cloth raise, naming their ROADMAP Queue 1 item."""
    from . import bsdf as bsdf_ops
    from ..scene.materials import BLEND, COATING
    check_texture_bits(has_textures)
    bits = int(has_textures)
    mid = torch.clamp_min(bsdf_id, 0)

    def gather(ids):
        albedo = None
        if bits & 1:
            from .texture import resolve_albedo
            albedo = resolve_albedo(scene, ids, uv, uv_footprint)
        return bsdf_ops.gather_params(scene.materials, ids,
                                      albedo_override=albedo)

    p = gather(mid)
    if not bits & 4:
        return p
    is_b = p.kind == BLEND
    is_c = p.kind == COATING
    c0 = torch.where(is_b | is_c, p.child0, mid)
    c1 = torch.where(is_b, p.child1, mid)
    return gather(c0)._replace(
        blend=gather(c1), blend_w=torch.where(is_b, p.blend_w, 0.0),
        coat=is_c, coat_eta=torch.clamp_min(p.eta[..., 0], 1.0 + 1e-4),
        coat_sigma=p.transmittance, coat_spec=p.specular,
        coat_alpha=torch.where(is_c, p.alpha_v, 0.0), coat_dist=p.dist)


def primary_uv_footprint(scene, W, H, d, its):
    """UV-space area of one pixel's footprint at a camera-ray hit — the
    mipmap level source (the reference's stand-in for camera-ray
    differentials; secondary bounces sample the finest level in both).
    Pixel solid angle ~ (A_img / (W H)) cos^3(theta_cam); projected
    surface area = t^2 omega / |cos(ng, d)|; converted to UV with the
    hit triangle's uv-per-world-area density (tri_shade column 22).
    Analytic-sphere lanes have no density row: 0, the finest level."""
    from .sensor import image_area
    cam = scene.camera
    fwd = cam.to_world[:3, 2]
    cos_cam = torch.clamp_min(m.dot(d, fwd.expand(d.shape)), 1e-6)
    omega = (image_area(cam) / (W * H)) * cos_cam ** 3
    cos_hit = torch.clamp_min(torch.abs(m.dot(its.ng, d)), 1e-4)
    area = torch.where(its.valid, its.t, 0.0) ** 2 * omega / cos_hit
    tri_shade = scene.geom.tri_shade
    prim = torch.clamp(its.prim_id, 0, tri_shade.shape[0] - 1)
    uvd = tri_shade[prim.long(), 22]
    uvd = torch.where(its.prim_id >= SPHERE_PRIM_BASE, 0.0, uvd)
    return area * uvd


def offset_ray_origin(p, ng, d, eps):
    """Spawn-point offset along the geometric normal, signed toward the ray
    direction (replaces Mitsuba's Epsilon-scaled mint handling)."""
    sign = torch.sign(m.dot(ng, d, keepdims=True))
    return p + ng * sign * eps
