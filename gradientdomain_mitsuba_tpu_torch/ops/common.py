"""Scene-level intersection wrappers: traversal + hit-record fill.

Counterpart of gradientdomain_mitsuba_tpu/ops/common.py (Scene::
rayIntersect + Shape::fillIntersectionRecord, src/librender/scene.cpp,
shape.cpp, trimesh.cpp): traversal returns (t, u, v, prim); this module
gathers vertex attributes and material/emitter ids into the flat
Intersection record every integrator uses.

Ported: the small-scene (<= 2048 triangles) traversal through the sweep
kernels, the large-scene traversal through the pair kernels (or, under
GDMT_KERNEL=v4, the v4 block kernels), the
untextured material gather, and the hit fill without the barycentric
payload or normal perturbation.  The reference's one-hot
matmul gather (fast_row_gather) is a TPU workaround; here it is plain
indexing.
"""
from __future__ import annotations

import os

import torch

from ..core import math as m
from ..core.records import Intersection
from . import sweep, trace

BRUTE_FORCE_MAX_TRIS = 2048


def add_sphere_intersections(closest_tri, occl_tri):
    """Analytic-sphere merge.  Only the no-sphere pass-through is ported:
    a scene with analytic spheres raises (ROADMAP Queue 1 item 3)."""

    def _no_spheres(geom):
        if geom.sph_center.shape[0] != 0:
            raise NotImplementedError(
                "analytic spheres: ROADMAP Queue 1 item 3")

    def closest(o, d, mint, maxt, geom):
        _no_spheres(geom)
        return closest_tri(o, d, mint, maxt, geom)

    def occluded(o, d, mint, maxt, geom):
        _no_spheres(geom)
        return occl_tri(o, d, mint, maxt, geom)

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
    if g.sph_center.shape[0] > 0:
        raise NotImplementedError("analytic spheres: ROADMAP Queue 1 item 3")
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


def material_params(scene, has_textures, bsdf_id, uv):
    """BSDF parameters of a batch of hits: the untextured, blend-free
    case (has_textures == 0).  Other cases raise (ROADMAP Queue 1 items
    12-13)."""
    from . import bsdf as bsdf_ops
    if int(has_textures):
        raise NotImplementedError(
            "textured / blend materials: ROADMAP Queue 1 items 12-13")
    return bsdf_ops.gather_params(scene.materials,
                                  torch.clamp_min(bsdf_id, 0))


def offset_ray_origin(p, ng, d, eps):
    """Spawn-point offset along the geometric normal, signed toward the ray
    direction (replaces Mitsuba's Epsilon-scaled mint handling)."""
    sign = torch.sign(m.dot(ng, d, keepdims=True))
    return p + ng * sign * eps
