"""Ray-triangle intersection: scene tables and the plain linear-MT sweeps.

Counterpart of gradientdomain_mitsuba_tpu/ops/intersect.py for what the
ported paths need: the NamedTuple tables the scene loader fills, the
linear-MT coefficient builders, intersect_matmul / occluded_matmul —
the PLAIN PyTorch versions of the two CUDA sweep kernels (ops/sweep.py,
csrc/sweep.cu) — and the pairwise Moeller-Trumbore test `_mt` with the
all-pairs intersect_brute / occluded_brute, the reference's exact oracle
and the arithmetic of the v2 traversal (ops/trace.tri9_plain), the
reference's plain traversals (the lockstep BVH stack walks
make_bvh_intersector[_soa] / make_bvh_occluder[_soa], which only tests
call, and the two-level cluster walk make_cluster_intersector /
make_cluster_occluder, ops/common's route for a large scene without
clusters), and the analytic spheres' dense quadric test
(intersect_spheres / occluded_spheres, plain PyTorch on every device,
as in the reference).  The CPU path and the tests use the sweeps' plain
versions; a CUDA tensor goes through the kernels.

Linear Moeller-Trumbore (reference ops/intersect.py:415-435): with
n = e1 x e2,
  det   = -d.n
  u_num = (o x d).e2 + d.(v0 x e2)
  v_num = -(o x d).e1 - d.(v0 x e1)
  t_num = o.n - v0.n
so the ray features [o x d, d, o, 1] times a per-triangle [10, 4] block
give every term; R rays x T triangles is one [R, 10] @ [10, 4T] product.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..scene.bvh import LEAF_BITS, MAX_LEAF

F32_MAX = 3.0e38
SPAN = 4  # zero-slab tail of build_mt_slabs (reference pallas_trace.SPAN)


class TriSoup(NamedTuple):
    """Triangle geometry in BVH leaf order."""
    v0: torch.Tensor       # [T, 3]
    e1: torch.Tensor       # [T, 3]  (v1 - v0)
    e2: torch.Tensor       # [T, 3]  (v2 - v0)
    orig_id: torch.Tensor  # [T] i32 — original (scene) triangle index


class ClusterArrays(NamedTuple):
    """Two-level clustered acceleration: cluster AABBs + offsets into the
    BVH-ordered, window-padded triangle soup."""
    bmin: torch.Tensor    # [K, 3]
    bmax: torch.Tensor    # [K, 3]
    offset: torch.Tensor  # [K] i32 window start


class BVHArrays(NamedTuple):
    child0_min: torch.Tensor  # [N, 3]
    child0_max: torch.Tensor
    child1_min: torch.Tensor
    child1_max: torch.Tensor
    child0: torch.Tensor      # [N] i32 code (>=0 internal, <0 leaf)
    child1: torch.Tensor      # [N] i32


class Hit(NamedTuple):
    t: torch.Tensor      # [R] distance (F32_MAX if miss)
    u: torch.Tensor      # [R] barycentric
    v: torch.Tensor      # [R]
    prim: torch.Tensor   # [R] i32 BVH-order triangle index (-1 if miss)
    valid: torch.Tensor  # [R] bool


def build_linear_mt(v0, e1, e2) -> np.ndarray:
    """[10, 4T] per-triangle coefficient matrix for the linear-MT sweep
    (built in f64 on host, stored f32).  Column blocks: det | u_num |
    v_num | t_num.  Degenerate (padding) triangles get all-zero columns,
    hence det = 0, hence never hit."""
    v0 = np.asarray(v0, np.float64)
    e1 = np.asarray(e1, np.float64)
    e2 = np.asarray(e2, np.float64)
    T = v0.shape[0]
    n = np.cross(e1, e2)
    C = np.zeros((10, 4 * T), np.float64)
    C[3:6, 0:T] = -n.T
    C[0:3, T:2 * T] = e2.T
    C[3:6, T:2 * T] = np.cross(v0, e2).T
    C[0:3, 2 * T:3 * T] = -e1.T
    C[3:6, 2 * T:3 * T] = -np.cross(v0, e1).T
    C[6:9, 3 * T:4 * T] = n.T
    C[9, 3 * T:4 * T] = -np.einsum('ti,ti->t', v0, n)
    return C.astype(np.float32)


def build_mt_slabs(linC: np.ndarray, window: int) -> np.ndarray:
    """Per-cluster 8-row linear-MT slabs [K + SPAN-1, 8, 4*window]
    (reference ops/pallas_trace.build_mt_slabs): det|u|v columns keep
    linC rows 0:6, the t columns carry rows 6:10 in slab rows 0:4, and
    SPAN-1 all-zero tail clusters follow.  Built by the scene loader for
    scenes above 2048 triangles; their traversal kernel is ROADMAP
    Queue 2 work."""
    Tp = linC.shape[1] // 4
    K = Tp // window
    seg = linC.reshape(10, 4, K, window)          # [10, out, K, W]
    per = seg.transpose(2, 0, 1, 3)               # [K, 10, out, W]
    slabs = np.zeros((K + SPAN - 1, 8, 4 * window), np.float32)
    slabs[:K, 0:6, 0:3 * window] = per[:, 0:6, 0:3, :].reshape(
        K, 6, 3 * window)
    slabs[:K, 0:4, 3 * window:] = per[:, 6:10, 3, :]
    return slabs


def _mt(o, d, v0, e1, e2, mint, maxt):
    """Moeller-Trumbore; o, d [..., 3] broadcast against v0/e1/e2 [..., 3],
    mint / maxt against the result.  Returns (t, u, v, hit).

    One evaluation order, which csrc/trace_block.cu's v2 kernels repeat
    with _rn intrinsics: every product rounded once, cross products as
    a*b - c*d, three-term dots as (x0 + x1) + x2, inv_det an IEEE
    reciprocal (0 where |det| <= 1e-12)."""
    def comp(a):
        return a[..., 0], a[..., 1], a[..., 2]

    dx, dy, dz = comp(d)
    v0x, v0y, v0z = comp(v0)
    e1x, e1y, e1z = comp(e1)
    e2x, e2y, e2z = comp(e2)
    ox, oy, oz = comp(o)
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    big = det.abs() > 1e-12
    inv_det = torch.where(big, 1.0 / det, 0.0)
    tx = ox - v0x
    ty = oy - v0y
    tz = oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    hit = (big & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > mint) &
           (t < maxt))
    return t, u, v, hit


def intersect_brute(o, d, mint, maxt, tris: TriSoup, chunk: int = 2048,
                    ray_chunk: int = 4096) -> Hit:
    """Closest hit, all rays x all triangles, by _mt over triangle chunks
    (and ray chunks, to bound the [rays, chunk] temporaries).  Among
    equal minimal t the lowest triangle index wins, as the reference's
    scan over chunks with a strict `<` gives."""
    R = o.shape[0]
    T = tris.v0.shape[0]
    dev = o.device
    t_out = torch.full((R,), F32_MAX, device=dev)
    u_out = torch.zeros(R, device=dev)
    v_out = torch.zeros(R, device=dev)
    p_out = torch.full((R,), -1, dtype=torch.int32, device=dev)
    for a in range(0, R, ray_chunk):
        sl = slice(a, min(a + ray_chunk, R))
        bt, bu, bv, bp = t_out[sl], u_out[sl], v_out[sl], p_out[sl]
        for c in range(0, T, chunk):
            tc = slice(c, min(c + chunk, T))
            t, u, v, h = _mt(o[sl, None], d[sl, None], tris.v0[None, tc],
                             tris.e1[None, tc], tris.e2[None, tc],
                             mint[sl, None], maxt[sl, None])
            t = torch.where(h, t, F32_MAX)
            tj, j = t.min(1)                # first index among equal t
            better = h.any(1) & (tj < bt)
            pick = j[:, None]
            bu.copy_(torch.where(better, u.gather(1, pick)[:, 0], bu))
            bv.copy_(torch.where(better, v.gather(1, pick)[:, 0], bv))
            bp.copy_(torch.where(better, (j + c).to(torch.int32), bp))
            bt.copy_(torch.where(better, tj, bt))
    return Hit(t=t_out, u=u_out, v=v_out, prim=p_out, valid=p_out >= 0)


def occluded_brute(o, d, mint, maxt, tris: TriSoup, chunk: int = 2048):
    return intersect_brute(o, d, mint, maxt, tris, chunk).valid


# ---------------------------------------------------------------------------
# Plain traversals of the reference (ops/intersect.py:127-436, 517-633):
# every lane walks in lockstep under masks, and the loops stop when no
# lane has work left (one host read an iteration: no render path uses
# the BVH walks, and the cluster walk only serves a large scene without
# clusters, which the loader never makes).  Gathers clamp their indices
# and stack writes past the top are dropped, as XLA's do; the results
# keep the unclamped indices, as the reference's.
# ---------------------------------------------------------------------------

def _fma(a, b, c):
    """a * b + c rounded once to f32 (the product is exact in float64;
    the sum's double rounding is the emulation's only approximation)."""
    return (a.double() * b.double() + c.double()).float()


def _cross_fma(a, b):
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return (_fma(ay, bz, -(az * by)), _fma(az, bx, -(ax * bz)),
            _fma(ax, by, -(ay * bx)))


def _dot_fma(a, b):
    return _fma(a[2], b[2], _fma(a[1], b[1], a[0] * b[0]))


def _mt_fma(o, d, v0, e1, e2, mint, maxt):
    """Moeller-Trumbore as XLA's CPU backend compiles the reference's
    _mt: each cross-product component one fused multiply-add, each
    three-term dot two, so the plain traversals below give the
    reference's bits (t, u, v) on the CPU.  Broadcasts like _mt."""
    pvec = _cross_fma(d, e2)
    det = _dot_fma(e1.unbind(-1), pvec)
    big = det.abs() > 1e-12
    inv_det = torch.where(big, 1.0 / det, 0.0)
    tvec = o - v0
    u = _dot_fma(tvec.unbind(-1), pvec) * inv_det
    qvec = _cross_fma(tvec, e1)
    v = _dot_fma(d.unbind(-1), qvec) * inv_det
    t = _dot_fma(e2.unbind(-1), qvec) * inv_det
    hit = (big & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > mint) &
           (t < maxt))
    return t, u, v, hit


def _decode_leaf(code):
    """Leaf code -> (first prim, prim count)."""
    raw = -code - 1
    return raw >> LEAF_BITS, raw & ((1 << LEAF_BITS) - 1)


def _slab(o, inv_d, mint, maxt, bmin, bmax):
    """Ray vs AABB over the last axis: (hit, entry t)."""
    t0 = (bmin - o) * inv_d
    t1 = (bmax - o) * inv_d
    tn = torch.amax(torch.minimum(t0, t1), dim=-1)
    tf = torch.amin(torch.maximum(t0, t1), dim=-1)
    return (tn <= tf) & (tf >= mint) & (tn <= maxt), tn


def _inv_dir(d):
    return torch.where(d.abs() > 1e-12, 1.0 / d, 1e30)


def _bvh_walk(stack_depth: int, any_hit: bool):
    """The lockstep stack walk over a [N, stack_depth] stack, one pop a
    lane an iteration.  Closest hit: the far child is pushed first so
    the near one pops first, and slabs test against the running best t.
    Any hit: child 1 then child 0 pushed, slabs against maxt, and a lane
    stops at its first hit."""

    def walk(o, d, mint, maxt, tris: TriSoup, bvh: BVHArrays):
        N = o.shape[0]
        dev = o.device
        lanes = torch.arange(N, device=dev)
        inv_d = _inv_dir(d)
        T = tris.v0.shape[0]
        stack = torch.zeros((N, stack_depth), dtype=torch.int32, device=dev)
        sp = torch.ones(N, dtype=torch.int64, device=dev)    # root pushed
        t_b = maxt.clone()
        u_b = torch.zeros_like(maxt)
        v_b = torch.zeros_like(maxt)
        p_b = torch.full((N,), -1, dtype=torch.int32, device=dev)
        occ = torch.zeros(N, dtype=torch.bool, device=dev)

        def push(mask, code, sp):
            at = sp.clamp(max=stack_depth - 1)
            keep = mask & (sp < stack_depth)
            stack[lanes, at] = torch.where(keep, code, stack[lanes, at])
            return sp + mask.long()

        while True:
            active = (sp > 0) & ~occ
            if not bool(active.any()):
                break
            code = stack[lanes, (sp - 1).clamp(0, stack_depth - 1)]
            sp = torch.where(active, sp - 1, sp)

            is_int = active & (code >= 0)
            node = code.clamp(min=0).long()
            tmax = maxt if any_hit else t_b
            h0, tn0 = _slab(o, inv_d, mint, tmax, bvh.child0_min[node],
                            bvh.child0_max[node])
            h1, tn1 = _slab(o, inv_d, mint, tmax, bvh.child1_min[node],
                            bvh.child1_max[node])
            c0 = bvh.child0[node]
            c1 = bvh.child1[node]
            if any_hit:
                first, second, hf, hs = c0, c1, h0, h1
            else:
                near_first = tn0 <= tn1
                first = torch.where(near_first, c0, c1)
                second = torch.where(near_first, c1, c0)
                hf = torch.where(near_first, h0, h1)
                hs = torch.where(near_first, h1, h0)
            sp = push(is_int & hs, second, sp)
            sp = push(is_int & hf, first, sp)

            is_leaf = active & (code < 0)
            offset, count = _decode_leaf(code.long().clamp(max=-1))
            for j in range(MAX_LEAF):
                idx = offset + j
                g = idx.clamp(max=T - 1)
                t, u, v, h = _mt_fma(o, d, tris.v0[g], tris.e1[g], tris.e2[g],
                                 mint, maxt if any_hit else t_b)
                h = h & is_leaf & (j < count)
                if any_hit:
                    occ = occ | h
                    continue
                t_b = torch.where(h, t, t_b)
                u_b = torch.where(h, u, u_b)
                v_b = torch.where(h, v, v_b)
                p_b = torch.where(h, idx.to(torch.int32), p_b)
        if any_hit:
            return occ
        return Hit(t=torch.where(p_b >= 0, t_b, F32_MAX), u=u_b, v=v_b,
                   prim=p_b, valid=p_b >= 0)

    return walk


def make_bvh_intersector_soa(stack_depth: int):
    """Batched closest-hit BVH traversal: (o, d, mint, maxt, tris, bvh)
    -> Hit.  stack_depth must be >= 2 * bvh depth + 2."""
    return _bvh_walk(stack_depth, any_hit=False)


def make_bvh_occluder_soa(stack_depth: int):
    """Batched any-hit BVH traversal (shadow rays) -> occluded [N]."""
    return _bvh_walk(stack_depth, any_hit=True)


# the reference's vmapped one-ray forms walk each ray as its SoA forms do
make_bvh_intersector = make_bvh_intersector_soa
make_bvh_occluder = make_bvh_occluder_soa


def _features(o, d):
    """[R, 10] ray features [o x d, d, o, 1] (column order of linC)."""
    return torch.cat([torch.linalg.cross(o, d, dim=-1), d, o,
                      torch.ones_like(o[:, :1])], dim=1)


def intersect_matmul(o, d, mint, maxt, linC) -> Hit:
    """Closest hit against every triangle (plain version of the sweep
    kernel).  Divide-first test: u = u_num * (1/det) etc.; det == 0
    (parallel or padding) gives inf/nan coordinates whose comparisons all
    fail.  The winner is the LOWEST triangle index among equal minimal t."""
    T = linC.shape[1] // 4
    F = _features(o, d) @ linC
    d_inv = 1.0 / F[:, :T]
    u = F[:, T:2 * T] * d_inv
    v = F[:, 2 * T:3 * T] * d_inv
    t = F[:, 3 * T:] * d_inv
    ok = ((u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) &
          (t > mint[:, None]) & (t < maxt[:, None]))
    tt = torch.where(ok, t, F32_MAX)
    tm = torch.amin(tt, dim=1)
    valid = tm < F32_MAX
    sel = ok & (tt == tm[:, None])
    iota = torch.arange(T, dtype=torch.int32, device=o.device)
    j = torch.amin(torch.where(sel, iota, 2 ** 30), dim=1)
    first = sel & (iota == j[:, None])
    us = torch.sum(torch.where(first, u, 0.0), dim=1)
    vs = torch.sum(torch.where(first, v, 0.0), dim=1)
    return Hit(t=torch.where(valid, tm, F32_MAX), u=us, v=vs,
               prim=torch.where(valid, j, -1).to(torch.int32), valid=valid)


def occluded_matmul(o, d, mint, maxt, linC):
    """Any-hit (plain version of the occlusion kernel): the sign-fixed,
    division-free test su,sv >= 0, su+sv <= |det|, |det| > 0,
    mint*|det| < st < maxt*|det|."""
    T = linC.shape[1] // 4
    F = _features(o, d) @ linC
    det = F[:, :T]
    s = torch.sign(det)
    ad = det * s
    su = F[:, T:2 * T] * s
    sv = F[:, 2 * T:3 * T] * s
    st = F[:, 3 * T:] * s
    ok = ((su >= 0.0) & (sv >= 0.0) & (su + sv <= ad) & (ad > 0.0) &
          (st > mint[:, None] * ad) & (st < maxt[:, None] * ad))
    return torch.any(ok, dim=1)


CLUSTER_RAY_CHUNK = 4096


def _cluster_walk(window: int, any_hit: bool):
    """Two-level clustered traversal (reference ops/intersect.py:517-633):
    dense [N, K] ray-vs-cluster-AABB tests, each ray's clusters sorted
    near to far (a stable sort, as jnp.argsort, so equal entry distances
    keep cluster order), then a loop in which every lane tests its r-th
    cluster's CONTIGUOUS window of `window` triangles.  Closest hit: a
    cluster is tested while its entry t is below the lane's best t, and
    the first hit in visit order wins (strict `<` across clusters, the
    lowest slot of a window among its equal t) — the reference's rule,
    not the kernels' lowest prim.  Any hit: every cluster the ray enters
    until its first hit.  Rays are taken CLUSTER_RAY_CHUNK at a time, which
    bounds the [rays, K] temporaries and changes no result (a lane's
    walk never reads another lane's)."""

    def walk(o, d, mint, maxt, tris: TriSoup, clusters: ClusterArrays):
        n = CLUSTER_RAY_CHUNK
        outs = [_cluster_chunk(o[a:a + n], d[a:a + n], mint[a:a + n],
                               maxt[a:a + n], tris, clusters, window,
                               any_hit)
                for a in range(0, max(o.shape[0], 1), n)]
        if any_hit:
            return torch.cat(outs)
        return Hit(*(torch.cat(f) for f in zip(*outs)))

    return walk


def _cluster_chunk(o, d, mint, maxt, tris, clusters, window, any_hit):
    N = o.shape[0]
    K = clusters.offset.shape[0]
    dev = o.device
    lanes = torch.arange(N, device=dev)
    hit_c, tn = _slab(o[:, None], _inv_dir(d)[:, None], mint[:, None],
                      maxt[:, None], clusters.bmin[None], clusters.bmax[None])
    tnear = torch.where(hit_c, torch.maximum(tn, mint[:, None]), F32_MAX)
    order = torch.argsort(tnear, dim=1, stable=True)
    sortd = torch.gather(tnear, 1, order)
    w_ar = torch.arange(window, device=dev)
    T = tris.v0.shape[0]
    t_b = maxt.clone()
    u_b = torch.zeros_like(maxt)
    v_b = torch.zeros_like(maxt)
    p_b = torch.full((N,), -1, dtype=torch.int32, device=dev)
    occ = torch.zeros(N, dtype=torch.bool, device=dev)
    for r in range(K):
        cnear = sortd[:, r]
        pending = ((cnear < F32_MAX) & ~occ) if any_hit else cnear < t_b
        if not bool(pending.any()):
            break
        off = clusters.offset[order[:, r]].long()
        idx = off[:, None] + w_ar[None, :]                   # [N, W]
        g = idx.clamp(max=T - 1)
        t, u, v, h = _mt_fma(o[:, None], d[:, None], tris.v0[g], tris.e1[g],
                         tris.e2[g], mint[:, None],
                         (maxt if any_hit else t_b)[:, None])
        h = h & pending[:, None]
        if any_hit:
            occ = occ | h.any(dim=1)
            continue
        t = torch.where(h, t, F32_MAX)
        tj, j = torch.min(t, dim=1)              # first slot among equal t
        better = tj < t_b
        pick = j[:, None]
        u_b = torch.where(better, u.gather(1, pick)[:, 0], u_b)
        v_b = torch.where(better, v.gather(1, pick)[:, 0], v_b)
        p_b = torch.where(better, idx[lanes, j].to(torch.int32), p_b)
        t_b = torch.where(better, tj, t_b)
    if any_hit:
        return occ
    return Hit(t=torch.where(p_b >= 0, t_b, F32_MAX), u=u_b, v=v_b,
               prim=p_b, valid=p_b >= 0)


def make_cluster_intersector(window: int):
    """Two-level clustered closest hit: (o, d, mint, maxt, tris,
    clusters) -> Hit (see _cluster_walk)."""
    return _cluster_walk(window, any_hit=False)


def make_cluster_occluder(window: int):
    """Any-hit variant: the same nearest-first loop; a lane stops at its
    first hit."""
    return _cluster_walk(window, any_hit=True)


# ---------------------------------------------------------------------------
# Analytic spheres (src/shapes/sphere.cpp): a second primitive type, tested
# densely beside the triangle traversal and merged by closest t
# (ops/common.add_sphere_intersections).  Scenes hold a handful of
# spheres, so the [N, S] quadric solve is plain PyTorch, as the reference
# computes it outside its Pallas kernels.
# ---------------------------------------------------------------------------

def intersect_spheres(o, d, mint, maxt, centers, radii):
    """Closest sphere hit per ray: (t [N], sid [N] i32, -1 on miss).
    Directions must be unit length (every caller's convention).  Among
    equal t the first sphere wins (torch.argmin returns the first
    minimum, as jnp.argmin)."""
    oc = o[:, None, :] - centers[None]                # [N, S, 3]
    b = torch.sum(oc * d[:, None, :], -1)             # [N, S]
    c = torch.sum(oc * oc, -1) - radii[None] ** 2
    disc = b * b - c
    ok = disc >= 0
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    t0 = -b - sq
    t1 = -b + sq
    in0 = (t0 > mint[:, None]) & (t0 < maxt[:, None])
    in1 = (t1 > mint[:, None]) & (t1 < maxt[:, None])
    t = torch.where(ok & in0, t0, torch.where(ok & in1, t1, F32_MAX))
    tmin, sid = torch.min(t, dim=1)
    hit = tmin < 0.5 * F32_MAX
    return (torch.where(hit, tmin, F32_MAX),
            torch.where(hit, sid.to(torch.int32), -1))


def occluded_spheres(o, d, mint, maxt, centers, radii):
    _, sid = intersect_spheres(o, d, mint, maxt, centers, radii)
    return sid >= 0
