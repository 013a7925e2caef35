"""Ray-triangle intersection: scene tables and the plain linear-MT sweeps.

Counterpart of gradientdomain_mitsuba_tpu/ops/intersect.py for what the
ported paths need: the NamedTuple tables the scene loader fills, the
linear-MT coefficient builders, intersect_matmul / occluded_matmul —
the PLAIN PyTorch versions of the two CUDA sweep kernels (ops/sweep.py,
csrc/sweep.cu) — and the pairwise Moeller-Trumbore test `_mt` with the
all-pairs intersect_brute / occluded_brute, the reference's exact oracle
and the arithmetic of the v2 traversal (ops/trace.tri9_plain), and the
analytic spheres' dense quadric test (intersect_spheres /
occluded_spheres, plain PyTorch on every device, as in the reference).
The CPU path and the tests use the sweeps' plain versions; a CUDA
tensor goes through the kernels.

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
