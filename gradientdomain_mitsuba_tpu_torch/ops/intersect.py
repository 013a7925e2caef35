"""Ray-triangle intersection: scene tables and the plain linear-MT sweeps.

Counterpart of gradientdomain_mitsuba_tpu/ops/intersect.py for what the
small-scene path needs: the NamedTuple tables the scene loader fills, the
linear-MT coefficient builders, and intersect_matmul / occluded_matmul —
the PLAIN PyTorch versions of the two CUDA sweep kernels (ops/sweep.py,
csrc/sweep.cu).  The CPU path and the tests use them; a CUDA tensor goes
through the kernels.

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
