"""Distributed screened-Poisson reconstruction over row-sharded ranks.

Counterpart of gradientdomain_mitsuba_tpu/parallel/dist_poisson.py.  The
cross-tile coupling of the reconstruction is small: each CG iteration's
5-point stencil needs one neighbouring row, sent point to point (the
first row up, the last row down, zeros at the ends), and the CG dot
products are global, one all_reduce(SUM) each.  Film rows are padded to
a multiple of the world size and masked, so padding never couples into
the solution.  The same operator as models/poisson.solve_l2, up to the
order of the dot products' sums.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models.poisson import _dx, _dxT
from .tiles import _all_reduce_sum, _gather_host, _pass_along, padded_rows


def _send_up(x, mesh):
    """The next rank's FIRST row (zeros on the last rank).  x: [C, R, W]."""
    return _pass_along(mesh, x[:, :1], -1)


def _send_down(x, mesh):
    """The previous rank's LAST row (zeros on the first rank)."""
    return _pass_along(mesh, x[:, -1:], 1)


def _dy_halo(x, below_first_row):
    """Forward y-difference where the row after our last row comes from
    the next rank.  x: [3, R, W]; below_first_row: [3, 1, W]."""
    nxt = torch.cat([x[:, 1:], below_first_row], dim=1)
    return nxt - x


def _dyT_halo(g, above_last_row):
    """Adjoint: (DyT g)[k] = g[k-1] - g[k]; g[-1] comes from the
    previous rank."""
    prev = torch.cat([above_last_row, g[:, :-1]], dim=1)
    return prev - g


def solve_l2_sharded(mesh, primal, gx, gy, alpha=0.2, iters=100):
    """Distributed CG solve.  primal / gx / gy: [H, W, 3] global arrays
    (numpy or tensors), the same on every rank; returns the [H, W, 3]
    solution as numpy on every rank.  Each rank solves its row block on
    mesh.device."""
    primal, gx, gy = (x.detach().cpu().numpy() if torch.is_tensor(x)
                      else np.asarray(x) for x in (primal, gx, gy))
    H, W = primal.shape[:2]
    n = mesh.size
    Hp = padded_rows(H, n)
    R = Hp // n

    def pad(a):
        return np.pad(np.asarray(a, np.float32),
                      ((0, Hp - H), (0, 0), (0, 0)))

    GX = pad(gx)
    GY = pad(gy)
    GX[:, -1] = 0.0
    GY[H - 1:] = 0.0
    mask = np.zeros((Hp, 1, 1), np.float32)
    mask[:H] = 1.0
    a2 = alpha * alpha

    def local(a):
        """This rank's rows as [C, R, W] on the device."""
        blk = a[mesh.rank * R:(mesh.rank + 1) * R]
        return torch.from_numpy(np.ascontiguousarray(
            np.moveaxis(blk, -1, 0))).to(mesh.device)

    Pl, GXl, GYl = local(pad(primal)), local(GX), local(GY)
    Ml = local(mask)  # [1, R, 1]

    # dy at row k is valid only when rows k AND k+1 are valid: the
    # global operator's zero last-row Dy (Neumann)
    dy_mask = torch.cat([Ml[:, 1:], _send_up(Ml, mesh)], dim=1) * Ml

    def A(x):
        x = x * Ml
        dyx = _dy_halo(x, _send_up(x, mesh)) * dy_mask
        out = _dxT(_dx(x)) + _dyT_halo(dyx, _send_down(dyx, mesh)) + a2 * x
        return out * Ml

    def dot(u, v):
        return _all_reduce_sum(torch.sum(u * v, dim=(-2, -1), keepdim=True),
                               mesh)

    GYm = GYl * dy_mask
    b = (_dxT(GXl) + _dyT_halo(GYm, _send_down(GYm, mesh)) + a2 * Pl) * Ml
    x = Pl * Ml
    r = b - A(x)
    p = r
    rs = dot(r, r)
    for _ in range(iters):
        Ap = A(p)
        denom = dot(p, Ap)
        al = torch.where(denom > 0, rs / torch.clamp_min(denom, 1e-30), 0.0)
        x = x + al * p
        r = r - al * Ap
        rs_new = dot(r, r)
        be = torch.where(rs > 0, rs_new / torch.clamp_min(rs, 1e-30), 0.0)
        p = r + be * p
        rs = rs_new
    return _gather_host(torch.movedim(x, 0, -1).contiguous(), H, mesh)


def reconstruct_sharded(mesh, buffers, alpha=0.2, iters=100):
    """Distributed L2 reconstruction + very-direct re-add (numpy)."""
    rec = solve_l2_sharded(mesh, buffers["primal"], buffers["dx"],
                           buffers["dy"], alpha=alpha, iters=iters)
    vd = buffers["very_direct"]
    vd = vd.detach().cpu().numpy() if torch.is_tensor(vd) else \
        np.asarray(vd)
    return rec + vd
