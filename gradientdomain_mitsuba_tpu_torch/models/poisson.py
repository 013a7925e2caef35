"""Screened-Poisson reconstruction (L2 conjugate gradient, L1 IRLS).

Counterpart of gradientdomain_mitsuba_tpu/models/poisson.py (the fork's
src/integrators/poisson_solver/Solver.cpp).  Solves, per RGB channel,

    min_I  || Dx I - gx ||_p + || Dy I - gy ||_p + alpha * || I - P ||_p

with p in {1, 2}.  Dx/Dy are forward differences with Neumann boundaries
expressed as padded shifts; CG state lives in [3, H, W] tensors on the
scene's device; the L1 mode runs IRLS outer iterations reweighting all
residuals by 1/max(|r|, eps).  Semantics as in the reference:
  - gx[i, j] estimates I[i, j+1] - I[i, j]; the last column/row of gx/gy
    lie outside the lattice and are masked out;
  - the very-direct buffer is added AFTER the solve by the caller.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils import stats


def _dx(img):
    """Forward difference along x (last column -> 0)."""
    return F.pad(img[..., :, 1:] - img[..., :, :-1], (0, 1))


def _dy(img):
    return F.pad(img[..., 1:, :] - img[..., :-1, :], (0, 0, 0, 1))


def _dxT(g):
    """Adjoint of _dx (negative divergence component)."""
    return F.pad(g[..., :, :-1], (1, 0)) - F.pad(g[..., :, :-1], (0, 1))


def _dyT(g):
    return (F.pad(g[..., :-1, :], (0, 0, 1, 0)) -
            F.pad(g[..., :-1, :], (0, 0, 0, 1)))


def _mask_gradients(gx, gy):
    """Zero the out-of-lattice last column of gx / last row of gy."""
    gx = gx.clone()
    gy = gy.clone()
    gx[..., :, -1] = 0.0
    gy[..., -1, :] = 0.0
    return gx, gy


def _cg(A, b, x0, iters, residuals=False):
    """Batched conjugate gradient over leading axes (channels).  Returns
    (x, residual_norms [iters]) with residuals, else (x, None).  Runs on
    the device without host syncs: the step guards are torch.where, as in
    the reference."""
    def dot(a, c):
        return torch.sum(a * c, dim=(-2, -1), keepdim=True)

    r = b - A(x0)
    p = r
    rs = dot(r, r)
    x = x0
    res = (torch.zeros(iters, dtype=b.dtype, device=b.device)
           if residuals else None)
    for i in range(iters):
        Ap = A(p)
        denom = dot(p, Ap)
        alpha = torch.where(denom > 0, rs / torch.clamp_min(denom, 1e-30),
                            0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = dot(r, r)
        beta = torch.where(rs > 0, rs_new / torch.clamp_min(rs, 1e-30), 0.0)
        p = r + beta * p
        if residuals:
            res[i] = torch.sqrt(torch.sum(rs_new))
        rs = rs_new
    return x, res


def solve_l2(primal, gx, gy, alpha=0.2, iters=100, return_residuals=False):
    """L2 screened-Poisson solve.  All inputs [H, W, 3]; returns [H, W, 3]
    (plus the CG residual curve when return_residuals)."""
    with stats.span("solve", device=True):
        P = torch.movedim(primal, -1, 0)  # [3, H, W]
        GX, GY = _mask_gradients(torch.movedim(gx, -1, 0),
                                 torch.movedim(gy, -1, 0))
        a2 = alpha * alpha

        def A(x):
            return _dxT(_dx(x)) + _dyT(_dy(x)) + a2 * x

        b = _dxT(GX) + _dyT(GY) + a2 * P
        x, res = _cg(A, b, P, iters, return_residuals)
        out = torch.movedim(x, 0, -1)
    return (out, res) if return_residuals else out


def solve_l1(primal, gx, gy, alpha=0.2, outer_iters=8, inner_iters=40,
             irls_eps=1e-4, return_residuals=False):
    """L1 reconstruction via IRLS: reweighted L2 solves (Solver.cpp L1 mode,
    `reconstructL1=true` default in gpt.cpp).  With return_residuals,
    also the CG residual curve [outer_iters * inner_iters]."""
    with stats.span("solve", device=True):
        P = torch.movedim(primal, -1, 0)
        GX, GY = _mask_gradients(torch.movedim(gx, -1, 0),
                                 torch.movedim(gy, -1, 0))
        a2 = alpha * alpha
        x = P
        res_all = []
        for i in range(outer_iters):
            with stats.span("irls", i=i):
                wx = 1.0 / torch.clamp_min(torch.abs(_dx(x) - GX), irls_eps)
                wy = 1.0 / torch.clamp_min(torch.abs(_dy(x) - GY), irls_eps)
                wp = 1.0 / torch.clamp_min(torch.abs(x - P), irls_eps)

                def A(v, wx=wx, wy=wy, wp=wp):
                    return (_dxT(wx * _dx(v)) + _dyT(wy * _dy(v)) +
                            a2 * wp * v)

                b = _dxT(wx * GX) + _dyT(wy * GY) + a2 * wp * P
                x, res = _cg(A, b, x, inner_iters, return_residuals)
                res_all.append(res)
        out = torch.movedim(x, 0, -1)
    if return_residuals:
        return out, torch.cat(res_all)
    return out


def reconstruct(buffers, alpha=0.2, mode="L1", l2_iters=100,
                l1_outer=8, l1_inner=40, return_stats=False):
    """Full gpt post-pass: solve + re-add very direct.

    buffers: dict with primal/dx/dy/very_direct [H, W, 3] tensors
    (sample-normalized).  Returns the final image, or
    (final, {"cg_residuals": [iters]}) with return_stats."""
    primal, gx, gy = buffers["primal"], buffers["dx"], buffers["dy"]
    if mode.upper() == "L2":
        out = solve_l2(primal, gx, gy, alpha=alpha, iters=l2_iters,
                       return_residuals=return_stats)
    else:
        out = solve_l1(primal, gx, gy, alpha=alpha, outer_iters=l1_outer,
                       inner_iters=l1_inner, return_residuals=return_stats)
    if return_stats:
        rec, res = out
        return (rec + buffers["very_direct"],
                {"cg_residuals": res.cpu().numpy()})
    return out + buffers["very_direct"]
