"""Plain screened-Poisson L1 reconstruction (IRLS over conjugate
gradients), for the reference.

Per RGB channel it minimizes |Dx I - gx|_1 + |Dy I - gy|_1 +
alpha |I - P|_1 by iteratively reweighted least squares: each outer
iteration weights every residual by 1 / max(|r|, 1e-4) and runs a fixed
number of conjugate-gradient steps from the current image, as the
reconstruction of Kettunen et al. (2015) does.  Dx, Dy are forward
differences with the last column / row of gx / gy outside the lattice.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _dx(x):
    return F.pad(x[..., :, 1:] - x[..., :, :-1], (0, 1))


def _dy(x):
    return F.pad(x[..., 1:, :] - x[..., :-1, :], (0, 0, 0, 1))


def _dxT(g):
    return F.pad(g[..., :, :-1], (1, 0)) - F.pad(g[..., :, :-1], (0, 1))


def _dyT(g):
    return (F.pad(g[..., :-1, :], (0, 0, 1, 0)) -
            F.pad(g[..., :-1, :], (0, 0, 0, 1)))


def _cg(A, b, x, iters):
    def dot(a, c):
        return torch.sum(a * c, dim=(-2, -1), keepdim=True)
    r = b - A(x)
    p = r
    rs = dot(r, r)
    for _ in range(iters):
        Ap = A(p)
        den = dot(p, Ap)
        a = torch.where(den > 0, rs / torch.clamp_min(den, 1e-30), 0.0)
        x = x + a * p
        r = r - a * Ap
        rs_new = dot(r, r)
        p = r + torch.where(rs > 0, rs_new / torch.clamp_min(rs, 1e-30),
                            0.0) * p
        rs = rs_new
    return x


def _planes(primal, gx, gy):
    """[3, H, W] planes of the inputs, the gradients' last column / row
    (outside the lattice) zeroed."""
    P = torch.movedim(primal, -1, 0)
    GX = torch.movedim(gx, -1, 0).clone()
    GY = torch.movedim(gy, -1, 0).clone()
    GX[..., :, -1] = 0.0
    GY[..., -1, :] = 0.0
    return P, GX, GY


def objective(image, primal, gx, gy, alpha=0.2):
    """The L1 objective |Dx I - gx|_1 + |Dy I - gy|_1 + alpha |I - P|_1
    of an [H, W, 3] image, summed over the channels, in float64."""
    I = torch.movedim(image.double(), -1, 0)
    P, GX, GY = _planes(primal.double(), gx.double(), gy.double())
    return float((_dx(I) - GX).abs().sum() + (_dy(I) - GY).abs().sum() +
                 alpha * (I - P).abs().sum())


def solve_l1(primal, gx, gy, alpha=0.2, outer=8, inner=40, eps=1e-4):
    """[H, W, 3] inputs -> the reconstruction [H, W, 3]."""
    P, GX, GY = _planes(primal, gx, gy)
    a2 = alpha * alpha
    x = P
    for _ in range(outer):
        wx = 1.0 / torch.clamp_min((_dx(x) - GX).abs(), eps)
        wy = 1.0 / torch.clamp_min((_dy(x) - GY).abs(), eps)
        wp = 1.0 / torch.clamp_min((x - P).abs(), eps)

        def A(v, wx=wx, wy=wy, wp=wp):
            return _dxT(wx * _dx(v)) + _dyT(wy * _dy(v)) + a2 * wp * v
        x = _cg(A, _dxT(wx * GX) + _dyT(wy * GY) + a2 * wp * P, x, inner)
    return torch.movedim(x, 0, -1)
