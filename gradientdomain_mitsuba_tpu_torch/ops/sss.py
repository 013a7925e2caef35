"""Classical dipole BSSRDF (Jensen et al. 2001): the device-side pieces.

Counterpart of gradientdomain_mitsuba_tpu/ops/sss.py (the `dipole`
subsurface plugin, src/subsurface/dipole.cpp with the irradiance octree
of src/subsurface/irrtree.cpp).  As in the reference, the cache is a
dense point set and a query sums over all of it, chunk by chunk:

  Mo(x) = sum_i Rd(|x - p_i|) * E_i * A_i
  Lo(x, w) = (1/pi) * Ft(eta, cos_o) * Mo(x)

The pairwise squared distances come from one [N,3] x [3,chunk] product
per chunk (torch.matmul at full float32: config.configure turns TF32
off), in the reference's chunk order, so the float32 sums agree.

Coefficients (per row, per RGB channel), classical dipole:
  sigma_s' = sigma_s (1-g)      sigma_t' = sigma_s' + sigma_a
  alpha'   = sigma_s'/sigma_t'  sigma_tr = sqrt(3 sigma_a sigma_t')
  Fdr(eta) = -1.440/eta^2 + 0.710/eta + 0.668 + 0.0636 eta   (eta > 1)
  A = (1+Fdr)/(1-Fdr)   z_r = 1/sigma_t'   z_v = z_r (1 + 4A/3)
  Rd(r) = alpha'/(4pi) [ z_r (1+s d_r) e^{-s d_r}/d_r^3
                       + z_v (1+s d_v) e^{-s d_v}/d_v^3 ],  s = sigma_tr
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..core import math as m
from ..core.rng import uniform_2d
from .emitter import _searchsorted_segment

# queries a block of eval_mo: bounds its [lanes, chunk, 3] temporaries
# (~200 MB each at chunk 256) on a 1M-lane pass
EVAL_LANES = 1 << 16


class DipoleCoeffs(NamedTuple):
    sigma_tr: torch.Tensor   # [R, 3]
    zr: torch.Tensor         # [R, 3]
    zv: torch.Tensor         # [R, 3]
    alpha_p: torch.Tensor    # [R, 3]
    eta: torch.Tensor        # [R]


def _host(x):
    """A table column as a float64 numpy array (tensors read once, when a
    tracer is built)."""
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def fdr(eta):
    """Average diffuse Fresnel reflectance, Egan & Hilgeman / Groenhuis
    rational fit (the fit fresnelDiffuseReflectance uses for its fast
    path)."""
    eta = np.asarray(eta, np.float64)
    return np.where(
        eta < 1.0,
        -0.4399 + 0.7099 / eta - 0.3319 / eta**2 + 0.0636 / eta**3,
        -1.4399 / eta**2 + 0.7099 / eta + 0.6681 + 0.0636 * eta)


def dipole_coeffs(table, device=None) -> DipoleCoeffs:
    """SSSTable -> per-row dipole coefficients, computed on the host in
    float64 and stored as float32 on `device` (default: the table's)."""
    if device is None:
        device = (table.sigma_s.device if torch.is_tensor(table.sigma_s)
                  else "cpu")
    ss = _host(table.sigma_s)
    sa = _host(table.sigma_a)
    g = _host(table.g)[:, None]
    eta = _host(table.eta)

    ssp = ss * (1.0 - g)
    stp = np.maximum(ssp + sa, 1e-12)
    alpha_p = ssp / stp
    sigma_tr = np.sqrt(3.0 * sa * stp)
    A = (1.0 + fdr(eta)) / np.maximum(1.0 - fdr(eta), 1e-6)
    zr = 1.0 / stp
    zv = zr * (1.0 + 4.0 / 3.0 * A[:, None])

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)
    return DipoleCoeffs(sigma_tr=f32(sigma_tr), zr=f32(zr), zv=f32(zv),
                        alpha_p=f32(alpha_p), eta=f32(eta))


def rd(r2, sigma_tr, zr, zv, alpha_p):
    """Diffuse reflectance Rd(r) for squared distance r2.

    All arguments broadcast; channels ride the last axis.  The d_r =
    sqrt(r^2 + z^2) form has no singularity at r = 0."""
    dr = torch.sqrt(r2 + zr * zr)
    dv = torch.sqrt(r2 + zv * zv)
    c1 = zr * (sigma_tr * dr + 1.0) * torch.exp(-sigma_tr * dr) / (
        dr * dr * dr)
    c2 = zv * (sigma_tr * dv + 1.0) * torch.exp(-sigma_tr * dv) / (
        dv * dv * dv)
    return alpha_p / (4.0 * math.pi) * (c1 + c2)


def rd_total(table, row):
    """Closed-form total diffuse reflectance integral (a test oracle)
    2 pi ∫ r Rd(r) dr = alpha'/2 (1 + e^{-4/3 A sqrt(3(1-alpha'))})
                        e^{-sqrt(3(1-alpha'))}."""
    ss = _host(table.sigma_s)[row]
    sa = _host(table.sigma_a)[row]
    g = float(_host(table.g)[row])
    eta = float(_host(table.eta)[row])
    ssp = ss * (1.0 - g)
    stp = ssp + sa
    ap = ssp / stp
    A = (1.0 + fdr(eta)) / (1.0 - fdr(eta))
    s3 = np.sqrt(3.0 * (1.0 - ap))
    return ap / 2.0 * (1.0 + np.exp(-4.0 / 3.0 * A * s3)) * np.exp(-s3)


def sample_surface_points(scene, n_points: int, seed):
    """n_points uniform-area points over the SSS rows' surfaces.

    Points go round-robin over the rows (i % R); the area weight A_i =
    total_area[row] / count[row] makes the Mo sum an unbiased area
    integral whatever the split.  Returns the cache dict: positions p,
    outward geometric normals n, rows and area weights aw (the tracer's
    irradiance pass adds E)."""
    table = scene.sss
    dev = table.tri_cdf.device
    R = int(table.shape.shape[0])
    ids = torch.arange(n_points, dtype=torch.int64, device=dev)
    row = (ids % R).to(torch.int32)
    counts = np.full(R, n_points // R, np.float32)
    counts[: n_points % R] += 1
    rl = row.long()
    aw = (table.total_area / torch.as_tensor(
        np.maximum(counts, 1), device=dev))[rl]

    u_tri = uniform_2d(seed ^ 0x55b, ids, 0, 7001)
    lo = table.tri_offset[rl]
    hi = lo + table.tri_count[rl]
    k = _searchsorted_segment(table.tri_cdf, lo, hi, u_tri[:, 0])
    k = torch.minimum(torch.maximum(k, lo.long()), hi.long() - 1)
    tri = table.tri_index[k].long()

    idx = scene.geom.indices[tri].long()                  # [P, 3]
    pos = scene.geom.positions
    v0 = pos[idx[:, 0]]
    v1 = pos[idx[:, 1]]
    v2 = pos[idx[:, 2]]
    su = torch.sqrt(torch.clamp_min(u_tri[:, 1:2], 1e-12))
    u_b = uniform_2d(seed ^ 0x9d1, ids, 0, 7003)[:, 0:1]
    b0 = 1.0 - su
    b1 = u_b * su
    p = v0 * b0 + v1 * b1 + v2 * (1.0 - b0 - b1)
    n = m.normalize(m.cross(v1 - v0, v2 - v0))
    return dict(p=p, n=n, row=row, aw=aw)


def eval_mo(cache, coeffs: DipoleCoeffs, q_p, q_row, chunk: int = 256):
    """Mo at query points [N, 3]: the sum over cache points of
    Rd(|q - p|; coeffs[q_row]) * E * A, restricted to the query's own
    row (q_row -1: a masked query, Mo 0).

    Chunked over the P cache points, padded to whole chunks with rows of
    -2 (they match neither a real row nor a masked query); each chunk's
    pairwise q.p dot products are one [N,3] x [3,chunk] product.  The
    queries go EVAL_LANES at a time (a query sums the same terms in the
    same chunk order whatever its block)."""
    if q_p.shape[0] > EVAL_LANES:
        return torch.cat([
            eval_mo(cache, coeffs, q_p[i:i + EVAL_LANES],
                    q_row[i:i + EVAL_LANES], chunk)
            for i in range(0, q_p.shape[0], EVAL_LANES)])
    P = cache["p"].shape[0]
    pad = (-P) % chunk
    dev = q_p.device
    pp = torch.nn.functional.pad(cache["p"], (0, 0, 0, pad))
    pe = torch.nn.functional.pad(cache["E"] * cache["aw"][:, None],
                                 (0, 0, 0, pad))
    prow = torch.nn.functional.pad(cache["row"], (0, pad), value=-2)

    qr = torch.clamp_min(q_row, 0).long()
    s_tr = coeffs.sigma_tr[qr][:, None, :]    # [N, 1, 3]
    zr = coeffs.zr[qr][:, None, :]
    zv = coeffs.zv[qr][:, None, :]
    ap = coeffs.alpha_p[qr][:, None, :]
    q2 = torch.sum(q_p * q_p, -1)              # [N]

    mo = torch.zeros((q_p.shape[0], 3), device=dev)
    for c0 in range(0, P + pad, chunk):
        cp = pp[c0:c0 + chunk]
        ce = pe[c0:c0 + chunk]
        crow = prow[c0:c0 + chunk]
        dot = q_p @ cp.T                                       # [N, chunk]
        r2 = torch.clamp_min(q2[:, None] - 2.0 * dot +
                             torch.sum(cp * cp, -1)[None, :], 0.0)
        same = crow[None, :] == q_row[:, None]
        val = rd(r2[..., None], s_tr, zr, zv, ap)             # [N, chunk, 3]
        val = torch.where(same[..., None], val, 0.0)
        mo = mo + torch.sum(val * ce, dim=1)
    return mo
