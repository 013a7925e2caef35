"""Participating-media ops: free-flight sampling, transmittance, phase
functions and the density-grid (tracking) estimators.

Counterpart of gradientdomain_mitsuba_tpu/ops/medium.py
(Medium::sampleDistance / evalTransmittance and PhaseFunction::{sample,
eval,pdf}, src/medium/{homogeneous,heterogeneous}.cpp,
src/phase/{isotropic,hg,rayleigh,microflake}.cpp) as branch-free SoA
functions over medium-id lanes.  Lanes with mid < 0 are vacuum: no
scatter, unit transmittance.

Channel strategy: the free-flight distance importance-samples one RGB
channel's sigma_t, the channel picked uniformly; success/failure pdfs
average over channels (homogeneous.cpp's spectral-MIS estimator).

The reference's tracking loops are jax.lax.fori_loops over a fixed
n_steps; here they are Python loops over tensors, step k draws its
uniforms from u_step(k) at the reference's dimensions, and the loop
stops once every lane is done (a done lane never changes again, so the
result is the fixed-trip loop's).  Callers pass mid = -1 on lanes whose
result they discard, which are then done from the start.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core import math as m
from ..scene.media import (PHASE_HG, PHASE_ISOTROPIC, PHASE_MICROFLAKE,
                           PHASE_RAYLEIGH)

INV_4PI = 1.0 / (4.0 * math.pi)
F32_BIG = 3e38


def _row(media, mid):
    """Row index of each lane (vacuum lanes read row 0)."""
    return torch.clamp(mid, 0, media.sigma_s.shape[0] - 1).long()


def gather(media, mid):
    """Per-lane medium coefficients; vacuum (mid<0) lanes get zeros.
    Returns (sigma_s, sigma_t, phase kind, g, flake)."""
    idx = _row(media, mid)
    vac = (mid < 0)[..., None]
    sigma_s = torch.where(vac, 0.0, media.sigma_s[idx])
    sigma_t = torch.where(vac, 0.0, media.sigma_t[idx])
    g = torch.where(mid < 0, 0.0, media.g[idx])
    kind = torch.where(mid < 0, PHASE_ISOTROPIC, media.phase_kind[idx])
    flake = media.flake[idx]
    return sigma_s, sigma_t, kind, g, flake


def transmittance(sigma_t, dist):
    """exp(-sigma_t * dist) per channel; dist may be +inf-ish."""
    return torch.exp(-sigma_t * torch.clamp_max(dist, F32_BIG)[..., None])


class DistanceSample(NamedTuple):
    scattered: torch.Tensor  # [N] bool: medium event before tmax
    t: torch.Tensor          # [N] scatter distance (valid when scattered)
    weight: torch.Tensor     # [N, 3] throughput factor:
    #                          scattered: sigma_s*Tr(t)/pdf_succ
    #                          else:      Tr(tmax)/pdf_fail


def _exp_step(u, mu):
    """-ln(1-u)/mu, u clamped below 1."""
    return -torch.log1p(-torch.clamp(u, 0.0, 1.0 - 1e-7)) / torch.clamp_min(
        mu, 1e-20)


def sample_distance(sigma_s, sigma_t, u_chan, u_dist, tmax):
    """Free-flight sampling through a homogeneous slab of length tmax.
    Lanes with sigma_t == 0 (vacuum or pure void) never scatter and get
    unit weight."""
    chan = torch.clamp((u_chan * 3.0).to(torch.int32), 0, 2)
    st_c = torch.gather(sigma_t, -1, chan.long()[..., None])[..., 0]
    active = st_c > 0
    t = _exp_step(u_dist, st_c)
    scattered = active & (t < tmax)

    tr_t = transmittance(sigma_t, t)
    tr_max = transmittance(sigma_t, tmax)
    pdf_succ = torch.mean(sigma_t * tr_t, -1)
    pdf_fail = torch.mean(tr_max, -1)
    w_scatter = sigma_s * tr_t / torch.clamp_min(pdf_succ, 1e-30)[..., None]
    w_pass = tr_max / torch.clamp_min(pdf_fail, 1e-30)[..., None]
    weight = torch.where(scattered[..., None], w_scatter,
                         torch.where(active[..., None], w_pass, 1.0))
    return DistanceSample(scattered=scattered, t=t, weight=weight)


# ---------------------------------------------------------------------------
# Phase functions: all exactly importance-sampled, so eval == pdf and the
# sampling weight is 1 (PhaseFunction::sample semantics).
# ---------------------------------------------------------------------------

def _hg_pdf(cos_theta, g):
    denom = 1.0 + g * g + 2.0 * g * cos_theta
    return INV_4PI * (1.0 - g * g) / torch.clamp_min(
        denom * torch.sqrt(torch.clamp_min(denom, 1e-12)), 1e-12)


def _rayleigh_pdf(cos_theta):
    return (3.0 / (16.0 * math.pi)) * (1.0 + cos_theta * cos_theta)


# --- SGGX microflakes (fiber) ----------------------------------------------
# S = w w^T sigma^2 + (I - w w^T): S v = v + (sigma^2 - 1)(w.v) w, so every
# quadratic form is a closed-form dot product.  Specular (mirror) flakes:
# phase = D(h) / (4 sigma(wi)).

def _sggx_dot(flake, a, b):
    w = flake[..., 0:3]
    s2 = flake[..., 3] ** 2
    return m.dot(a, b) + (s2 - 1.0) * m.dot(w, a) * m.dot(w, b)


def _sggx_ndf(flake, mv):
    """D(m) = 1 / (pi sqrt(det S) (m^T S^-1 m)^2); sqrt(det S) = sigma."""
    w = flake[..., 0:3]
    sig = torch.clamp_min(flake[..., 3], 1e-3)
    c = m.dot(w, mv)
    q = c * c / (sig * sig) + (1.0 - c * c)
    return 1.0 / (math.pi * sig * torch.clamp_min(q * q, 1e-12))


def _sggx_proj(flake, d):
    """Projected flake area sigma(d) = sqrt(d^T S d)."""
    return torch.sqrt(torch.clamp_min(_sggx_dot(flake, d, d), 1e-12))


def _sggx_eval(flake, wi, wo):
    h = m.normalize(wi + wo)
    return _sggx_ndf(flake, h) / (4.0 * _sggx_proj(flake, wi))


def _sggx_sample(flake, wi, u2):
    """Exact visible-normal sampling (Heitz et al. 2015): a flake normal
    from the projected-area-weighted NDF, then a mirror reflection."""
    i = wi
    k, j = m.build_frame(i)
    skk = _sggx_dot(flake, k, k)
    skj = _sggx_dot(flake, k, j)
    ski = _sggx_dot(flake, k, i)
    sjj = _sggx_dot(flake, j, j)
    sji = _sggx_dot(flake, j, i)
    sii = _sggx_dot(flake, i, i)
    sqrt_det = torch.clamp_min(flake[..., 3], 1e-3)
    tmp = torch.sqrt(torch.clamp_min(sjj * sii - sji * sji, 1e-12))
    isq = 1.0 / torch.sqrt(torch.clamp_min(sii, 1e-12))
    zero = torch.zeros_like(tmp)
    mk = torch.stack([sqrt_det / tmp, zero, zero], -1)
    mj = torch.stack([-isq * (ski * sji - skj * sii) / tmp, isq * tmp,
                      zero], -1)
    mi = torch.stack([isq * ski, isq * sji, isq * sii], -1)
    r = torch.sqrt(torch.clamp(u2[..., 0], 0.0, 1.0))
    phi = 2.0 * math.pi * u2[..., 1]
    pu = (r * torch.cos(phi))[..., None]
    pv = (r * torch.sin(phi))[..., None]
    pw = torch.sqrt(torch.clamp_min(1.0 - u2[..., 0], 0.0))[..., None]
    m_kji = m.normalize(pu * mk + pv * mj + pw * mi)
    mv = (k * m_kji[..., 0:1] + j * m_kji[..., 1:2] + i * m_kji[..., 2:3])
    wo = -wi + 2.0 * m.dot(wi, mv)[..., None] * mv
    return m.normalize(wo)


def phase_eval(kind, g, wi, wo, flake=None):
    """Phase value == pdf of sampling wo given wi.  wi points back toward
    the previous vertex, wo is the new propagation direction:
    cos(alpha) = dot(-wi, wo); HG with g > 0 peaks forward."""
    cos_alpha = m.dot(-wi, wo)
    iso = torch.full_like(cos_alpha, INV_4PI)
    hg = _hg_pdf(-cos_alpha, g)
    ray = _rayleigh_pdf(cos_alpha)
    out = torch.where(kind == PHASE_HG, hg,
                      torch.where(kind == PHASE_RAYLEIGH, ray, iso))
    if flake is not None:
        out = torch.where(kind == PHASE_MICROFLAKE,
                          _sggx_eval(flake, wi, wo), out)
    return out


def _sphere_dir(u2):
    z = 1.0 - 2.0 * u2[..., 0]
    r = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    phi = 2.0 * math.pi * u2[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], -1)


def phase_sample(kind, g, wi, u2, flake=None):
    """Sample wo around the propagation direction -wi.  Returns (wo,
    pdf); the weight is 1."""
    prop = -wi
    wo_iso = _sphere_dir(u2)

    # Henyey-Greenstein inversion (hg.cpp): cos_theta wrt propagation
    g_safe = torch.where(torch.abs(g) < 1e-3, 1e-3, g)
    sqr = (1.0 - g_safe * g_safe) / (1.0 - g_safe + 2.0 * g_safe *
                                     u2[..., 0])
    cos_hg = (1.0 + g_safe * g_safe - sqr * sqr) / (2.0 * g_safe)
    cos_iso = 1.0 - 2.0 * u2[..., 0]
    cos_theta = torch.where(torch.abs(g) < 1e-3, cos_iso,
                            torch.clamp(cos_hg, -1.0, 1.0))

    # Rayleigh: the cubic CDF inversion (rayleigh.cpp); its argument
    # z + sqrt(z^2 + 1) is positive, so the real cube root is a power
    z = 2.0 * (2.0 * u2[..., 0] - 1.0)
    A = torch.pow(z + torch.sqrt(z * z + 1.0), 1.0 / 3.0)
    cos_ray = torch.clamp(A - 1.0 / A, -1.0, 1.0)

    cos_t = torch.where(kind == PHASE_RAYLEIGH, cos_ray, cos_theta)
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    phi = 2.0 * math.pi * u2[..., 1]
    s, t = m.build_frame(prop)
    wo_aniso = (s * (sin_t * torch.cos(phi))[..., None] +
                t * (sin_t * torch.sin(phi))[..., None] +
                prop * cos_t[..., None])
    wo = torch.where((kind == PHASE_ISOTROPIC)[..., None], wo_iso, wo_aniso)
    if flake is not None:
        wo = torch.where((kind == PHASE_MICROFLAKE)[..., None],
                         _sggx_sample(flake, wi, u2), wo)
    return wo, phase_eval(kind, g, wi, wo, flake)


# ---------------------------------------------------------------------------
# Heterogeneous media: trilinear density lookup + spectral delta tracking
# against the per-row majorant (heterogeneous.cpp Woodcock tracking, with
# a fixed step budget whose lanes mask out once they scatter or escape).
# ---------------------------------------------------------------------------

def _grid_locator(w2g, res, stride):
    """For lanes with world-to-grid transforms w2g [N, 4, 4] and grid
    resolutions res [N, 3], a function of world points p [N, 3] giving
    (inside [N] bool, the eight corners' cell indices (z*ny + y)*nx + x
    times stride [N, 4, 2] — rows (z0,y0) (z0,y1) (z1,y0) (z1,y1),
    columns x0, x1 — and the weights (tx, ty, tz)): gridvolume.cpp's
    texel-center lookup convention.  The lanes' constants are set up
    once, for loops that look up the same lanes many times."""
    A = w2g[:, :3, :3]
    b = w2g[:, :3, 3]
    last = [res[:, i] - 1 for i in range(3)]
    hi = [n.to(torch.float32) for n in last]
    zero = torch.zeros_like(hi[0])
    nx, ny = res[:, 0:1], res[:, 1]

    def locate(p):
        q = torch.einsum("nij,nj->ni", A, p) + b
        inside = torch.all((q >= 0.0) & (q <= 1.0), -1)
        lo, up, w = [], [], []
        for i in range(3):
            f = torch.clamp(q[:, i] * last[i], zero, hi[i])
            i0 = torch.floor(f).to(torch.int32)
            lo.append(i0)
            up.append(torch.minimum(i0 + 1, last[i]))
            w.append(f - i0)
        (x0, y0, z0), (x1, y1, z1) = lo, up
        zy = torch.stack([z0 * ny + y0, z0 * ny + y1, z1 * ny + y0,
                          z1 * ny + y1], -1) * nx
        cell = zy[:, :, None] + torch.stack([x0, x1], -1)[:, None, :]
        return inside, stride * cell, w
    return locate


def _blend(v, w):
    """Trilinear blend of corner values v [N, 4, 2, ...] with weights
    (tx, ty, tz), each shaped to broadcast against v[:, 0, 0], in the
    reference's order: along x, then y, then z."""
    tx, ty, tz = (t[:, None] for t in w)
    c = v[:, :, 0] * (1 - tx) + v[:, :, 1] * tx       # c00 c01 c10 c11
    c = c[:, 0::2] * (1 - ty) + c[:, 1::2] * ty       # c0 c1
    return c[:, 0] * (1 - tz[:, 0]) + c[:, 1] * tz[:, 0]


def density_lookup(media, mid):
    """density_at for fixed lanes: the lanes' rows are gathered once, the
    returned function maps world points p [N, 3] to densities [N]."""
    idx = _row(media, mid)
    locate = _grid_locator(media.world_to_grid[idx], media.grid_res[idx], 1)
    off = media.grid_offset[idx][:, None, None]
    het = (media.het[idx] > 0) & (mid >= 0)

    def lookup(p):
        inside, cells, w = locate(p)
        dens = _blend(media.grid_data[(off + cells).long()], w)
        dens = torch.where(inside, dens, 0.0)
        return torch.where(het, dens, 1.0)
    return lookup


def density_at(media, mid, p):
    """Scalar density at world points p [N, 3] for each lane's medium.
    Homogeneous rows (het == 0) return 1; points outside the [0,1]^3
    volume frame return 0 (gridvolume.cpp zero-extension)."""
    return density_lookup(media, mid)(p)


def flake_at(media, mid, p):
    """Per-lane SGGX flake [N, 4] with a gridvolume-driven fiber axis
    (trilinear interpolation of the orientation field, transformed to
    world space, then normalized: gridvolume.cpp lookupVector).  Rows
    without an orientation grid, points outside the volume and degenerate
    interpolated vectors fall back to the row's constant axis."""
    idx = _row(media, mid)
    fl = media.flake[idx]
    off = media.orient_offset[idx]
    inside, cells, w = _grid_locator(media.orient_w2g[idx],
                                     media.orient_res[idx], 3)(p)
    flat = (torch.clamp_min(off, 0)[:, None, None, None] + cells[..., None]
            + torch.arange(3, device=p.device))
    v = _blend(media.orient_data[flat.long()], [t[:, None] for t in w])
    v = torch.einsum("nij,nj->ni", media.orient_l2w[idx], v)
    norm = torch.sqrt(torch.clamp_min(m.squared_length(v), 0.0))
    ok = (off >= 0) & inside & (norm > 1e-6)
    axis = torch.where(ok[..., None],
                       v / torch.clamp_min(norm, 1e-12)[..., None],
                       fl[..., 0:3])
    return torch.cat([axis, fl[..., 3:4]], -1)


def _majorant(media, mid):
    """Scalar majorant extinction per lane: max_density * max_c sigma_t."""
    idx = _row(media, mid)
    mu = media.max_density[idx] * torch.amax(media.sigma_t[idx], -1)
    return torch.where(mid >= 0, mu, 0.0)


def sample_distance_tracking(media, mid, o, d, tmax, u_step, n_steps):
    """Spectral delta tracking (Kutz et al. 2017) through a
    density-modulated medium.  u_step(k) returns [N, 2] uniforms for step
    k.  Same DistanceSample contract as sample_distance; lanes whose step
    budget (`trackingSteps`) runs out escape with their accumulated
    weight."""
    N = mid.shape[0]
    dev = o.device
    sigma_s_u, sigma_t_u, _, _, _ = gather(media, mid)
    mu = _majorant(media, mid)
    active0 = mu > 0.0
    density = density_lookup(media, mid)

    t = torch.zeros(N, device=dev)
    w = torch.ones((N, 3), device=dev)
    scattered = torch.zeros(N, dtype=torch.bool, device=dev)
    done = ~active0
    for k in range(n_steps):
        if bool(done.all()):
            break
        u = u_step(k)
        t_new = t + _exp_step(u[:, 0], mu)
        escape = t_new >= tmax
        dens = density(o + d * t_new[..., None])
        s_t = sigma_t_u * dens[..., None]
        s_s = sigma_s_u * dens[..., None]
        p_real = torch.clamp(torch.mean(s_t, -1) /
                             torch.clamp_min(mu, 1e-20), 0.0, 1.0)
        real = u[:, 1] < p_real
        w_real = s_s / torch.clamp_min(mu * p_real, 1e-20)[..., None]
        s_n = torch.clamp_min(mu[..., None] - s_t, 0.0)
        w_null = s_n / torch.clamp_min(mu * (1.0 - p_real),
                                       1e-20)[..., None]

        live = ~done
        upd_scatter = live & ~escape & real
        upd_null = live & ~escape & ~real
        w = torch.where(upd_scatter[..., None], w * w_real, w)
        w = torch.where(upd_null[..., None], w * w_null, w)
        t = torch.where(live, torch.minimum(t_new, tmax), t)
        scattered = scattered | upd_scatter
        done = done | (live & (escape | real))
    return DistanceSample(scattered=scattered, t=t,
                          weight=torch.where(active0[..., None], w, 1.0))


def transmittance_tracking(media, mid, o, d, dist, u_step, n_steps):
    """Ratio-tracking transmittance estimator [N, 3] along (o, d, dist)
    (the unbiased analog of evalTransmittance for density grids)."""
    N = mid.shape[0]
    _, sigma_t_u, _, _, _ = gather(media, mid)
    mu = _majorant(media, mid)
    active0 = mu > 0.0
    density = density_lookup(media, mid)

    t = torch.zeros(N, device=o.device)
    w = torch.ones((N, 3), device=o.device)
    done = ~active0
    for k in range(n_steps):
        if bool(done.all()):
            break
        u = u_step(k)
        t_new = t + _exp_step(u[:, 0], mu)
        escape = t_new >= dist
        dens = density(o + d * t_new[..., None])
        s_t = sigma_t_u * dens[..., None]
        ratio = torch.clamp(1.0 - s_t / torch.clamp_min(mu, 1e-20)[..., None],
                            0.0, 1.0)
        live = ~done
        w = torch.where((live & ~escape)[..., None], w * ratio, w)
        t = torch.where(live, t_new, t)
        done = done | (live & escape)
    return torch.where(active0[..., None], w, 1.0)
