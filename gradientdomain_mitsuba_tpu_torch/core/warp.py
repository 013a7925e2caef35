"""Sampling warps: [0,1)^2 -> disks, hemispheres, triangles and
microfacet half vectors.

Counterpart of gradientdomain_mitsuba_tpu/core/warp.py (Mitsuba's warp
namespace, src/libcore/warp.cpp), every warp of it.
"""
from __future__ import annotations

import math

import torch

PI = math.pi
INV_PI = 1.0 / math.pi
INV_TWOPI = 1.0 / (2.0 * math.pi)
INV_FOURPI = 1.0 / (4.0 * math.pi)


def square_to_uniform_disk_concentric(u):
    """Shirley-Chiu concentric mapping (warp::squareToUniformDiskConcentric)."""
    r1 = 2.0 * u[..., 0] - 1.0
    r2 = 2.0 * u[..., 1] - 1.0
    use_r1 = torch.abs(r1) > torch.abs(r2)
    r = torch.where(use_r1, r1, r2)
    phi = torch.where(
        use_r1,
        (PI / 4.0) * (r2 / torch.where(r1 == 0.0, 1.0, r1)),
        (PI / 2.0) - (PI / 4.0) * (r1 / torch.where(r2 == 0.0, 1.0, r2)),
    )
    phi = torch.where((r1 == 0.0) & (r2 == 0.0), 0.0, phi)
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi)], dim=-1)


def square_to_cosine_hemisphere(u):
    """Cosine-weighted hemisphere about +z via concentric disk lift."""
    p = square_to_uniform_disk_concentric(u)
    z = torch.sqrt(torch.clamp_min(1.0 - p[..., 0] ** 2 - p[..., 1] ** 2,
                                   0.0))
    return torch.stack([p[..., 0], p[..., 1], z], dim=-1)


def square_to_cosine_hemisphere_pdf(d):
    return torch.clamp_min(d[..., 2], 0.0) * INV_PI


def _z_to_direction(z, u1):
    r = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    phi = 2.0 * PI * u1
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def square_to_uniform_sphere(u):
    return _z_to_direction(1.0 - 2.0 * u[..., 0], u[..., 1])


def square_to_uniform_sphere_pdf():
    return INV_FOURPI


def square_to_uniform_hemisphere(u):
    return _z_to_direction(u[..., 0], u[..., 1])


def square_to_uniform_hemisphere_pdf():
    return INV_TWOPI


def square_to_uniform_cone(u, cos_cutoff):
    """Uniform direction in a cone of angle acos(cos_cutoff) about +z."""
    return _z_to_direction(1.0 - u[..., 0] * (1.0 - cos_cutoff), u[..., 1])


def square_to_uniform_cone_pdf(cos_cutoff):
    return INV_TWOPI / (1.0 - cos_cutoff)


def square_to_uniform_triangle(u):
    """Barycentric coords uniform on the unit triangle (matches
    warp::squareToUniformTriangle: a = sqrt(1-u1))."""
    a = torch.sqrt(torch.clamp_min(1.0 - u[..., 0], 0.0))
    return torch.stack([1.0 - a, a * u[..., 1]], dim=-1)


def square_to_beckmann(u, alpha):
    """Beckmann NDF-sampled half vector about +z (full-NDF sampling as in
    Mitsuba 0.5's microfacet.h; it predates VNDF sampling)."""
    phi = 2.0 * PI * u[..., 1]
    log_term = torch.log(torch.clamp_min(1.0 - u[..., 0], 1e-38))
    tan2theta = -(alpha ** 2) * log_term
    cos_theta = 1.0 / torch.sqrt(1.0 + tan2theta)
    sin_theta = torch.sqrt(torch.clamp_min(1.0 - cos_theta ** 2, 0.0))
    return torch.stack([sin_theta * torch.cos(phi),
                        sin_theta * torch.sin(phi), cos_theta], dim=-1)


def square_to_beckmann_pdf(d, alpha):
    ct = d[..., 2]
    ct2 = ct * ct
    tan2 = (1.0 - ct2) / torch.clamp_min(ct2, 1e-12)
    p = torch.exp(-tan2 / (alpha ** 2)) / (
        PI * alpha ** 2 * torch.clamp_min(ct2 * ct, 1e-12))
    return torch.where(ct > 1e-6, p, 0.0)


def square_to_ggx(u, alpha):
    """GGX (Trowbridge-Reitz) NDF-sampled half vector about +z (full
    NDF)."""
    phi = 2.0 * PI * u[..., 1]
    tan2theta = (alpha ** 2) * u[..., 0] / torch.clamp_min(1.0 - u[..., 0],
                                                           1e-12)
    cos_theta = 1.0 / torch.sqrt(1.0 + tan2theta)
    sin_theta = torch.sqrt(torch.clamp_min(1.0 - cos_theta ** 2, 0.0))
    return torch.stack([sin_theta * torch.cos(phi),
                        sin_theta * torch.sin(phi), cos_theta], dim=-1)


def square_to_ggx_pdf(d, alpha):
    ct = torch.clamp_min(d[..., 2], 0.0)
    a2 = alpha ** 2
    denom = ct * ct * (a2 - 1.0) + 1.0
    D = a2 / (PI * torch.clamp_min(denom * denom, 1e-20))
    return D * ct


def interval_to_tent(u):
    """[0,1) -> [-1,1] tent-distributed (tent reconstruction filter)."""
    lo = u < 0.5
    u2 = torch.where(lo, 2.0 * u, 2.0 * (1.0 - u))
    return torch.where(lo, 1.0, -1.0) * (1.0 - torch.sqrt(
        torch.clamp_min(u2, 0.0)))
