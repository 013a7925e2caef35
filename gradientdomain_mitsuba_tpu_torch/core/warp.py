"""Sampling warps: [0,1)^2 -> disks, hemispheres, triangles.

Counterpart of gradientdomain_mitsuba_tpu/core/warp.py (Mitsuba's warp
namespace, src/libcore/warp.cpp) for the warps the G-PT slice uses.
"""
from __future__ import annotations

import math

import torch

PI = math.pi
INV_PI = 1.0 / math.pi


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


def square_to_uniform_triangle(u):
    """Barycentric coords uniform on the unit triangle (matches
    warp::squareToUniformTriangle: a = sqrt(1-u1))."""
    a = torch.sqrt(torch.clamp_min(1.0 - u[..., 0], 0.0))
    return torch.stack([1.0 - a, a * u[..., 1]], dim=-1)
