"""Emitter sampling and evaluation (NEE front door), area lights.

Counterpart of gradientdomain_mitsuba_tpu/ops/emitter.py (Scene::
sampleEmitterDirect / pdfEmitterDirect, src/emitters/area.cpp).  Mitsuba
0.5 picks among emitters uniformly; an area emitter samples its surface
uniformly by area (per-triangle CDF), then the pdf is converted to solid
angle at the reference point.  Delta lights and environment emitters are
not ported yet (ROADMAP Queue 1 item 14): sample_direct raises for them,
and the environment functions only cover env_kind == 0 (no environment).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core import math as m
from ..core import warp

ENV_NONE, ENV_CONSTANT, ENV_MAP = 0, 1, 2


class DirectSample(NamedTuple):
    d: torch.Tensor          # [N, 3] direction ref -> emitter
    dist: torch.Tensor       # [N] distance (shadow-ray length)
    pdf: torch.Tensor        # [N] solid-angle pdf incl. emitter pick prob
    radiance: torch.Tensor   # [N, 3] emitted radiance toward ref
    n: torch.Tensor          # [N, 3] emitter normal
    valid: torch.Tensor      # [N] bool
    # gradient-domain extras (G-PT shift machinery):
    p: torch.Tensor = None         # [N, 3] sampled emitter position
    pdf_area: torch.Tensor = None  # [N] area-measure pdf incl. pick prob
    is_env: torch.Tensor = None    # [N] bool — sample is on the env emitter
    is_delta: torch.Tensor = None  # [N] bool — point/spot/directional


def _searchsorted_segment(cdf, lo, hi, u, iters=None):
    """Vectorized lower-bound binary search of u in cdf[lo:hi] (flat CDF
    with per-emitter segments).  Returns the index into the flat array.
    `iters` defaults to ceil(log2(len(cdf)))+1 (the CDF length is fixed
    at scene build)."""
    lo = lo.to(torch.int64)
    hi = hi.to(torch.int64)
    if iters is None:
        iters = max(1, int(math.ceil(math.log2(max(int(cdf.shape[0]), 2))))
                    + 1)
    for _ in range(iters):
        mid = (lo + hi) // 2
        go_right = cdf[mid] < u
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(go_right, hi, mid)
    return lo


def sample_emitter_triangle(scene, flat, u_pos):
    """Position + unit normal on the flat-indexed emitter triangle (one
    packed row gather of EmitterTable.tri_geo = p0 | e1 | e2 | ng)."""
    row = scene.emitters.tri_geo[flat]
    bary = warp.square_to_uniform_triangle(u_pos)
    pos = (row[..., 0:3] + bary[..., 0:1] * row[..., 3:6] +
           bary[..., 1:2] * row[..., 6:9])
    return pos, row[..., 9:12]


def sample_direct(scene, n_area: int, env_kind: int, p_ref, u_sel, u_pos,
                  n_delta: int = 0):
    """NEE sample toward one uniformly-picked area emitter.

    n_area is static (from the scene); p_ref [N,3]; u_sel [N]; u_pos [N,2].
    Delta lights and environments raise (ROADMAP Queue 1 item 14)."""
    if n_delta > 0 or env_kind != ENV_NONE:
        raise NotImplementedError(
            "delta lights / environment emitters: ROADMAP Queue 1 item 14")
    em = scene.emitters
    n_total = n_area
    if n_total == 0:
        z = torch.zeros_like(p_ref)
        zero = torch.zeros(p_ref.shape[:-1], device=p_ref.device)
        no = zero > 1
        return DirectSample(d=z, dist=zero, pdf=zero, radiance=z, n=z,
                            valid=no, p=z, pdf_area=zero, is_env=no,
                            is_delta=no)
    pick_pdf = 1.0 / n_total
    idx = torch.clamp_max((u_sel * n_total).to(torch.int32), n_total - 1)
    # reuse u_sel within its stratum for the picked emitter's tri selection
    u_resc = torch.clamp(u_sel * n_total - idx.to(u_sel.dtype), 0.0, 1.0)
    e = torch.clamp_max(idx, max(n_area - 1, 0)).long()

    off = em.tri_offset[e]
    cnt = em.tri_count[e]
    flat = _searchsorted_segment(em.tri_cdf, off, off + cnt - 1, u_resc)
    pos, ng = sample_emitter_triangle(scene, flat, u_pos)

    to_l = pos - p_ref
    dist2 = torch.clamp_min(m.squared_length(to_l), 1e-12)
    dist = torch.sqrt(dist2)
    d = to_l / dist[..., None]
    cos_l = -m.dot(d, ng)
    area = em.total_area[e]
    pdf_area = 1.0 / torch.clamp_min(area, 1e-12)
    pdf_sa = pick_pdf * pdf_area * dist2 / torch.clamp_min(cos_l, 1e-9)
    rad = em.radiance[e]
    valid_area = cos_l > 1e-6
    no = torch.zeros_like(valid_area)
    return DirectSample(d=d, dist=dist, pdf=pdf_sa, radiance=rad, n=ng,
                        valid=valid_area, p=pos, pdf_area=pick_pdf * pdf_area,
                        is_env=no, is_delta=no)


def eval_env(scene, env_kind, d):
    """Environment radiance along direction d [N,3] (escaped rays): zero
    without an environment; other kinds raise (ROADMAP Queue 1 item 14)."""
    if env_kind != ENV_NONE:
        raise NotImplementedError("environment emitters: ROADMAP Queue 1 "
                                  "item 14")
    return torch.zeros(d.shape[:-1] + (3,), dtype=d.dtype, device=d.device)


def pdf_env_direct(scene, n_area: int, env_kind: int, d, n_delta: int = 0):
    """Solid-angle pdf of sample_direct choosing direction d on the
    environment: zero without an environment."""
    if env_kind != ENV_NONE:
        raise NotImplementedError("environment emitters: ROADMAP Queue 1 "
                                  "item 14")
    return torch.zeros(d.shape[:-1], dtype=d.dtype, device=d.device)


def pdf_area_direct(scene, n_area: int, has_env: bool, emitter_id, p_ref,
                    p_hit, ng_hit, n_delta: int = 0):
    """Solid-angle pdf that NEE would have sampled the point p_hit on area
    emitter emitter_id from p_ref (MIS weight for BSDF-sampled emitter
    hits)."""
    n_total = n_area + n_delta + (1 if has_env else 0)
    if n_total == 0:
        return torch.zeros(p_ref.shape[:-1], dtype=p_ref.dtype,
                           device=p_ref.device)
    to_l = p_hit - p_ref
    dist2 = torch.clamp_min(m.squared_length(to_l), 1e-12)
    d = to_l / torch.sqrt(dist2)[..., None]
    cos_l = -m.dot(d, ng_hit)
    area = scene.emitters.total_area[torch.clamp_min(emitter_id, 0).long()]
    pdf = dist2 / (torch.clamp_min(cos_l, 1e-9) *
                   torch.clamp_min(area, 1e-12))
    pdf = pdf / n_total
    return torch.where((emitter_id >= 0) & (cos_l > 1e-6), pdf, 0.0)
