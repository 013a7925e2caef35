"""Emitter sampling and evaluation (NEE front door): area lights, delta
lights and the environment.

Counterpart of gradientdomain_mitsuba_tpu/ops/emitter.py (Scene::
sampleEmitterDirect / pdfEmitterDirect / evalEnvironment, src/emitters/
{area,point,spot,directional,collimated,constant,envmap}.cpp).  Mitsuba
0.5 picks among emitters uniformly, in the order areas, delta lights,
environment; an area emitter samples its surface uniformly by area
(per-triangle CDF), then the pdf is converted to solid angle at the
reference point; a delta light's pdf is its pick probability; the
constant environment samples the uniform sphere, the envmap a texel
from its luminance CDF (rows, then columns of the row) and looks up
radiance bilinearly.  Sun, sky and sunsky arrive as an envmap baked by
scene/sunsky.py.
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


def search_iters(n):
    """Steps of _searchsorted_segment's search over a flat CDF of n
    entries: ceil(log2(n)) + 1 (the CDF length is fixed at scene
    build)."""
    return max(1, int(math.ceil(math.log2(max(int(n), 2)))) + 1)


def _searchsorted_segment(cdf, lo, hi, u, iters=None):
    """Vectorized lower-bound binary search of u in cdf[lo:hi] (flat CDF
    with per-emitter segments).  Returns the index into the flat array.
    `iters` defaults to search_iters(len(cdf))."""
    lo = lo.to(torch.int64)
    hi = hi.to(torch.int64)
    if iters is None:
        iters = search_iters(cdf.shape[0])
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
    """NEE sample toward one uniformly-picked emitter: the n_area area
    emitters, then the n_delta delta lights, then the environment (pick
    order of the reference; n_area, n_delta and env_kind are static and
    absent branches are skipped).  p_ref [N,3]; u_sel [N]; u_pos [N,2]."""
    has_env = env_kind != ENV_NONE
    em = scene.emitters
    n_total = n_area + n_delta + (1 if has_env else 0)
    z = torch.zeros_like(p_ref)
    zero = torch.zeros(p_ref.shape[:-1], device=p_ref.device)
    no = zero > 1
    out = DirectSample(d=z, dist=zero, pdf=zero, radiance=z, n=z, valid=no,
                       p=z, pdf_area=zero, is_env=no, is_delta=no)
    if n_total == 0:
        return out
    pick_pdf = 1.0 / n_total
    idx = torch.clamp_max((u_sel * n_total).to(torch.int32), n_total - 1)
    # reuse u_sel within its stratum for the picked emitter's tri selection
    u_resc = torch.clamp(u_sel * n_total - idx.to(u_sel.dtype), 0.0, 1.0)
    is_env = idx == n_area + n_delta if has_env else no
    is_delta = ((idx >= n_area) & (idx < n_area + n_delta) if n_delta > 0
                else no)

    if n_area > 0:
        e = torch.clamp_max(idx, n_area - 1).long()
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
        out = DirectSample(d=d, dist=dist, pdf=pdf_sa, radiance=em.radiance[e],
                           n=ng, valid=cos_l > 1e-6, p=pos,
                           pdf_area=pick_pdf * pdf_area, is_env=no,
                           is_delta=no)
    if n_delta > 0:
        out = _sample_delta(em, n_area, n_delta, pick_pdf, idx, is_delta,
                            p_ref, out)
    if not has_env:
        return out

    d_env, pdf_env, rad_env = _sample_env(scene, env_kind, u_pos)
    pdf_env = pick_pdf * pdf_env
    e3 = is_env[..., None]
    return DirectSample(
        d=torch.where(e3, d_env, out.d),
        dist=torch.where(is_env, 1e7, out.dist),
        pdf=torch.where(is_env, pdf_env, out.pdf),
        radiance=torch.where(e3, rad_env, out.radiance),
        n=torch.where(e3, -d_env, out.n),
        valid=torch.where(is_env, pdf_env > 0, out.valid),
        p=torch.where(e3, 0.0, out.p),
        pdf_area=torch.where(is_env, 0.0, out.pdf_area),
        is_env=is_env, is_delta=out.is_delta)


def _sample_delta(em, n_area, n_delta, pick_pdf, idx, is_delta, p_ref,
                  out):
    """The delta-light lanes of sample_direct: point and spot lights at
    their position with 1/d^2 falloff (the spot's smooth falloff between
    cos_falloff and cos_total, spot.cpp), a directional light along its
    fixed direction at distance 1e7 with its irradiance, and a collimated
    beam at zero (doubly delta: NEE never reaches it).  pdf and pdf_area
    are the pick probability ('unified discrete' measure)."""
    de = torch.clamp(idx - n_area, 0, n_delta - 1).long()
    kind = em.delta_kind[de]
    dpos = em.delta_pos[de]
    inten = em.delta_intensity[de]
    ddir = em.delta_dir[de]
    is_dir = kind == 2
    to_l = dpos - p_ref
    dist2 = torch.clamp_min(m.squared_length(to_l), 1e-12)
    dist = torch.sqrt(dist2)
    dd = torch.where(is_dir[..., None], -ddir, to_l / dist[..., None])
    dist = torch.where(is_dir, 1e7, dist)
    val = torch.where(is_dir[..., None], inten, inten / dist2[..., None])
    cosd = m.dot(-dd, ddir)
    ct = em.delta_cos_total[de]
    cf = em.delta_cos_falloff[de]
    fall = torch.clamp((cosd - ct) / torch.clamp_min(cf - ct, 1e-6), 0.0,
                       1.0)
    spot_f = torch.where(kind == 1, torch.where(cosd > ct, fall, 0.0), 1.0)
    val = torch.where((kind == 3)[..., None], 0.0, val * spot_f[..., None])
    d3 = is_delta[..., None]
    return DirectSample(
        d=torch.where(d3, dd, out.d),
        dist=torch.where(is_delta, dist, out.dist),
        pdf=torch.where(is_delta, pick_pdf, out.pdf),
        radiance=torch.where(d3, val, out.radiance),
        n=torch.where(d3, -dd, out.n),
        valid=torch.where(is_delta, val.amax(-1) > 0, out.valid),
        p=torch.where(d3, dpos, out.p),
        pdf_area=torch.where(is_delta, pick_pdf, out.pdf_area),
        is_env=out.is_env, is_delta=is_delta)


def _sample_env(scene, env_kind, u2):
    """Environment direction: the uniform sphere for the constant
    environment; for the envmap a texel from the luminance CDF, the row
    by the marginal CDF, then the column by the row's conditional CDF
    (each the last entry <= u, searchsorted right - 1).  Returns (world
    direction, solid-angle pdf, radiance)."""
    em = scene.emitters
    if env_kind == ENV_CONSTANT:
        d = warp.square_to_uniform_sphere(u2)
        pdf = torch.full(u2.shape[:-1], warp.square_to_uniform_sphere_pdf(),
                         device=u2.device)
        return d, pdf, em.env_radiance.expand(u2.shape[:-1] + (3,))
    He, We = em.env_map.shape[:2]
    row = torch.clamp(torch.searchsorted(
        em.env_cdf_rows, u2[..., 0].contiguous(), right=True) - 1, 0, He - 1)
    col = torch.searchsorted(em.env_cdf_cols[row],
                             u2[..., 1:2].contiguous(), right=True)[..., 0]
    col = torch.clamp(col - 1, 0, We - 1)
    theta = (row.to(torch.float32) + 0.5) / He * math.pi
    phi = (col.to(torch.float32) + 0.5) / We * 2 * math.pi
    d = m.transform_vector(em.env_to_world, m.spherical_direction(theta, phi))
    return d, em.env_pdf[row, col], em.env_map[row, col] * em.env_radiance


def _env_coords(scene, d):
    """(theta, phi) of world direction d in the envmap's frame."""
    dl = m.normalize(m.transform_vector(scene.emitters.env_world_to_local,
                                        d))
    return m.spherical_coordinates(dl)


def eval_env(scene, env_kind, d):
    """Environment radiance along direction d [N,3] (escaped rays): zero
    without an environment, the constant radiance, or the envmap's
    bilinear lookup (wrapping in phi, clamped in theta) times its
    scale."""
    if env_kind == ENV_NONE:
        return torch.zeros(d.shape[:-1] + (3,), dtype=d.dtype,
                           device=d.device)
    if env_kind == ENV_CONSTANT:
        return scene.emitters.env_radiance.expand(d.shape[:-1] + (3,))
    env = scene.emitters.env_map
    He, We = env.shape[:2]
    theta, phi = _env_coords(scene, d)
    x = phi / (2 * math.pi) * We - 0.5
    y = theta / math.pi * He - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = torch.remainder(x0.to(torch.int32), We).long()
    x1i = torch.remainder(x0i + 1, We)
    y0i = torch.clamp(y0.to(torch.int32), 0, He - 1).long()
    y1i = torch.clamp(y0i + 1, 0, He - 1)
    c = (env[y0i, x0i] * ((1 - fx) * (1 - fy)) +
         env[y0i, x1i] * (fx * (1 - fy)) +
         env[y1i, x0i] * ((1 - fx) * fy) +
         env[y1i, x1i] * (fx * fy))
    return c * scene.emitters.env_radiance


def pdf_env_direct(scene, n_area: int, env_kind: int, d, n_delta: int = 0):
    """Solid-angle pdf that sample_direct would have produced direction d
    toward the environment (MIS on escaped BSDF rays): zero without an
    environment, else the uniform sphere's or the texel's pdf over the
    emitter count."""
    if env_kind == ENV_NONE:
        return torch.zeros(d.shape[:-1], dtype=d.dtype, device=d.device)
    if env_kind == ENV_CONSTANT:
        return torch.full(d.shape[:-1], warp.square_to_uniform_sphere_pdf()
                          / (n_area + n_delta + 1), device=d.device)
    pdf = scene.emitters.env_pdf
    He, We = pdf.shape
    theta, phi = _env_coords(scene, d)
    row = torch.clamp((theta / math.pi * He).to(torch.int32), 0, He - 1)
    col = torch.clamp((phi / (2 * math.pi) * We).to(torch.int32), 0, We - 1)
    return pdf[row.long(), col.long()] / (n_area + n_delta + 1)


def mis_weight(pdf_a, pdf_b):
    """Power heuristic, beta=2 (path.cpp miWeight)."""
    a2 = pdf_a * pdf_a
    return torch.where(pdf_a > 0,
                       a2 / torch.clamp_min(a2 + pdf_b * pdf_b, 1e-30), 0.0)


def area_emission(scene, n_area: int, has_env: bool, n_delta: int, its,
                  o_prev, d, alive, tp, last_pdf, last_delta):
    """MIS-weighted radiance of the area emitters hit at `its` along d
    from o_prev, on live lanes (the path tracers' emitter hit): the hit's
    radiance times throughput tp, weighted against NEE's pdf of the same
    point unless the last vertex was a delta one (last_delta)."""
    cos_front = m.dot(its.ns, -d)
    is_emitter = its.valid & (its.emitter_id >= 0) & (cos_front > 0)
    rad = scene.emitters.radiance[
        torch.clamp_min(its.emitter_id, 0).long()]
    lum_pdf = pdf_area_direct(scene, n_area, has_env, its.emitter_id,
                              o_prev, its.p, its.ng, n_delta=n_delta)
    w_hit = torch.where(last_delta, 1.0, mis_weight(last_pdf, lum_pdf))
    return torch.where((alive & is_emitter)[..., None],
                       tp * rad * w_hit[..., None], 0.0)


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
