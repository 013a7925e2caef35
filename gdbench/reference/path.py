"""Plain path tracer (Mitsuba's `path` integrator, MIPathTracer::Li) for
the reference.

Unidirectional path tracing with next-event estimation and the power
heuristic: depth 1 is the camera ray's hit; maxDepth caps the segments;
Russian roulette from rrDepth on survives with min(max(throughput) eta^2,
0.95); NEE at a vertex of depth d is taken only where d < maxDepth.  The
random numbers are the independent sampler's counter stream
(reference/rng.py), so each lane follows the path that the same
(seed, pixel, sample) lane of the program follows.  Every sample lands in
its own pixel (box filter): a pixel's value is the mean of its samples.
"""
from __future__ import annotations

import torch

from . import rng
from .common import (diffuse_eval, diffuse_pdf, diffuse_sample, dot, frame,
                     mis, offset, to_local, to_world)


def trace_lanes(ds, seed, pixel, sample):
    """Radiance [N, 3] of the lanes (pixel [N], sample [N] int64)."""
    rs, dt, dev = ds.rs, ds.dtype, ds.device
    N = pixel.shape[0]
    W = rs.width
    jit = rng.uniform2(seed, pixel, sample, rng.PIXEL_JITTER, dt)
    pos = torch.stack([(pixel % W).to(dt), (pixel // W).to(dt)], -1) + jit
    o, d = ds.camera_ray(pos)
    hit = ds.trace(o, d, torch.full((N,), 3e38, dtype=dt, device=dev))
    L = torch.zeros((N, 3), dtype=dt, device=dev)
    tp = torch.ones((N, 3), dtype=dt, device=dev)
    alive = torch.ones(N, dtype=torch.bool, device=dev)
    last_pdf = torch.zeros(N, dtype=dt, device=dev)
    first = torch.ones(N, dtype=torch.bool, device=dev)
    n_bounces = rs.max_depth if rs.max_depth > 0 else 40

    def emitted(hit, o_prev, d, alive, tp, last_pdf, first):
        is_em, rad = ds.emission(hit, d)
        w = torch.where(first, 1.0, mis(last_pdf, ds.light_pdf(
            hit.emitter, o_prev, hit.p, hit.ng)))
        return torch.where((alive & is_em)[..., None],
                           tp * rad * w[..., None], 0.0)

    for b in range(n_bounces):
        depth = b + 1
        L = L + emitted(hit, o, d, alive, tp, last_pdf, first)
        alive = alive & hit.valid
        if rs.max_depth > 0:
            alive = alive & (depth < rs.max_depth)
        s, t = frame(hit.ns)
        wi = to_local(-d, s, t, hit.ns)

        # next-event estimation
        u_sel = rng.uniform(seed, pixel, sample,
                            rng.bounce_dim(b, rng.D_LIGHT_SELECT), dt)
        u_pos = rng.uniform2(seed, pixel, sample,
                             rng.bounce_dim(b, rng.D_LIGHT_UV), dt)
        lt = ds.sample_light(hit.p, u_sel, u_pos)
        nee = alive & lt["valid"] & (lt["pdf"] > 0)
        sh_o = offset(hit.p, hit.ng, lt["d"], ds.eps)
        maxt = lt["dist"] - 2.0 * ds.eps / torch.clamp_min(
            dot(lt["d"], lt["n"]).abs(), 1e-3)
        occl = ds.occluded(sh_o, lt["d"], torch.where(nee, maxt, -1.0))
        wo_l = to_local(lt["d"], s, t, hit.ns)
        f = diffuse_eval(hit.refl, wi, wo_l)
        w_nee = mis(lt["pdf"], diffuse_pdf(wi, wo_l))
        contrib = tp * f * lt["radiance"] * (
            w_nee / torch.clamp_min(lt["pdf"], 1e-30))[..., None]
        L = L + torch.where((nee & ~occl)[..., None], contrib, 0.0)

        # BSDF sampling
        u2 = rng.uniform2(seed, pixel, sample,
                          rng.bounce_dim(b, rng.D_BSDF_UV), dt)
        wo, weight, pdf, valid = diffuse_sample(hit.refl, wi, u2)
        alive = alive & valid
        tp = torch.where(alive[..., None], tp * weight, tp)
        wo_w = to_world(wo, s, t, hit.ns)
        o = offset(hit.p, hit.ng, wo_w, ds.eps)
        d = wo_w

        # Russian roulette (eta stays 1 on diffuse vertices)
        u_rr = rng.uniform(seed, pixel, sample,
                           rng.bounce_dim(b, rng.D_RR), dt)
        q = torch.clamp_max(tp.amax(-1), 0.95)
        if depth >= rs.rr_depth:
            tp = torch.where(alive[..., None],
                             tp / torch.clamp_min(q, 1e-9)[..., None], tp)
            alive = alive & (u_rr < q)
        alive = alive & (tp.amax(-1) > 0)

        hit = ds.trace(o, d, torch.where(alive, 3e38, -1.0).to(dt))
        last_pdf = pdf
        first = torch.zeros_like(first)
    return L + emitted(hit, o, d, alive, tp, last_pdf, first)


def render(ds, seed, spp, pixels=None, lanes=1 << 18):
    """Mean radiance [P, 3] over spp samples (sample indices 0..spp-1) of
    the pixels (default: the whole film, row-major)."""
    dev = ds.device
    if pixels is None:
        pixels = torch.arange(ds.rs.width * ds.rs.height, device=dev)
    P = pixels.shape[0]
    acc = torch.zeros((P, 3), dtype=torch.float32, device=dev)
    pix = pixels.repeat(spp)
    smp = torch.arange(spp, device=dev).repeat_interleave(P)
    slot = torch.arange(P, device=dev).repeat(spp)
    for a in range(0, pix.shape[0], lanes):
        L = trace_lanes(ds, seed, pix[a:a + lanes], smp[a:a + lanes])
        acc.index_add_(0, slot[a:a + lanes], L.float())
    return acc / spp
