"""Irradiance caching (Ward/Tabellion style) on the primary-hit lattice.

Counterpart of gradientdomain_mitsuba_tpu/models/irrcache.py (the
`irrcache` integrator, src/integrators/irrcache/irrcache.{cpp,h}): the
reference's lazily built octree of irradiance records becomes a dense
lattice, as in the JAX package:

  overture pass   one record per RxR pixel block (default 4x4): primary
                  hit -> M cosine-hemisphere final-gather walks through
                  PathTracer.trace_rays(direct_at_first=False); the record
                  stores E = pi * mean(L_gather), the hit position and
                  normal, and Ward's harmonic-mean gather distance R_i.
  render pass     every pixel interpolates the 3x3 neighbouring records
                  with the Ward/Tabellion weight, records cut off at
                  w < 1/quality; indirect = albedo/pi * E.  Direct light
                  is a full maxDepth=2 walk, so L = direct + cached
                  indirect.

The cache is rebuilt on every render call, so a re-render with another
seed refreshes it.  Non-diffuse primaries fall back to a full path trace.
As in the reference, the cached render_chunk reports 0 rays.
"""
from __future__ import annotations

import copy
import math

import torch

from ..core import math as m
from ..core import warp
from ..core.rng import DimAllocator as DA
from ..core.rng import uniform_2d
from ..ops import common
from ..ops import film as film_ops
from ..ops import sensor as sensor_ops
from ..scene.materials import DIFFUSE, ROUGH_DIFFUSE
from .path import PathTracer

GATHER_DIM_BASE = 24576   # rng dim offset for the gather-direction stream


class IrrCacheTracer(PathTracer):
    """settings.integrator_props honours `resolution` (pixels per record,
    default 4), `gatherSamples` (hemisphere rays per record, default 64),
    `quality` (Ward error bound kappa, default 0.5)."""

    def __init__(self, scene, settings):
        super().__init__(scene, settings)
        props = settings.integrator_props
        self.res = max(1, int(props.get("resolution", 4)))
        self.gather_samples = int(props.get("gatherSamples", 64))
        self.kappa = float(props.get("quality", 0.5))
        st_d = copy.deepcopy(settings)
        st_d.max_depth = 2
        self._direct = PathTracer(scene, st_d)
        kinds = scene.materials.kind
        self._all_diffuse = bool(((kinds == DIFFUSE) |
                                  (kinds == ROUGH_DIFFUSE)).all())
        self._cache = None

    # -- overture: build the record lattice -----------------------------------
    def _build_cache(self, scene, seed):
        st = self.settings
        dev = self.device
        W, H = st.width, st.height
        R = self.res
        Wc, Hc = -(-W // R), -(-H // R)
        C = Wc * Hc
        M = self.gather_samples

        cell = torch.arange(C, dtype=torch.int64, device=dev)
        cx = (cell % Wc).to(torch.float32)
        cy = (cell // Wc).to(torch.float32)
        pos_film = torch.stack([torch.clamp_max(cx * R + R / 2, W - 0.5),
                                torch.clamp_max(cy * R + R / 2, H - 0.5)], -1)
        o, d = sensor_ops.sample_ray(self.sensor, W, H, pos_film,
                                     torch.full((C, 2), 0.5, device=dev))
        hit = self.closest(o, d, torch.zeros(C, device=dev),
                           torch.full((C,), 3e38, device=dev), scene.geom)
        its = common.fill_intersection(scene, o, d, hit)
        n = torch.where((m.dot(its.ns, -d) < 0)[..., None], -its.ns, its.ns)

        # gather rays: [C*M] cosine-hemisphere walks, final-gather mode
        ids = torch.arange(C * M, dtype=torch.int64, device=dev)
        u = uniform_2d(seed ^ 0x1cc, ids, 0, GATHER_DIM_BASE)
        d_loc = warp.square_to_cosine_hemisphere(u)
        n_rep = torch.repeat_interleave(n, M, dim=0)
        ss, ts = m.build_frame(n_rep)
        d_g = m.to_world(d_loc, ss, ts, n_rep)
        p_rep = torch.repeat_interleave(its.p, M, dim=0)
        ng_rep = torch.repeat_interleave(its.ng, M, dim=0)
        o_g = common.offset_ray_origin(p_rep, ng_rep, d_g, scene.ray_eps)

        L_g = self.trace_rays(scene, seed ^ 0x9a7, 0, ids, o_g, d_g,
                              direct_at_first=False)
        L_g = torch.nan_to_num(L_g, nan=0.0, posinf=0.0, neginf=0.0)
        # E = integral(L cos) = pi * E_cosine-sampled[L]
        E = math.pi * torch.mean(L_g.reshape(C, M, 3), dim=1)

        # Ward's validity radius: harmonic mean of gather hit distances
        hit_g = self.closest(o_g, d_g, torch.zeros(C * M, device=dev),
                             torch.full((C * M,), 3e38, device=dev),
                             scene.geom)
        t_g = torch.where(hit_g.valid, torch.clamp_min(hit_g.t, 1e-4), 1e4)
        Ri = M / torch.sum(1.0 / t_g.reshape(C, M), dim=1)

        return dict(E=E, p=its.p, n=n, Ri=Ri,
                    valid=its.valid & (its.bsdf_id >= 0))

    # -- render pass ----------------------------------------------------------
    def _interp(self, cache, pixel_id, p, n):
        """Ward-weighted 3x3 record interpolation. p, n: [N, 3]."""
        st = self.settings
        R, Wc = self.res, -(-st.width // self.res)
        Hc = -(-st.height // self.res)
        cx = (pixel_id % st.width) // R
        cy = (pixel_id // st.width) // R
        N = p.shape[0]
        dev = p.device

        acc = torch.zeros((N, 3), device=dev)
        wsum = torch.zeros(N, device=dev)
        facc = torch.zeros((N, 3), device=dev)
        fwsum = torch.zeros(N, device=dev)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                idx = (torch.clamp(cy + dy, 0, Hc - 1) * Wc +
                       torch.clamp(cx + dx, 0, Wc - 1))
                Ei = cache["E"][idx]
                ok = cache["valid"][idx]
                dist = torch.sqrt(m.squared_length(p - cache["p"][idx]))
                ndot = torch.clamp(m.dot(n, cache["n"][idx]), -1.0, 1.0)
                err = (dist / torch.clamp_min(cache["Ri"][idx], 1e-6) +
                       torch.sqrt(torch.clamp_min(1.0 - ndot, 0.0)))
                w = torch.where(ok, torch.clamp_min(
                    1.0 / torch.clamp_min(err, 1e-4) - 1.0 / self.kappa,
                    0.0), 0.0)
                acc = acc + w[..., None] * Ei
                wsum = wsum + w
                # fallback: plain inverse-distance over valid records
                wf = torch.where(ok, 1.0 / (dist + 1e-4), 0.0)
                facc = facc + wf[..., None] * Ei
                fwsum = fwsum + wf
        interp = acc / torch.clamp_min(wsum, 1e-12)[..., None]
        fallback = facc / torch.clamp_min(fwsum, 1e-12)[..., None]
        return torch.where((wsum > 0)[..., None], interp, fallback)

    def _trace_pass_cached(self, scene, cache, seed, sample_idx, pixel_id):
        st = self.settings
        W, H = st.width, st.height
        dev = self.device
        px = (pixel_id % W).to(torch.float32)
        py = (pixel_id // W).to(torch.float32)
        jitter = self._u2(seed, pixel_id, sample_idx, DA.PIXEL_JITTER)
        pos_film = torch.stack([px, py], -1) + jitter
        u_ap = self._u2(seed, pixel_id, sample_idx, DA.APERTURE)
        o, d = sensor_ops.sample_ray(self.sensor, W, H, pos_film, u_ap)
        N = o.shape[0]

        # direct lighting: a full maxDepth=2 walk (emitted + MIS direct)
        L = self._direct.trace_rays(scene, seed, sample_idx, pixel_id, o, d)

        # indirect: cached irradiance at the primary hit, diffuse lanes
        hit = self.closest(o, d, torch.zeros(N, device=dev),
                           torch.full((N,), 3e38, device=dev), scene.geom)
        its = common.fill_intersection(scene, o, d, hit)
        n = torch.where((m.dot(its.ns, -d) < 0)[..., None], -its.ns, its.ns)
        E = self._interp(cache, pixel_id, its.p, n)
        params = common.material_params(scene, self.has_textures,
                                        its.bsdf_id, its.uv, bary=its.bary)
        diffuse = (((params.kind == DIFFUSE) |
                    (params.kind == ROUGH_DIFFUSE)) & its.valid)
        L_ind = params.reflectance / math.pi * E
        L = L + torch.where(diffuse[..., None], L_ind, 0.0)

        if not self._all_diffuse:
            # non-diffuse primaries: the cache cannot represent their
            # transport — a full path trace on those lanes
            L_full = self.trace_rays(scene, seed, sample_idx, pixel_id, o, d)
            L = torch.where(diffuse[..., None] | ~its.valid[..., None],
                            L, L_full)
        return pos_film, L

    def render_chunk(self, scene, seed, sample_start, n_samples):
        """(film, weights, 0 rays) of n_samples samples a pixel through
        the current cache."""
        st = self.settings
        N = st.width * st.height
        dev = self.device
        spb = self.samples_per_batch(n_samples)
        fb = torch.zeros((st.height, st.width, 3), device=dev)
        wb = torch.zeros((st.height, st.width), device=dev)
        ids = torch.arange(N, dtype=torch.int64, device=dev).repeat(spb)
        for i in range(n_samples // spb):
            sidx = (sample_start + i * spb + torch.arange(
                spb, dtype=torch.int64, device=dev).repeat_interleave(N))
            pos, L = self._trace_pass_cached(scene, self._cache, seed, sidx,
                                             ids)
            fb, wb = film_ops.splat_grid(fb, wb,
                                         (pos % 1.0).reshape(spb, N, 2),
                                         L.reshape(spb, N, 3),
                                         self.filter_kind)
        return fb, wb, torch.zeros((), dtype=torch.int64, device=dev)

    def render(self, scene, seed=0, spp=None, **kw):
        self._cache = self._build_cache(scene, seed)
        return super().render(scene, seed=seed, spp=spp, **kw)


def render(scene, settings, seed=0, spp=None):
    return IrrCacheTracer(scene, settings).render(scene, seed=seed, spp=spp)
