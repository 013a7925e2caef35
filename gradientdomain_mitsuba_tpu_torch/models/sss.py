"""Path tracing with dipole subsurface scattering.

Counterpart of gradientdomain_mitsuba_tpu/models/sss.py: rendering a
scene whose shapes carry the `dipole` subsurface plugin
(src/subsurface/dipole.cpp).  Mitsuba's Subsurface::preprocess builds an
irradiance octree once per render and every integrator adds
its.LoSub(...) at hits on a subsurface shape.  Here, as in the
reference, the preprocess fills a dense point cache (ops/sss.py):

  1. sample P uniform-area points on the subsurface shapes (the per-row
     triangle CDF of scene.sss);
  2. irradiance per point = an NEE direct estimate (M shadow rays) + a
     cosine-hemisphere final gather (M path-traced walks,
     direct_at_first=False so direct light is not counted twice);
  3. the render passes carry the cache into trace_pass, and the path
     tracer's bounce adds the dipole exit radiance (1/pi) Ft(eta, cos_o)
     Mo at every vertex on a subsurface shape.

The reference jits the preprocess; here it runs eagerly on the scene's
device, with no host read inside it.  As in the reference, only the
path-tracer family evaluates subsurface attachments: Mitsuba's
bidirectional integrators ignore Subsurface::Lo, and so do these.  With
count_rays the render passes report their rays (the reference's
dipole render_chunk reports 0); the cache build's rays are counted
through ray_tally.
"""
from __future__ import annotations

import math

import torch

from ..core import math as m
from ..core import warp
from ..core.rng import uniform_2d
from ..ops import common, emitter as em_ops
from ..ops import sss as sss_ops
from .path import PathTracer

# rng dim offsets of the preprocess streams (past every bounce dim)
DIM_DIRECT = 7105
DIM_GATHER = 7207


class DipoleTracer(PathTracer):
    """settings.sss_props gives `samples` (cache points, default 2048)
    and `irr_samples` (the loader's irrSamples: rays a point for both
    the direct estimate and the indirect gather, default 16)."""

    def __init__(self, scene, settings):
        super().__init__(scene, settings)
        props = settings.sss_props
        self.n_points = int(props.get("samples", 2048))
        self.irr_samples = max(1, int(props.get("irr_samples", 16)))
        self._sss_coeffs = sss_ops.dipole_coeffs(scene.sss, self.device)
        self._cache = None

    # -- preprocess: irradiance cache over the subsurface shapes ------------
    def _build_cache(self, scene, seed):
        """The cache dict of ops/sss.sample_surface_points with E, the
        irradiance at each point."""
        P, M = self.n_points, self.irr_samples
        dev = self.device
        pts = sss_ops.sample_surface_points(scene, P, seed)
        eps = scene.ray_eps
        ids = torch.arange(P * M, dtype=torch.int64, device=dev)
        p_rep = torch.repeat_interleave(pts["p"], M, dim=0)
        n_rep = torch.repeat_interleave(pts["n"], M, dim=0)

        # direct irradiance: plain NEE (no MIS: irradiance has no BSDF
        # lobe to balance against)
        u_sel = uniform_2d(seed ^ 0x3d, ids, 0, DIM_DIRECT)[:, 0]
        u_pos = uniform_2d(seed ^ 0x3e, ids, 0, DIM_DIRECT + 2)
        ds = em_ops.sample_direct(scene, self.n_area, self.env_kind, p_rep,
                                  u_sel, u_pos, n_delta=self.n_delta)
        cos_i = m.dot(ds.d, n_rep)
        ok = ds.valid & (ds.pdf > 0) & (cos_i > 0)
        o_sh = common.offset_ray_origin(p_rep, n_rep, ds.d, eps)
        occl = self.occluded(
            o_sh, ds.d, torch.zeros(P * M, device=dev),
            ds.dist - 2.0 * eps / torch.clamp_min(
                torch.abs(m.dot(ds.d, ds.n)), 1e-3),
            scene.geom)
        contrib = ds.radiance * (cos_i / torch.clamp_min(ds.pdf, 1e-30)
                                 )[:, None]
        E_dir = torch.where((ok & ~occl)[:, None], contrib, 0.0)
        E_dir = torch.mean(E_dir.reshape(P, M, 3), dim=1)

        # indirect irradiance: cosine final gather, E = pi * mean(L)
        u_g = uniform_2d(seed ^ 0x5f, ids, 0, DIM_GATHER)
        d_loc = warp.square_to_cosine_hemisphere(u_g)
        fs, ft = m.build_frame(n_rep)
        d_g = m.to_world(d_loc, fs, ft, n_rep)
        o_g = common.offset_ray_origin(p_rep, n_rep, d_g, eps)
        L_g = self.trace_rays(scene, seed ^ 0x77, torch.zeros_like(ids),
                              ids, o_g, d_g, direct_at_first=False)
        L_g = torch.nan_to_num(L_g, nan=0.0, posinf=0.0, neginf=0.0)
        E_ind = math.pi * torch.mean(L_g.reshape(P, M, 3), dim=1)
        return dict(**pts, E=E_dir + E_ind)

    # -- render: every pass carries the cache --------------------------------
    def trace_pass(self, scene, seed, sample_idx, pixel_id=None,
                   sss_cache=None):
        return super().trace_pass(
            scene, seed, sample_idx, pixel_id,
            self._cache if sss_cache is None else sss_cache)

    def render(self, scene, seed=0, spp=None, **kw):
        """A fresh cache for `seed` (the reference's _build_cache(scene,
        uint32(seed))), then PathTracer.render through it."""
        self._cache = self._build_cache(scene, int(seed) & 0xFFFFFFFF)
        return super().render(scene, seed=seed, spp=spp, **kw)


def render(scene, settings, seed=0, spp=None):
    return DipoleTracer(scene, settings).render(scene, seed=seed, spp=spp)
