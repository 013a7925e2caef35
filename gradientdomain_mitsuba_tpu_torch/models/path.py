"""Wavefront path tracer with NEE + MIS.

Counterpart of gradientdomain_mitsuba_tpu/models/path.py (the `path`
integrator, src/integrators/path/path.cpp MIPathTracer::Li): every
pixel's ray advances one bounce per step of the bounce loop as one SoA
batch; dead lanes are masked (their traversal queries carry maxt = -1).
Semantics are the reference's:

  - depth counting: depth 1 = camera ray hits emitter; maxDepth caps path
    segments; maxDepth=-1 means unlimited (capped by RR + MAX_BOUNCES)
  - MIS: power heuristic beta=2 between BSDF sampling and NEE
  - NEE: uniform emitter pick, area-uniform sampling, solid-angle pdf
  - RR from rrDepth with survival min(max(throughput)*eta^2, 0.95)

`jit` and `fori_loop` become eager code and Python loops on the scene's
device.  Ported: the scenes the port's BSDFs, emitters and sensors cover
(every BSDF kind and texture of the reference, woven cloth and the
barycentric payload included, analytic spheres, area and delta lights,
the constant environment and the envmap, every sensor; the primary hits
read textures at their footprint's mip level, anisotropically where a
bitmap asks for EWA).  At a delta vertex the NEE shadow ray is still
traced, as in the reference; eval's delta mask makes its contribution
0.  With an irradiance cache (sss_cache, models/sss.py) every surface
vertex on a shape with a dipole attachment adds its exit radiance.
"""
from __future__ import annotations

import functools
import math
import os

import torch

from ..config import configure
from ..core import math as m
from ..core.rng import DimAllocator as DA
from ..core.rng import make_sampler
from ..ops import bsdf as bsdf_ops
from ..ops import common, emitter as em_ops
from ..ops import film as film_ops
from ..ops import sensor as sensor_ops
from ..ops import sss as sss_ops

# bounce cap used for maxDepth = -1 (unlimited; Russian roulette ends
# paths long before it)
MAX_BOUNCES_UNLIMITED = 40

# lanes per pass unless GDMT_LANES says otherwise: the reference's
# defaults, so both packages assign the same sample indices per pass.
# Large scenes take 1M-lane passes: 256x256 at 16 spp is one pass.
LANES_LARGE = 1 << 20
LANES_SMALL = 1 << 16


def mis_weight(pdf_a, pdf_b):
    """Power heuristic, beta=2 (path.cpp miWeight)."""
    a2 = pdf_a * pdf_a
    return torch.where(pdf_a > 0,
                       a2 / torch.clamp_min(a2 + pdf_b * pdf_b, 1e-30), 0.0)


def _b3(x):
    return x[..., None]


def primary_footprint(tracer, scene, d, its):
    """The primary hits' texture footprint: its uv area, with the
    ellipse's axes (common.primary_uv_jacobian) when a bitmap of the
    scene filters anisotropically (settings.has_ewa)."""
    st = tracer.settings
    fp = common.primary_uv_footprint(scene, st.width, st.height, d, its)
    if not tracer.has_ewa:
        return fp
    return fp, common.primary_uv_jacobian(scene, st.width, st.height, d,
                                          its)


class PathTracer:
    """Unidirectional path tracer (NEE + MIS) on the scene's device."""

    def __init__(self, scene, settings):
        configure()
        self.kinds = bsdf_ops.scene_kinds(scene)
        self.sensor = sensor_ops.describe(scene.camera)
        self._beval = functools.partial(bsdf_ops.eval, kinds=self.kinds)
        self._bpdf = functools.partial(bsdf_ops.pdf, kinds=self.kinds)
        self._bsample = functools.partial(bsdf_ops.sample, kinds=self.kinds)
        self.settings = settings
        self.device = scene.geom.linC.device
        self.n_area = int((scene.emitters.tri_count > 0).sum())
        self.has_env = settings.has_env
        self.env_kind = settings.env_kind
        self.has_textures = settings.has_textures
        self.has_ewa = settings.has_ewa
        self.n_delta = settings.n_delta
        n_tris = int(scene.geom.indices.shape[0])
        closest, occluded = common.choose_intersector(
            settings, n_tris, int(scene.geom.clusters.offset.shape[0]))
        # the kernels this tracer launches (their .launches count)
        self.kernels = (closest.kernel, occluded.kernel)
        self.closest, self.occluded = common.instrument_intersectors(
            self, closest, occluded)
        self.large_scene = n_tris > common.BRUTE_FORCE_MAX_TRIS
        self.count_rays = False  # set True BEFORE a render to count rays
        self.ray_tally = None
        self.last_ray_count = None
        self.n_bounces = (settings.max_depth if settings.max_depth > 0
                          else MAX_BOUNCES_UNLIMITED)
        self._u1, self._u2 = make_sampler(settings.sampler, settings.spp)
        self.filter_kind = film_ops.FILTERS.get(settings.rfilter, 0)

    # -- one sample per pixel for the whole frame ---------------------------
    def trace_pass(self, scene, seed, sample_idx, pixel_id=None,
                   sss_cache=None):
        """Trace one sample for a batch of pixels (default: whole frame).
        Returns (film positions [N,2], radiance [N,3])."""
        st = self.settings
        W, H = st.width, st.height
        if pixel_id is None:
            pixel_id = torch.arange(W * H, dtype=torch.int64,
                                    device=self.device)
        px = (pixel_id % W).to(torch.float32)
        py = (pixel_id // W).to(torch.float32)

        jitter = self._u2(seed, pixel_id, sample_idx, DA.PIXEL_JITTER)
        pos_film = torch.stack([px, py], -1) + jitter
        u_ap = self._u2(seed, pixel_id, sample_idx, DA.APERTURE)
        o, d = sensor_ops.sample_ray(self.sensor, W, H, pos_film, u_ap)
        L = self.trace_rays(scene, seed, sample_idx, pixel_id, o, d,
                            sss_cache=sss_cache)
        return pos_film, L

    def _emitted(self, scene, its, o_prev, d, alive, tp, last_pdf,
                 last_delta):
        """MIS-weighted emission seen at `its` along d from o_prev: an
        area emitter hit, or the environment on an escaped ray."""
        cos_front = m.dot(its.ns, -d)
        is_emitter = its.valid & (its.emitter_id >= 0) & (cos_front > 0)
        rad = scene.emitters.radiance[
            torch.clamp_min(its.emitter_id, 0).long()]
        lum_pdf = em_ops.pdf_area_direct(
            scene, self.n_area, self.has_env, its.emitter_id, o_prev,
            its.p, its.ng, n_delta=self.n_delta)
        w_hit = torch.where(last_delta, 1.0, mis_weight(last_pdf, lum_pdf))
        out = torch.where(_b3(alive & is_emitter), tp * rad * _b3(w_hit),
                          0.0)
        if self.has_env:
            # the two terms are exclusive per lane (hit or escaped), so
            # their sum adds as the reference's two adds do
            env_l = em_ops.eval_env(scene, self.env_kind, d)
            env_pdf = em_ops.pdf_env_direct(scene, self.n_area,
                                            self.env_kind, d,
                                            n_delta=self.n_delta)
            w_env = torch.where(last_delta, 1.0,
                                mis_weight(last_pdf, env_pdf))
            out = out + torch.where(_b3(alive & ~its.valid),
                                    tp * env_l * _b3(w_env), 0.0)
        return out

    def trace_rays(self, scene, seed, sample_idx, pixel_id, o, d,
                   direct_at_first=True, sss_cache=None):
        """Path-trace a batch of rays to completion. Returns radiance [N,3].

        direct_at_first=False drops emitter radiance seen directly by the
        input rays (depth-1 hits) — final-gather semantics.  sss_cache:
        the dipole irradiance cache (models/sss.DipoleTracer), whose exit
        radiance every bounce adds at subsurface vertices."""
        st = self.settings
        dev = self.device
        N = o.shape[0]
        eps = scene.ray_eps
        zeros = torch.zeros(N, device=dev)

        hit = self.closest(o, d, zeros, torch.full((N,), 3e38, device=dev),
                           scene.geom)
        its = common.fill_intersection(scene, o, d, hit)
        s = dict(
            o=o, d=d, its=its,
            L=torch.zeros((N, 3), device=dev),
            tp=torch.ones((N, 3), device=dev),
            eta=torch.ones(N, device=dev),
            alive=torch.ones(N, dtype=torch.bool, device=dev),
            last_pdf=zeros,
            # depth-1 emitter hits: weight 1 (or 0 in final-gather mode —
            # mis_weight(0, x) == 0)
            last_delta=torch.full((N,), bool(direct_at_first),
                                  device=dev),
        )
        for b in range(self.n_bounces):
            # bounce 0 shades the primary hits at their mip level (pixel
            # footprint); later bounces sample the finest level
            fp = None
            if b == 0 and self.has_textures:
                fp = primary_footprint(self, scene, d, its)
            s = self._bounce(scene, s, b, seed, sample_idx, pixel_id, N,
                             eps, fp, sss_cache)

        # final emitter-hit pass for the vertex reached by the last bounce
        return s["L"] + self._emitted(scene, s["its"], s["o"], s["d"],
                                      s["alive"], s["tp"], s["last_pdf"],
                                      s["last_delta"])

    def _dipole(self, scene, its, wi_world, alive, tp, sss_cache):
        """The dipole term at live, valid, front-facing hits of a shape
        with a subsurface row (dipole.cpp's its.LoSub):
        Lo = (1/pi) Ft(eta, cos_o) Mo(p)."""
        sss = scene.sss
        cos_front = m.dot(its.ns, wi_world)
        row_q = sss.shape_sss[torch.clamp(
            its.shape_id, 0, sss.shape_sss.shape[0] - 1).long()]
        has_sss = alive & its.valid & (row_q >= 0) & (cos_front > 0)
        row_m = torch.where(has_sss, row_q, -1)
        co = self._sss_coeffs
        mo = sss_ops.eval_mo(sss_cache, co, its.p, row_m)
        eta_r = co.eta[torch.clamp_min(row_m, 0).long()]
        ft = 1.0 - bsdf_ops.fresnel_dielectric(
            torch.clamp(cos_front, 0.0, 1.0), eta_r)[0]
        return torch.where(_b3(has_sss), tp * mo * _b3(ft / math.pi), 0.0)

    def _bounce(self, scene, s, b, seed, sample_idx, pixel_id, N, eps,
                fp=None, sss_cache=None):
        st = self.settings
        dev = self.device
        depth = b + 1  # Mitsuba depth of the CURRENT vertex
        its = s["its"]
        alive = s["alive"]
        tp = s["tp"]
        wi_world = -s["d"]

        # ---- emitter hit at current vertex --------------------------------
        L = s["L"] + self._emitted(scene, its, s["o"], s["d"], alive, tp,
                                   s["last_pdf"], s["last_delta"])
        if sss_cache is not None:
            L = L + self._dipole(scene, its, wi_world, alive, tp, sss_cache)

        alive = alive & its.valid
        # maxDepth cut: no continuation past maxDepth segments
        if st.max_depth > 0:
            alive = alive & (depth < st.max_depth)

        # ---- shading frame ------------------------------------------------
        ss, ts = m.build_frame(its.ns)
        wi = m.to_local(wi_world, ss, ts, its.ns)
        params = common.material_params(scene, self.has_textures,
                                        its.bsdf_id, its.uv,
                                        uv_footprint=fp, bary=its.bary)

        # ---- NEE ------------------------------------------------------------
        u_sel = self._u1(seed, pixel_id, sample_idx,
                         DA.bounce_dim(b, DA.D_LIGHT_SELECT))
        u_pos = self._u2(seed, pixel_id, sample_idx,
                         DA.bounce_dim(b, DA.D_LIGHT_UV))
        ds = em_ops.sample_direct(scene, self.n_area, self.env_kind, its.p,
                                  u_sel, u_pos, n_delta=self.n_delta)
        nee_possible = alive & ds.valid & (ds.pdf > 0)
        shadow_o = common.offset_ray_origin(its.p, its.ng, ds.d, eps)
        occl = self.occluded(
            shadow_o, ds.d, torch.zeros(N, device=dev),
            ds.dist - 2.0 * eps / torch.clamp_min(
                torch.abs(m.dot(ds.d, ds.n)), 1e-3),
            scene.geom)
        wo_l = m.to_local(ds.d, ss, ts, its.ns)
        f_l = self._beval(params, wi, wo_l)
        pdf_b = self._bpdf(params, wi, wo_l)
        w_nee = torch.where(ds.is_delta, 1.0, mis_weight(ds.pdf, pdf_b))
        contrib = (tp * f_l * ds.radiance *
                   _b3(w_nee / torch.clamp_min(ds.pdf, 1e-30)))
        L = L + torch.where(_b3(nee_possible & ~occl), contrib, 0.0)

        # ---- BSDF sampling --------------------------------------------------
        u2 = self._u2(seed, pixel_id, sample_idx,
                      DA.bounce_dim(b, DA.D_BSDF_UV))
        uc = self._u1(seed, pixel_id, sample_idx,
                      DA.bounce_dim(b, DA.D_BSDF_COMPONENT))
        bs = self._bsample(params, wi, u2, uc)
        alive = alive & bs.valid
        tp = torch.where(_b3(alive), tp * bs.weight, tp)
        eta = torch.where(alive, s["eta"] * bs.eta, s["eta"])
        wo_world = m.to_world(bs.wo, ss, ts, its.ns)
        o_new = common.offset_ray_origin(its.p, its.ng, wo_world, eps)

        # ---- russian roulette -----------------------------------------------
        u_rr = self._u1(seed, pixel_id, sample_idx,
                        DA.bounce_dim(b, DA.D_RR))
        q = torch.clamp_max(tp.amax(-1) * eta * eta, 0.95)
        if depth >= st.rr_depth:
            tp = torch.where(_b3(alive), tp / _b3(torch.clamp_min(q, 1e-9)),
                             tp)
            alive = alive & (u_rr < q)
        alive = alive & (tp.amax(-1) > 0)

        # ---- next intersection ----------------------------------------------
        hit = self.closest(o_new, wo_world, torch.zeros(N, device=dev),
                           torch.where(alive, 3e38, -1.0), scene.geom)
        its_new = common.fill_intersection(scene, o_new, wo_world, hit)
        return dict(o=o_new, d=wo_world, its=its_new, L=L, tp=tp, eta=eta,
                    alive=alive, last_pdf=bs.pdf, last_delta=bs.is_delta)

    # -- full frame -----------------------------------------------------------
    def samples_per_batch(self, n_samples):
        """Samples per pass: as many whole frames as fit the lane target
        (GDMT_LANES, read at each call as the reference reads it; default
        1M lanes for large scenes, 64k otherwise), rounded down to a
        divisor of n_samples (the reference's rule)."""
        N = self.settings.width * self.settings.height
        target = int(os.environ.get(
            "GDMT_LANES",
            str(LANES_LARGE if self.large_scene else LANES_SMALL)))
        spb = max(1, target // max(N, 1))
        while n_samples % spb:
            spb -= 1
        return spb

    def render_chunk(self, scene, seed, sample_start, n_samples):
        """Accumulate n_samples samples per pixel from sample index
        sample_start.  Returns (film [H,W,3], weights [H,W], measured rays
        (0-d int64; zero unless count_rays)), all on the device."""
        st = self.settings
        H, W = st.height, st.width
        N = W * H
        dev = self.device
        spb = self.samples_per_batch(n_samples)
        fb = torch.zeros((H, W, 3), device=dev)
        wb = torch.zeros((H, W), device=dev)
        rays = torch.zeros((), dtype=torch.int64, device=dev)
        ids = torch.arange(N, dtype=torch.int64, device=dev).repeat(spb)
        try:
            for i in range(n_samples // spb):
                self.ray_tally = (torch.zeros((), dtype=torch.int64,
                                              device=dev)
                                  if self.count_rays else None)
                sidx = (sample_start + i * spb + torch.arange(
                    spb, dtype=torch.int64, device=dev).repeat_interleave(N))
                pos, L = self.trace_pass(scene, seed, sidx, pixel_id=ids)
                if self.ray_tally is not None:
                    rays = rays + self.ray_tally
                # samples are grid-aligned: dense filtered adds, no scatter
                jit = (pos % 1.0).reshape(spb, N, 2)
                fb, wb = film_ops.splat_grid(fb, wb, jit,
                                             L.reshape(spb, N, 3),
                                             self.filter_kind)
        finally:
            self.ray_tally = None
        return fb, wb, rays

    def finalize(self, state, spp):
        fb, wb = state["0"], state["1"]
        return fb / torch.clamp_min(wb, 1e-12)[..., None]

    def render(self, scene, seed=0, spp=None, chunk=64,
               checkpoint_path=None, resume=False, progress=None):
        """Render spp samples per pixel through render_accumulate and
        return the normalized image [H, W, 3] on the device; with
        count_rays, last_ray_count holds the measured rays (one host read
        at the end)."""
        from ..parallel.checkpoint import render_accumulate
        spp = spp or self.settings.spp
        state, spp = render_accumulate(
            self, scene, seed, spp, chunk,
            checkpoint_path=checkpoint_path, resume=resume,
            progress=progress)
        if self.count_rays and "2" in state:
            self.last_ray_count = int(state["2"])
        return self.finalize(state, spp)


def render(scene, settings, seed=0, spp=None):
    return PathTracer(scene, settings).render(scene, seed=seed, spp=spp)
