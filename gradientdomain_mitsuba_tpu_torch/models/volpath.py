"""Wavefront volumetric path tracer (homogeneous + heterogeneous media).

Counterpart of gradientdomain_mitsuba_tpu/models/volpath.py (the
`volpath` / `volpath_simple` integrators, src/integrators/volpath/
volpath{,_simple}.cpp): the surface path loop of models/path.py with
per-lane medium tracking, free-flight distance sampling, phase-function
scattering, and attenuated shadow rays that walk through index-matched
(null-BSDF) boundaries.  Both reference names map to this one tracer
(full NEE + MIS, the `volpath` estimator).

Heterogeneous (density-grid) media switch the free-flight sample to
spectral delta tracking and transmittances to ratio tracking against the
per-medium majorant (ops/medium.py), with a step budget per segment
(`trackingSteps`, default 64).

Per loop iteration (all lanes in lockstep):
  1. free flight in the lane's current medium, bounded by the surface
     hit: a medium event does phase NEE + phase sampling;
  2. otherwise the surface event: emitter-hit MIS, then null boundaries
     pass through (medium transition, depth NOT incremented), real
     surfaces shade as in path.py.

Depth is a per-lane counter (null crossings do not consume it), so the
loop runs n_bounces + NULL_SLACK iterations.  MIS bookkeeping (last_pdf,
the last real vertex) is kept across null crossings.  The ray tally is
added to directly by the instrumented intersectors, as in the port's
other tracers (the reference folds it through its loop carry).
"""
from __future__ import annotations

import torch

from ..core import math as m
from ..core.rng import DimAllocator as DA
from ..core.rng import lane_uniform_2d
from ..ops import common, emitter as em_ops
from ..ops import medium as med_ops
from ..ops.emitter import mis_weight
from ..scene.materials import NULL_BSDF
from .path import PathTracer, _b3

NULL_SLACK = 4          # extra loop iterations to absorb null crossings
MEDIA_DIM_BASE = 8192   # rng dim offset for the media sample stream
TRACK_DIM_BASE = 32768  # free-flight delta-tracking steps
SHADOW_TRACK_DIM_BASE = 49152   # ratio-tracking shadow segments
FINAL_TRACK_DIM_BASE = 61440    # last-segment transmittance


def _media_dim(bounce, which):
    return MEDIA_DIM_BASE + bounce * 4 + which


D_MED_CHANNEL = 0   # 1 dim: spectral channel for free-flight sampling
D_MED_DIST = 1      # 1 dim: exponential distance
D_PHASE_UV = 2      # 2 dims: phase direction


class VolPathTracer(PathTracer):
    """Volumetric wavefront tracer; PathTracer's film / render /
    checkpoint plumbing with its own trace_rays."""

    def __init__(self, scene, settings):
        super().__init__(scene, settings)
        self.max_null_crossings = int(
            settings.integrator_props.get("maxNullCrossings", 2))
        self.sensor_medium = int(getattr(settings, "sensor_medium", -1))
        self.has_het = bool(getattr(settings, "has_het_media", False))
        # gridvolume-driven microflake orientation fields
        self.has_orient = bool((scene.media.orient_offset >= 0).any())
        self.track_steps = int(
            settings.integrator_props.get("trackingSteps", 64))
        # the loop must out-run per-lane depth + null crossings
        self.n_iters = self.n_bounces + NULL_SLACK

    def _medium_across(self, g, sid, d, ng):
        """The medium on the side of shape `sid` that direction d enters
        (interior where d . ng < 0) and whether the shape bounds a
        medium at all."""
        trans = (g.shape_interior[sid] >= 0) | (g.shape_exterior[sid] >= 0)
        side = torch.where(m.dot(d, ng) < 0, g.shape_interior[sid],
                           g.shape_exterior[sid])
        return side, trans

    # -- attenuated shadow rays ---------------------------------------------
    def _attenuated_tr(self, scene, o, d, dist, medium, active,
                       track_u2=None, bounce=0):
        """Transmittance along (o, d, dist) through up to
        max_null_crossings null boundaries, each segment's transmittance
        analytic (homogeneous) or ratio-tracked (density grids); any
        other surface blocks (0).  Scene::evalTransmittance +
        sampleAttenuatedEmitterDirect (src/librender/scene.cpp).
        track_u2: the lanes' uniform_2d stream (lane_uniform_2d), for
        ratio tracking."""
        N = o.shape[0]
        dev = self.device
        eps = scene.ray_eps
        kind_tab = scene.materials.kind
        tr = torch.ones((N, 3), device=dev)
        cur_o = o
        remaining = dist
        cur_med = medium
        walking = active
        for c in range(self.max_null_crossings + 1):
            hit = self.closest(cur_o, d, torch.zeros(N, device=dev),
                               torch.where(walking, remaining, -1.0),
                               scene.geom)
            seg = torch.where(hit.valid, hit.t, remaining)
            _, sigma_t, _, _, _ = med_ops.gather(scene.media, cur_med)
            if self.has_het and track_u2 is not None:
                K = self.track_steps
                base = (SHADOW_TRACK_DIM_BASE +
                        (bounce * (self.max_null_crossings + 1) + c) *
                        2 * K)

                def u_trk(k, _base=base):
                    return track_u2(_base + 2 * k)
                # lanes that stopped walking keep their tr: not tracked
                tr_seg = med_ops.transmittance_tracking(
                    scene.media, torch.where(walking, cur_med, -1), cur_o,
                    d, seg, u_trk, K)
            else:
                tr_seg = med_ops.transmittance(sigma_t, seg)
            tr = torch.where(_b3(walking), tr * tr_seg, tr)
            its = common.fill_intersection(scene, cur_o, d, hit)
            k = kind_tab[torch.clamp_min(its.bsdf_id, 0).long()]
            is_null = hit.valid & (its.bsdf_id >= 0) & (k == NULL_BSDF)
            blocked = walking & hit.valid & ~is_null
            tr = torch.where(_b3(blocked), 0.0, tr)
            # pass through the null boundary: medium transition
            sid = torch.clamp_min(its.shape_id, 0).long()
            new_med, trans = self._medium_across(scene.geom, sid, d, its.ng)
            cur_med = torch.where(walking & is_null & trans, new_med,
                                  cur_med)
            cur_o = common.offset_ray_origin(its.p, its.ng, d, eps)
            remaining = torch.clamp_min(remaining - seg - eps, 0.0)
            walking = walking & is_null & (remaining > 0)
        # crossings budget exhausted with boundaries left: conservative 0
        return torch.where(_b3(walking), 0.0, tr)

    # -- the volumetric loop --------------------------------------------------
    def trace_rays(self, scene, seed, sample_idx, pixel_id, o, d,
                   sss_cache=None):
        """Volumetric path trace of a ray batch. Returns radiance [N,3]."""
        if sss_cache is not None:
            raise NotImplementedError(
                "subsurface (dipole) term in volpath: the reference's "
                "volumetric tracer has no dipole term; DipoleTracer "
                "(models/sss.py) renders subsurface scenes")
        dev = self.device
        N = o.shape[0]
        hit = self.closest(o, d, torch.zeros(N, device=dev),
                           torch.full((N,), 3e38, device=dev), scene.geom)
        s = dict(
            o=o, d=d, its=common.fill_intersection(scene, o, d, hit),
            L=torch.zeros((N, 3), device=dev),
            tp=torch.ones((N, 3), device=dev),
            eta=torch.ones(N, device=dev),
            alive=torch.ones(N, dtype=torch.bool, device=dev),
            last_pdf=torch.zeros(N, device=dev),
            last_delta=torch.ones(N, dtype=torch.bool, device=dev),
            last_vtx=o,                       # origin of the MIS segment
            medium=torch.full((N,), self.sensor_medium, dtype=torch.int32,
                              device=dev),
            depth=torch.zeros(N, dtype=torch.int32, device=dev),
        )
        # the tracking loops draw 2 x trackingSteps dims from these lanes
        track_u2 = (lane_uniform_2d(seed, pixel_id, sample_idx)
                    if self.has_het else None)
        for b in range(self.n_iters):
            s = self._step(scene, s, b, seed, sample_idx, pixel_id, N,
                           track_u2)

        # final emitter-hit pass for the last reached vertex, after the
        # last segment's transmittance (evaluated deterministically)
        tp = s["tp"]
        if self.settings.has_media:
            t_last = torch.where(s["its"].valid, s["its"].t, 3e38)
            if self.has_het:
                K = self.track_steps

                def u_fin(k):
                    return track_u2(FINAL_TRACK_DIM_BASE + 2 * k)
                # only live lanes receive the last emitter hit
                tr_f = med_ops.transmittance_tracking(
                    scene.media, torch.where(s["alive"], s["medium"], -1),
                    s["o"], s["d"], t_last, u_fin, K)
            else:
                _, sigma_t_f, _, _, _ = med_ops.gather(scene.media,
                                                       s["medium"])
                tr_f = med_ops.transmittance(sigma_t_f, t_last)
            tp = tp * tr_f
        return s["L"] + self._emitted(scene, s["its"], s["last_vtx"],
                                      s["d"], s["alive"], tp,
                                      s["last_pdf"], s["last_delta"])

    def _step(self, scene, s, b, seed, sample_idx, pixel_id, N, track_u2):
        st = self.settings
        dev = self.device
        eps = scene.ray_eps
        g = scene.geom
        u1, u2 = self._u1, self._u2
        its = s["its"]
        alive = s["alive"]
        tp = s["tp"]
        cur_med = s["medium"]
        depth_prev = s["depth"]
        cur_depth = depth_prev + 1   # depth if this event is real

        # ---- free flight in the current medium ------------------------------
        t_surf = torch.where(its.valid, its.t, 3e38)
        sigma_s, sigma_t, ph_kind, ph_g, ph_flake = med_ops.gather(
            scene.media, cur_med)
        if self.has_het:
            K = self.track_steps

            def u_trk(k):
                return track_u2(TRACK_DIM_BASE + b * 2 * K + 2 * k)
            # dead lanes' samples are discarded: not tracked
            ds_med = med_ops.sample_distance_tracking(
                scene.media, torch.where(alive, cur_med, -1), s["o"],
                s["d"], t_surf, u_trk, K)
        else:
            uch = u1(seed, pixel_id, sample_idx,
                     _media_dim(b, D_MED_CHANNEL))
            udist = u1(seed, pixel_id, sample_idx,
                       _media_dim(b, D_MED_DIST))
            ds_med = med_ops.sample_distance(sigma_s, sigma_t, uch, udist,
                                             t_surf)
        med_event = alive & ds_med.scattered
        tp = torch.where(_b3(alive), tp * ds_med.weight, tp)

        # ---- medium event: phase NEE ----------------------------------------
        p_med = s["o"] + ds_med.t[..., None] * s["d"]
        wi_world = -s["d"]
        if self.has_orient:
            ph_flake = med_ops.flake_at(scene.media, cur_med, p_med)
        u_sel = u1(seed, pixel_id, sample_idx,
                   DA.bounce_dim(b, DA.D_LIGHT_SELECT))
        u_pos = u2(seed, pixel_id, sample_idx,
                   DA.bounce_dim(b, DA.D_LIGHT_UV))
        # one emitter sample serves both branches (medium point or surface
        # point)
        vtx = torch.where(_b3(med_event), p_med, its.p)
        ds = em_ops.sample_direct(scene, self.n_area, self.env_kind, vtx,
                                  u_sel, u_pos, n_delta=self.n_delta)
        ph_f = med_ops.phase_eval(ph_kind, ph_g, wi_world, ds.d, ph_flake)
        w_nee_med = torch.where(ds.is_delta, 1.0, mis_weight(ds.pdf, ph_f))

        # ---- surface event --------------------------------------------------
        surf_event = alive & ~med_event
        L = s["L"] + self._emitted(scene, its, s["last_vtx"], s["d"],
                                   surf_event, tp, s["last_pdf"],
                                   s["last_delta"])
        k_here = scene.materials.kind[torch.clamp_min(its.bsdf_id, 0).long()]
        is_null = its.valid & (its.bsdf_id >= 0) & (k_here == NULL_BSDF)
        real_surf = surf_event & its.valid & ~is_null
        null_surf = surf_event & is_null

        # depth bookkeeping + maxDepth cut: the current vertex may still
        # receive emitter radiance at depth == max_depth (above)
        is_real_vtx = med_event | real_surf
        alive = alive & (med_event | null_surf | real_surf)
        if st.max_depth > 0:
            alive = alive & ~(is_real_vtx & (cur_depth >= st.max_depth))

        # ---- surface shading (as in path.py) --------------------------------
        ss_f, ts_f = m.build_frame(its.ns)
        wi = m.to_local(wi_world, ss_f, ts_f, its.ns)
        params = common.material_params(scene, self.has_textures,
                                        its.bsdf_id, its.uv, bary=its.bary)
        wo_l = m.to_local(ds.d, ss_f, ts_f, its.ns)
        f_l = self._beval(params, wi, wo_l)
        pdf_b = self._bpdf(params, wi, wo_l)
        w_nee_surf = torch.where(ds.is_delta, 1.0, mis_weight(ds.pdf, pdf_b))

        # ---- shared attenuated shadow ray -----------------------------------
        nee_possible = (med_event | real_surf) & ds.valid & (ds.pdf > 0)
        sh_o = torch.where(_b3(med_event), p_med,
                           common.offset_ray_origin(its.p, its.ng, ds.d,
                                                    eps))
        sh_dist = ds.dist - 2.0 * eps / torch.clamp_min(
            torch.abs(m.dot(ds.d, ds.n)), 1e-3)
        # starting medium of the shadow segment
        sid = torch.clamp_min(its.shape_id, 0).long()
        trans = (g.shape_interior[sid] >= 0) | (g.shape_exterior[sid] >= 0)
        sh_med_surf = torch.where(
            trans,
            torch.where(m.dot(ds.d, its.ng) > 0, g.shape_exterior[sid],
                        g.shape_interior[sid]),
            cur_med)
        sh_med = torch.where(med_event, cur_med, sh_med_surf)
        if st.has_media:
            tr_sh = self._attenuated_tr(
                scene, sh_o, ds.d, sh_dist, sh_med, nee_possible,
                track_u2=track_u2, bounce=b)
        else:
            occl = self.occluded(sh_o, ds.d, torch.zeros(N, device=dev),
                                 sh_dist, g)
            tr_sh = torch.where(_b3(occl), 0.0,
                                torch.ones((N, 3), device=dev))
        f_nee = torch.where(_b3(med_event),
                            _b3(ph_f * w_nee_med) *
                            torch.ones((N, 3), device=dev),
                            f_l * _b3(w_nee_surf))
        contrib = tp * f_nee * ds.radiance * tr_sh / _b3(
            torch.clamp_min(ds.pdf, 1e-30))
        L = L + torch.where(_b3(nee_possible), contrib, 0.0)

        # ---- continuation direction -----------------------------------------
        u_bs = u2(seed, pixel_id, sample_idx, DA.bounce_dim(b, DA.D_BSDF_UV))
        u_bc = u1(seed, pixel_id, sample_idx,
                  DA.bounce_dim(b, DA.D_BSDF_COMPONENT))
        bs = self._bsample(params, wi, u_bs, u_bc)
        u_ph = u2(seed, pixel_id, sample_idx, _media_dim(b, D_PHASE_UV))
        wo_phase, phase_pdf = med_ops.phase_sample(ph_kind, ph_g, wi_world,
                                                   u_ph, ph_flake)
        wo_world_s = m.to_world(bs.wo, ss_f, ts_f, its.ns)
        new_d = torch.where(_b3(med_event), wo_phase, wo_world_s)
        new_o = torch.where(
            _b3(med_event), p_med,
            common.offset_ray_origin(
                its.p, its.ng,
                torch.where(_b3(surf_event), wo_world_s, s["d"]), eps))

        alive = alive & torch.where(real_surf, bs.valid, True)
        tp = torch.where(_b3(alive & real_surf), tp * bs.weight, tp)
        eta = torch.where(alive & real_surf, s["eta"] * bs.eta, s["eta"])

        # medium transition on the main ray: null pass-through keeps the
        # direction; real transmission crosses when the new direction
        # leaves through the back side
        crossed = m.dot(new_d, its.ng) * m.dot(wi_world, its.ng) < 0
        new_med_side, _ = self._medium_across(g, sid, new_d, its.ng)
        switch = surf_event & its.valid & trans & (is_null | crossed)
        new_med = torch.where(switch, new_med_side, cur_med)

        # MIS bookkeeping: null crossings keep the last real vertex's pdf
        # and origin
        last_pdf = torch.where(med_event, phase_pdf,
                               torch.where(real_surf, bs.pdf, s["last_pdf"]))
        last_delta = torch.where(med_event, False,
                                 torch.where(real_surf, bs.is_delta,
                                             s["last_delta"]))
        last_vtx = torch.where(_b3(med_event | real_surf),
                               torch.where(_b3(med_event), p_med, its.p),
                               s["last_vtx"])
        depth = torch.where(is_real_vtx, cur_depth, depth_prev)

        # ---- russian roulette (real vertices only) --------------------------
        u_rr = u1(seed, pixel_id, sample_idx, DA.bounce_dim(b, DA.D_RR))
        q = torch.clamp_max(tp.amax(-1) * eta * eta, 0.95)
        do_rr = is_real_vtx & (cur_depth >= st.rr_depth)
        survive = torch.where(do_rr, u_rr < q, True)
        tp = torch.where(_b3(do_rr & alive),
                         tp / _b3(torch.clamp_min(q, 1e-9)), tp)
        alive = alive & survive & (tp.amax(-1) > 0)

        # ---- next intersection ----------------------------------------------
        hit = self.closest(new_o, new_d, torch.zeros(N, device=dev),
                           torch.where(alive, 3e38, -1.0), g)
        its_new = common.fill_intersection(scene, new_o, new_d, hit)
        return dict(o=new_o, d=new_d, its=its_new, L=L, tp=tp, eta=eta,
                    alive=alive, last_pdf=last_pdf, last_delta=last_delta,
                    last_vtx=last_vtx, medium=new_med, depth=depth)


def render(scene, settings, seed=0, spp=None):
    return VolPathTracer(scene, settings).render(scene, seed=seed, spp=spp)
