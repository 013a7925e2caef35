"""Gradient-Domain Path Tracing (G-PT).

Counterpart of gradientdomain_mitsuba_tpu/models/gpt.py (the fork's
src/integrators/gpt/gpt.cpp, Kettunen et al. 2015): a lockstep wavefront
where the base path through every pixel and its FOUR shift-mapped offset
paths (x+-1, y+-1) advance one bounce per step as stacked SoA batches.
The counter RNG makes the offsets replay the base path's numbers.  The
estimator, the 4-technique MIS, the reconnection, environment and
half-vector shifts and the suffix factorization are the reference's,
step for step (see its module docstring); `jit` and `fori_loop` become
eager code and Python loops, and the scene's device is the tensors'
device.

Ported: the kinds of bsdf.PORTED_KINDS, delta (conductor, dielectric,
thin dielectric) and glossy vertices through the half-vector copy
(half_vector_copy, shared with G-BDPT's prefix replay; any_specular
selects the branch that runs full offsets at every bounce), area lights
delta lights (a point / spot offset sees the shared light point with
its own 1/d^2, a directional one the shared direction) and the constant
environment and envmap (the environment shift), every sensor, and every
texture of the reference (the primary hits' mip level and anisotropic
filter, the barycentric payload, woven cloth) for the base and the
offset paths.  Like the reference's, the copy treats a thin dielectric
offset as a solid one: it refracts about the normal with the offset's
eta where thindielectric.cpp passes straight through (ROADMAP Queue 3).
aux_only=True is the reference's restricted tracer that G-BDPT embeds
for the environment / delta-light family.
"""
from __future__ import annotations

import functools
import os

import torch

from ..config import configure
from ..core import math as m
from ..core.records import tree_map
from ..core.rng import DimAllocator as DA
from ..core.rng import make_sampler
from ..ops import bsdf as bsdf_ops
from ..ops import common, emitter as em_ops
from ..ops import film as film_ops
from ..ops import sensor as sensor_ops
from ..scene.materials import CONDUCTOR, DIELECTRIC, THIN_DIELECTRIC
from .path import MAX_BOUNCES_UNLIMITED, mis_weight, primary_footprint

# film-space shifts: +x, -x, +y, -y
OFFSETS = ((1.0, 0.0), (-1.0, 0.0), (0.0, 1.0), (0.0, -1.0))

CONN_NONE, CONN_RECENT, CONN_DONE = 0, 1, 2

# lanes per pass (each lane carries 5 lockstep paths) unless GDMT_LANES
# says otherwise: the reference's default, so both packages assign the
# same sample indices per pass
LANES = 1 << 18


def _b3(x):
    return x[..., None]


def _where(c, a, b):
    return torch.where(c, a, b)


def half_vector_copy(beval, bpdf, wi_m, wo_m, par_m, is_delta_m, wi_o,
                     par_o):
    """Half-vector copy shift (gpt.cpp halfVectorShift; reference
    gpt.py:67), shape-agnostic: the BASE quantities broadcast against the
    offset batch.  wi / wo are LOCAL directions in each vertex's own
    shading frame.  Returns dict(wo, f, pdf, jac, valid, is_delta): the
    offset's outgoing direction in ITS local frame, f*cos, the sampling
    pdf, the |dwo_o/dH| / |dwo_m/dH| Jacobian ratio and validity.  Shared
    by G-PT's per-bounce shift and G-BDPT's eye-subpath prefix replay."""
    refract = (wi_m[..., 2] * wo_m[..., 2]) < 0  # transmission at base
    eta_m = par_m.eta[..., 0]
    eta_o = par_o.eta[..., 0]

    # base half-vector in its local frame
    h_refl = m.normalize(wi_m + wo_m)
    h_refl = h_refl * torch.sign(h_refl[..., 2:3])
    rel_eta_m = _where(wi_m[..., 2] >= 0, eta_m,
                       1.0 / torch.clamp_min(eta_m, 1e-9))
    h_refr = m.normalize(-(wi_m + _b3(rel_eta_m) * wo_m))
    h_refr = h_refr * torch.sign(h_refr[..., 2:3])
    h_m = _where(_b3(refract), h_refr, h_refl)

    # delta offset materials use their own normal as H
    kind_o = par_o.kind
    is_delta_o = ((kind_o == CONDUCTOR) | (kind_o == DIELECTRIC) |
                  (kind_o == THIN_DIELECTRIC))
    z_axis = torch.zeros_like(h_m)
    z_axis[..., 2] = 1.0
    h_o = _where(_b3(is_delta_o), z_axis, h_m)

    widh = m.dot(wi_o, h_o)
    # reflection about H
    wo_refl = 2.0 * _b3(widh) * h_o - wi_o
    # refraction about H with the OFFSET's eta
    rel_eta_o = _where(wi_o[..., 2] >= 0, eta_o,
                       1.0 / torch.clamp_min(eta_o, 1e-9))
    c2 = 1.0 - (1.0 - widh * widh) / torch.clamp_min(
        rel_eta_o * rel_eta_o, 1e-18)
    tir = c2 <= 0.0
    cos_t = torch.sqrt(torch.clamp_min(c2, 0.0))
    sgn = torch.sign(widh)
    wo_refr = (-wi_o / _b3(rel_eta_o) +
               _b3(widh / rel_eta_o - sgn * cos_t) * h_o)
    wo_refr = m.normalize(wo_refr)
    wo_o = _where(_b3(refract), wo_refr, wo_refl)

    # validity: same structural event; hemisphere consistency
    same_hemi_refl = (wo_o[..., 2] * wi_o[..., 2]) > 0
    cross_hemi = (wo_o[..., 2] * wi_o[..., 2]) < 0
    valid_mode = _where(refract, cross_hemi & ~tir, same_hemi_refl)

    # f*cos and pdf at the offset vertex
    f_smooth = beval(par_o, wi_o, wo_o)
    pdf_smooth = bpdf(par_o, wi_o, wo_o)

    # delta offsets: discrete weights
    F_c = bsdf_ops.fresnel_conductor(wi_o[..., 2], par_o.eta, par_o.k)
    F_d, _ = bsdf_ops.fresnel_dielectric(wi_o[..., 2], eta_o)
    w_cond = par_o.specular * F_c
    w_die = _where(_b3(refract),
                   par_o.transmittance /
                   _b3(torch.clamp_min(rel_eta_o ** 2, 1e-9)),
                   par_o.specular)
    p_die = _where(refract, 1.0 - F_d, F_d)
    f_delta = _where(_b3(kind_o == CONDUCTOR), w_cond, w_die)
    pdf_delta = _where(kind_o == CONDUCTOR, torch.ones_like(F_d), p_die)

    f = _where(_b3(is_delta_o), f_delta, f_smooth)
    pdf = _where(is_delta_o, pdf_delta, pdf_smooth)

    # Jacobian |dwo/dH| ratio
    wodh_m = torch.abs(m.dot(wo_m, h_m))
    wodh_o = torch.abs(m.dot(wo_o, h_o))
    j_refl = wodh_o / torch.clamp_min(wodh_m, 1e-9)
    # refraction: |dwo/dH| = eta^2 |wo.H| / (wi.H + eta*wo.H)^2 with the
    # relative eta; ratio of offset/base
    den_m = (m.dot(wi_m, h_m) + rel_eta_m * m.dot(wo_m, h_m)) ** 2
    den_o = (m.dot(wi_o, h_o) + rel_eta_o * m.dot(wo_o, h_o)) ** 2
    j_refr = ((rel_eta_o ** 2) * wodh_o / torch.clamp_min(den_o, 1e-12)) / \
        torch.clamp_min((rel_eta_m ** 2) * wodh_m /
                        torch.clamp_min(den_m, 1e-12), 1e-12)
    jac = _where(refract, j_refr, j_refl)

    # structural consistency: a delta base bounce must map to a delta
    # offset bounce and vice versa (classification-mismatch kill)
    delta_match = is_delta_o == is_delta_m
    valid = (valid_mode & delta_match & (f.amax(-1) > 0) &
             torch.isfinite(jac) & (jac > 0))
    return dict(wo=wo_o, f=f, pdf=pdf, jac=jac, valid=valid,
                is_delta=is_delta_o)


class GPTracer:
    """Gradient-domain path tracer (also the BASE path machinery for the
    primal-parity check: with the gradients ignored, primal + very_direct
    is the path tracer's image)."""

    def __init__(self, scene, settings, aux_only=False):
        """aux_only=True restricts the estimator to the environment /
        delta-light family (NEE over the delta lights and the
        environment, the environment escape; area-emitter contributions
        zeroed): G-BDPT embeds this tracer for the family its (s,t)
        strategies do not cover (models/gbdpt.py)."""
        configure()
        self.kinds = bsdf_ops.scene_kinds(scene)
        p = settings.integrator_props
        self.shift_threshold = float(p.get("shiftThreshold", 0.001))
        # static: does any material classify as specular/glossy for
        # shifting?  All-diffuse scenes skip the half-vector machinery and
        # its per-bounce offset continuation rays entirely
        self.any_specular = bsdf_ops.any_specular(scene.materials,
                                                  self.shift_threshold)
        self.sensor = sensor_ops.describe(scene.camera)
        self._beval = functools.partial(bsdf_ops.eval, kinds=self.kinds)
        self._bpdf = functools.partial(bsdf_ops.pdf, kinds=self.kinds)
        self._bsample = functools.partial(bsdf_ops.sample, kinds=self.kinds)
        self.settings = settings
        self.device = scene.geom.linC.device
        self.aux_only = bool(aux_only)
        # NEE selection and MIS densities skip the area lights in aux_only
        self.n_area = (0 if self.aux_only else
                       int((scene.emitters.tri_count > 0).sum()))
        self.env_kind = settings.env_kind
        self.has_env = settings.env_kind != 0
        self.n_delta = settings.n_delta
        # emitters NEE picks among: area, delta lights, environment
        self.n_lights = self.n_area + self.n_delta + (1 if self.has_env
                                                      else 0)
        self.has_textures = settings.has_textures
        self.has_ewa = settings.has_ewa
        n_tris = int(scene.geom.indices.shape[0])
        closest, occluded = common.choose_intersector(
            settings, n_tris, int(scene.geom.clusters.offset.shape[0]))
        # the kernels this tracer launches (their .launches count)
        self.kernels = (closest.kernel, occluded.kernel)
        self.closest, self.occluded = common.instrument_intersectors(
            self, closest, occluded)
        self.count_rays = False  # set True BEFORE a render to count rays
        self.ray_tally = None
        self.last_ray_count = None
        md = settings.max_depth
        self.n_bounces = (md - 1 if md > 0 else MAX_BOUNCES_UNLIMITED)
        self.filter_kind = film_ops.FILTERS.get(settings.rfilter, 0)
        self._u1, self._u2 = make_sampler(settings.sampler, settings.spp)

    # ------------------------------------------------------------------
    def _classify_diffuse(self, scene, bsdf_id, valid):
        """VERTEX_TYPE_DIFFUSE iff roughness > shiftThreshold."""
        rough = bsdf_ops.roughness(scene.materials,
                                   torch.clamp_min(bsdf_id, 0))
        return valid & (rough > self.shift_threshold)

    # ------------------------------------------------------------------
    def trace_pass(self, scene, seed, sample_idx, pixel_id=None):
        """Trace one sample for a batch of pixels (default: whole frame).
        Returns (film positions [N,2], primal [N,3], very_direct [N,3],
        gradients [4,N,3])."""
        st = self.settings
        W, H = st.width, st.height
        eps = scene.ray_eps
        dev = self.device
        if pixel_id is None:
            pixel_id = torch.arange(W * H, dtype=torch.int64, device=dev)
        N = pixel_id.shape[0]
        px = (pixel_id % W).to(torch.float32)
        py = (pixel_id // W).to(torch.float32)

        jitter = self._u2(seed, pixel_id, sample_idx, DA.PIXEL_JITTER)
        pos_film = torch.stack([px, py], -1) + jitter
        u_ap = self._u2(seed, pixel_id, sample_idx, DA.APERTURE)

        # base + 4 offset camera rays (same jitter/aperture randoms)
        o_m, d_m = sensor_ops.sample_ray(self.sensor, W, H, pos_film, u_ap)
        offs = torch.tensor(OFFSETS, dtype=torch.float32, device=dev)
        pos_off = pos_film[None] + offs[:, None, :]
        o_o, d_o = sensor_ops.sample_ray(
            self.sensor, W, H, pos_off.reshape(4 * N, 2), u_ap.repeat(4, 1))
        o_o = o_o.reshape(4, N, 3)
        d_o = d_o.reshape(4, N, 3)
        zeros4 = torch.zeros(4 * N, device=dev)

        def trace4(o, d, maxt):
            o2, d2 = o.reshape(4 * N, 3), d.reshape(4 * N, 3)
            hit = self.closest(o2, d2, zeros4, maxt.reshape(4 * N),
                               scene.geom)
            its = common.fill_intersection(scene, o2, d2, hit)
            return tree_map(lambda a: a.reshape((4, N) + a.shape[1:]), its)

        def occl4(o, d, maxt):
            return self.occluded(
                o.reshape(4 * N, 3), d.reshape(4 * N, 3), zeros4,
                maxt.reshape(4 * N), scene.geom).reshape(4, N)

        inf = torch.full((N,), 3e38, device=dev)
        hit_m = self.closest(o_m, d_m, torch.zeros(N, device=dev), inf,
                             scene.geom)
        its_m = common.fill_intersection(scene, o_m, d_m, hit_m)
        its_o = trace4(o_o, d_o, inf.expand(4, N))

        # ---- very direct (depth 1): main only, excluded from gradients ----
        very = torch.zeros((N, 3), device=dev)
        if not self.aux_only:
            cosf = m.dot(its_m.ns, -d_m)
            is_em = its_m.valid & (its_m.emitter_id >= 0) & (cosf > 0)
            rad = scene.emitters.radiance[
                torch.clamp_min(its_m.emitter_id, 0).long()]
            very = very + _where(_b3(is_em), rad, 0.0)
        if self.has_env:
            very = very + _where(_b3(~its_m.valid),
                                 em_ops.eval_env(scene, self.env_kind, d_m),
                                 0.0)

        state = dict(
            # main
            d=d_m, its=its_m,
            tp=torch.ones((N, 3), device=dev),
            eta=torch.ones(N, device=dev),
            alive=its_m.valid,
            primal=torch.zeros((N, 3), device=dev),
            # offsets [4, N]
            o_its=its_o,
            o_wi=-d_o,
            o_tp=torch.ones((4, N, 3), device=dev),
            o_r=torch.ones((4, N), device=dev),
            o_alive=its_o.valid & its_m.valid[None],
            o_conn=torch.zeros((4, N), dtype=torch.int32, device=dev),
            grad=torch.zeros((4, N, 3), device=dev),
        )

        # mip level: primary hits only (bounce 0), as in the reference
        fp_m = fp_o = None
        if self.has_textures and self.n_bounces > 0:
            fp_m = primary_footprint(self, scene, d_m, its_m)
            fp_o = primary_footprint(self, scene, d_o, its_o)

        if self.n_bounces > 0:
            state = self._bounce(scene, state, 0, seed, sample_idx,
                                 pixel_id, N, eps, occl4, trace4, True,
                                 fp_main=fp_m, fp_off=fp_o)
        if self.any_specular:
            # an offset may stay NOT CONNECTED through any number of
            # half-vector copies: every bounce runs the full offsets
            for b in range(1, self.n_bounces):
                state = self._bounce(scene, state, b, seed, sample_idx,
                                     pixel_id, N, eps, occl4, trace4, True)
            return pos_film, state["primal"], very, state["grad"]
        # no specular vertex: after bounce 0 every live offset is CONNECTED
        # (reconnection either succeeded or the shift died), so bounce 1
        # runs without the not-connected machinery
        if self.n_bounces > 1:
            state = self._bounce(scene, state, 1, seed, sample_idx,
                                 pixel_id, N, eps, occl4, trace4, False)
        if self.n_bounces > 2:
            # SUFFIX FACTORIZATION (reference gpt.py:330-373): every
            # offset is now CONN_DONE or dead, so the rest of the gradient
            # is (rho - 1) / (1 + r^2) * primal_rest with rho = o_tp / tp
            # and r = o_r constant; the remaining bounces run the plain
            # path-tracer subset only
            alive = state["alive"]
            o_alive = state["o_alive"]
            tp_safe = torch.clamp_min(state["tp"], 1e-30)
            rho = _where(_b3(o_alive), state["o_tp"] / tp_safe[None], 0.0)
            r_c = _where(o_alive, state["o_r"], 0.0)
            coeff = _where(_b3(o_alive | alive[None]),
                           (rho - 1.0) / _b3(1.0 + r_c * r_c), 0.0)
            rest = dict(state)
            rest["primal"] = torch.zeros_like(state["primal"])
            for b in range(2, self.n_bounces):
                rest = self._bounce(scene, rest, b, seed, sample_idx,
                                    pixel_id, N, eps, occl4, trace4,
                                    False, with_offsets=False)
            state["primal"] = state["primal"] + rest["primal"]
            state["grad"] = state["grad"] + coeff * rest["primal"][None]
        return pos_film, state["primal"], very, state["grad"]

    # ------------------------------------------------------------------
    def _bounce(self, scene, s, b, seed, sample_idx, pixel_id, N, eps,
                occl4, trace4, allow_conn0=True, with_offsets=True,
                fp_main=None, fp_off=None):
        """One lockstep bounce.  with_offsets=False runs the plain-PT
        subset only (main NEE + main BSDF segment, offset state passed
        through untouched)."""
        st = self.settings
        dev = self.device
        depth = b + 1
        its = s["its"]
        alive = s["alive"] & its.valid
        wi_w = -s["d"]
        tp = s["tp"]
        primal = s["primal"]
        grad = s["grad"]

        o_its, o_wi = s["o_its"], s["o_wi"]
        o_tp, o_r, o_conn = s["o_tp"], s["o_r"], s["o_conn"]
        o_alive = s["o_alive"] & alive[None]

        # frames & params: main
        ss_m, ts_m = m.build_frame(its.ns)
        wi_m = m.to_local(wi_w, ss_m, ts_m, its.ns)
        par_m = common.material_params(scene, self.has_textures,
                                       its.bsdf_id, its.uv,
                                       uv_footprint=fp_main, bary=its.bary)
        c_main = self._classify_diffuse(scene, its.bsdf_id, its.valid)

        if with_offsets:
            # frames & params: offsets (own vertices; only used conn==0)
            ss_o, ts_o = m.build_frame(o_its.ns)
            wi_o_loc = m.to_local(o_wi, ss_o, ts_o, o_its.ns)
            par_o = common.material_params(scene, self.has_textures,
                                           o_its.bsdf_id, o_its.uv,
                                           uv_footprint=fp_off,
                                           bary=o_its.bary)
            c_off = self._classify_diffuse(scene, o_its.bsdf_id,
                                           o_its.valid)
            # wi of offsets expressed in MAIN frame (conn>=1 states)
            wi_o_main = m.to_local(o_wi, ss_m[None], ts_m[None],
                                   its.ns[None])

        ext_alive = alive
        if st.max_depth > 0:
            ext_alive = alive & (depth < st.max_depth)

        # ================= NEE (light-sampling strategy) ==================
        u_sel = self._u1(seed, pixel_id, sample_idx,
                         DA.bounce_dim(b, DA.D_LIGHT_SELECT))
        u_pos = self._u2(seed, pixel_id, sample_idx,
                         DA.bounce_dim(b, DA.D_LIGHT_UV))
        ds = em_ops.sample_direct(scene, self.n_area, self.env_kind,
                                  its.p, u_sel, u_pos, n_delta=self.n_delta)
        if self.n_lights > 0:
            # unified-measure quantities (area for surfaces, solid angle
            # for the environment)
            conv_m = _where(ds.is_env | ds.is_delta, 1.0,
                            torch.clamp_min(-m.dot(ds.d, ds.n), 0.0) /
                            torch.clamp_min(ds.dist ** 2, 1e-12))
            pe_u = _where(ds.is_env, ds.pdf, ds.pdf_area)
            wo_l_m = m.to_local(ds.d, ss_m, ts_m, its.ns)
            f_m = self._beval(par_m, wi_m, wo_l_m)
            pb_m_u = _where(ds.is_delta, 0.0,
                            self._bpdf(par_m, wi_m, wo_l_m) * conv_m)
            sh_o = common.offset_ray_origin(its.p, its.ng, ds.d, eps)
            nee_live_m = ext_alive & ds.valid & (pe_u > 0)
            maxt_m_sh = _where(
                nee_live_m,
                ds.dist - 2 * eps / torch.clamp_min(
                    torch.abs(m.dot(ds.d, ds.n)), 1e-3), -1.0)

            # ---- offsets -------------------------------------------------
            # conn==0: evaluate from own vertex y_k toward the SAME light pt
            if with_offsets and allow_conn0:
                to_l = ds.p[None] - o_its.p
                dist_o = torch.sqrt(torch.clamp_min(m.squared_length(to_l),
                                                    1e-12))
                # directional delta lights keep the shared direction
                is_dirlt = ds.is_delta & (ds.dist > 1e6)
                d_o_l = _where(_b3((ds.is_env | is_dirlt)[None]),
                               ds.d[None].expand(to_l.shape),
                               to_l / _b3(dist_o))
                # delta point/spot: radiance carries 1/d^2 per side
                conv_o0 = _where(
                    (ds.is_env | is_dirlt)[None], 1.0,
                    _where(ds.is_delta[None],
                           ds.dist[None] ** 2 /
                           torch.clamp_min(dist_o ** 2, 1e-12),
                           torch.clamp_min(-m.dot(d_o_l, ds.n[None]), 0.0) /
                           torch.clamp_min(dist_o ** 2, 1e-12)))
                wo_l_o0 = m.to_local(d_o_l, ss_o, ts_o, o_its.ns)
                f_o0 = self._beval(par_o, wi_o_loc, wo_l_o0)
                pb_o0_u = _where(
                    ds.is_delta[None], 0.0,
                    self._bpdf(par_o, wi_o_loc, wo_l_o0) * conv_o0)
                sh_oo = common.offset_ray_origin(o_its.p, o_its.ng,
                                                 d_o_l, eps)
                # dead offset lanes masked with maxt=-1 (kernel skips
                # them; the measured ray counter stays honest)
                nee_live_o = (o_alive & (o_conn == CONN_NONE) &
                              nee_live_m[None])
                maxt_o_sh = _where(
                    nee_live_o,
                    _where(ds.is_env[None], ds.dist[None].expand(
                        dist_o.shape), dist_o) - 2 * eps / torch.clamp_min(
                        torch.abs(m.dot(d_o_l, ds.n[None])), 1e-3),
                    -1.0)
                # FUSED shadow batch: main + 4 offset NEE rays in ONE
                # traversal call (5N lanes)
                occ5 = self.occluded(
                    torch.cat([sh_o[None], sh_oo]).reshape(5 * N, 3),
                    torch.cat([ds.d[None], d_o_l]).reshape(5 * N, 3),
                    torch.zeros(5 * N, device=dev),
                    torch.cat([maxt_m_sh[None], maxt_o_sh]).reshape(5 * N),
                    scene.geom).reshape(5, N)
                occ_m = occ5[0]
                occ_o0 = occ5[1:]
            else:
                occ_m = self.occluded(sh_o, ds.d, torch.zeros(N, device=dev),
                                      maxt_m_sh, scene.geom)
            vis_m = nee_live_m & ~occ_m
            c_m_val = (tp * f_m * ds.radiance *
                       _b3(conv_m / torch.clamp_min(pe_u, 1e-30)))
            contrib_m = _where(_b3(vis_m), c_m_val, 0.0)
            # primal: standard light-vs-bsdf MIS
            w_std = mis_weight(pe_u, pb_m_u)
            primal = primal + contrib_m * _b3(w_std)

            if not (with_offsets and allow_conn0):
                f_o0 = torch.zeros_like(o_tp)
                pb_o0_u = torch.zeros_like(o_r)
                conv_o0 = torch.zeros_like(o_r)
                occ_o0 = torch.ones_like(o_alive)
            if with_offsets:
                # conn==1: same vertex as main, different wi
                f_o1 = self._beval(par_m, wi_o_main, wo_l_m[None])
                pb_o1_u = _where(ds.is_delta[None], 0.0,
                                 self._bpdf(par_m, wi_o_main,
                                            wo_l_m[None]) * conv_m[None])

                is0 = o_conn == CONN_NONE
                is1 = o_conn == CONN_RECENT
                f_o = _where(_b3(is0), f_o0,
                             _where(_b3(is1), f_o1, f_m[None]))
                pb_o_u = _where(is0, pb_o0_u,
                                _where(is1, pb_o1_u, pb_m_u[None]))
                conv_o = _where(is0, conv_o0, conv_m[None])
                vis_o = _where(is0, ~occ_o0, ~occ_m[None])
                ok_o = o_alive & vis_o & vis_m[None]
                c_o_val = (o_tp * f_o * ds.radiance[None] *
                           _b3(conv_o / torch.clamp_min(pe_u, 1e-30)[None]))
                contrib_o = _where(_b3(ok_o), c_o_val, 0.0)
                r_eff = _where(ok_o, o_r, 0.0)

                pe2 = (pe_u * pe_u)[None]
                den = (pe2 + (pb_m_u * pb_m_u)[None] +
                       r_eff * r_eff * (pe2 + pb_o_u * pb_o_u))
                w_pair = _where(vis_m[None] | ok_o,
                                pe2 / torch.clamp_min(den, 1e-30), 0.0)
                grad = grad + w_pair[..., None] * (contrib_o -
                                                   contrib_m[None])

        # ================= BSDF-sampling strategy =========================
        u2 = self._u2(seed, pixel_id, sample_idx,
                      DA.bounce_dim(b, DA.D_BSDF_UV))
        uc = self._u1(seed, pixel_id, sample_idx,
                      DA.bounce_dim(b, DA.D_BSDF_COMPONENT))
        bs = self._bsample(par_m, wi_m, u2, uc)
        main_cont = ext_alive & bs.valid
        wo_w = m.to_world(bs.wo, ss_m, ts_m, its.ns)
        o_new = common.offset_ray_origin(its.p, its.ng, wo_w, eps)
        tp_new = _where(_b3(main_cont), tp * bs.weight, 0.0)
        pb_m_sa = bs.pdf

        hit_n = self.closest(o_new, wo_w, torch.zeros(N, device=dev),
                             _where(main_cont, 3e38, -1.0), scene.geom)
        its_n = common.fill_intersection(scene, o_new, wo_w, hit_n)

        # geometry of the new segment (main)
        cos_n_m = torch.abs(m.dot(its_n.ng, wo_w))
        dist2_m = torch.clamp_min(its_n.t ** 2, 1e-12)
        conv_m_seg = _where(its_n.valid, cos_n_m / dist2_m, 1.0)
        pb_m_u = _where(bs.is_delta, 0.0, pb_m_sa) * conv_m_seg

        # emission seen by the main path at the new vertex
        cosf_n = m.dot(its_n.ns, -wo_w)
        hit_em = its_n.valid & (its_n.emitter_id >= 0) & (cosf_n > 0)
        if self.aux_only:  # area-emitter hits belong to the (s,t) family
            hit_em = torch.zeros_like(hit_em)
        rad_n = scene.emitters.radiance[
            torch.clamp_min(its_n.emitter_id, 0).long()]
        em_of_shape = scene.geom.shape_emitter[
            torch.clamp_min(its_n.shape_id, 0).long()]
        pe_area_n = _where(
            hit_em,
            1.0 / (torch.clamp_min(
                scene.emitters.total_area[
                    torch.clamp_min(em_of_shape, 0).long()], 1e-12)
                * max(self.n_lights, 1)), 0.0)
        esc = main_cont & ~its_n.valid
        env_rad = em_ops.eval_env(scene, self.env_kind, wo_w)
        pe_env = em_ops.pdf_env_direct(scene, self.n_area, self.env_kind,
                                       wo_w, n_delta=self.n_delta)

        emit_m = _where(_b3(hit_em), rad_n, 0.0) + \
            _where(_b3(esc), env_rad, 0.0)
        pe_u_n = _where(esc, pe_env, pe_area_n)
        pb_for_mis = _where(esc, _where(bs.is_delta, 0.0, pb_m_sa), pb_m_u)
        has_emit_m = main_cont & (hit_em | esc)
        contrib_m_b = _where(_b3(has_emit_m), tp_new * emit_m, 0.0)
        w_std_b = _where(bs.is_delta, 1.0, mis_weight(pb_for_mis, pe_u_n))
        primal = primal + contrib_m_b * _b3(w_std_b)

        # ----------------- offset shift handling --------------------------
        if with_offsets:
            new = self._shift_offsets(
                scene, N, eps, occl4, trace4, wi_m, par_m, c_main, bs,
                wo_w, its_n, conv_m_seg, pb_m_sa, o_its, o_wi, wi_o_loc,
                wi_o_main, par_o, ss_o, ts_o, c_off, o_tp, o_r, o_conn,
                o_alive, main_cont, esc, allow_conn0)
            (o_its2, o_wi2, o_tp2, o_r2, o_conn2, o_alive2,
             off_emit, off_pb_u, off_pe_u) = new

            # pair MIS for the emission at the new vertex
            has_pair = has_emit_m | (o_alive2 &
                                     (m.squared_length(off_emit) > 0))
            r_eff_b = _where(o_alive2, o_r2, 0.0)
            num_b = _where(bs.is_delta[None], torch.ones_like(off_pb_u),
                           (pb_for_mis * pb_for_mis)[None])
            den_b = _where(
                bs.is_delta[None],
                1.0 + r_eff_b * r_eff_b,
                (pb_for_mis * pb_for_mis + pe_u_n * pe_u_n)[None] +
                r_eff_b * r_eff_b * (off_pb_u * off_pb_u +
                                     off_pe_u * off_pe_u))
            w_pair_b = _where(has_pair,
                              num_b / torch.clamp_min(den_b, 1e-30), 0.0)
            contrib_o_b = _where(_b3(o_alive2), o_tp2 * off_emit, 0.0)
            grad = grad + w_pair_b[..., None] * (contrib_o_b -
                                                 contrib_m_b[None])

        # ----------------- russian roulette (shared decision) -------------
        u_rr = self._u1(seed, pixel_id, sample_idx,
                        DA.bounce_dim(b, DA.D_RR))
        eta_new = _where(main_cont, s["eta"] * bs.eta, s["eta"])
        q = torch.clamp_max(tp_new.amax(-1) * eta_new * eta_new, 0.95)
        if (depth + 1) >= st.rr_depth:
            survive = u_rr < q
            inv_q = 1.0 / torch.clamp_min(q, 1e-9)
        else:
            survive = torch.ones_like(main_cont)
            inv_q = torch.ones_like(q)
        tp_new = tp_new * _b3(inv_q)
        alive_next = main_cont & its_n.valid & survive & \
            (tp_new.amax(-1) > 0)

        if not with_offsets:
            # plain-PT bounce: offset state frozen (the caller applies
            # the factorized gradient once at the end)
            return dict(
                d=wo_w, its=its_n, tp=tp_new, eta=eta_new,
                alive=alive_next, primal=primal,
                o_its=o_its, o_wi=o_wi, o_tp=o_tp, o_r=o_r,
                o_conn=o_conn, o_alive=s["o_alive"], grad=grad)

        o_tp2 = o_tp2 * inv_q[None, :, None]
        return dict(
            d=wo_w, its=its_n, tp=tp_new, eta=eta_new, alive=alive_next,
            primal=primal,
            o_its=o_its2, o_wi=o_wi2, o_tp=o_tp2, o_r=o_r2,
            o_conn=o_conn2, o_alive=o_alive2 & alive_next[None],
            grad=grad)

    # ------------------------------------------------------------------
    def _shift_offsets(self, scene, N, eps, occl4, trace4, wi_m, par_m,
                       c_main, bs, wo_w, its_n, conv_m_seg, pb_m_sa, o_its,
                       o_wi, wi_o_loc, wi_o_main, par_o, ss_o, ts_o, c_off,
                       o_tp, o_r, o_conn, o_alive, main_cont, esc,
                       allow_conn0=True):
        """Advance the 4 offset paths across the base path's BSDF segment
        (reconnection, environment and half-vector shifts; in an
        all-diffuse scene a non-reconnectable configuration kills the
        shift, as in the reference).  Returns the updated offset state +
        the per-offset emission/pdfs at the new vertex for the pair
        MIS."""
        dev = self.device
        is0 = o_conn == CONN_NONE
        is1 = o_conn == CONN_RECENT
        is2 = o_conn == CONN_DONE

        c_next = self._classify_diffuse(scene, its_n.bsdf_id, its_n.valid)

        # ========== connected (suffix shared): same multiplicative factors
        f_w_conn = bs.weight[None]          # f*cos/pdf of the base sample
        pb_conn = _where(bs.is_delta, 1.0, pb_m_sa)[None]

        # ========== recently connected: same vertex, own wi ==============
        f_o1 = self._beval(par_m, wi_o_main, bs.wo[None])
        pb_o1 = self._bpdf(par_m, wi_o_main, bs.wo[None])
        # a delta base sample from a RECENT state kills the shift
        ok1 = ~bs.is_delta[None] & (torch.abs(f_o1).amax(-1) >= 0)

        # ========== not connected: reconnection / env / half-vector ======
        recon_sel = c_main[None] & c_off & (c_next[None] | esc[None])

        wo_w4 = wo_w[None].expand(o_wi.shape)
        if allow_conn0:
            # --- reconnection to base's next vertex ----------------------
            to_n = its_n.p[None] - o_its.p
            dist_o2 = torch.clamp_min(m.squared_length(to_n), 1e-12)
            dist_o = torch.sqrt(dist_o2)
            dir_rc = to_n / _b3(dist_o)
            cos_n_o = torch.abs(m.dot(its_n.ng[None], dir_rc))
            conv_o_seg = cos_n_o / dist_o2
            jac_rc = conv_o_seg / torch.clamp_min(conv_m_seg[None], 1e-30)
            wo_rc = m.to_local(dir_rc, ss_o, ts_o, o_its.ns)
            f_rc = self._beval(par_o, wi_o_loc, wo_rc)
            pb_rc = self._bpdf(par_o, wi_o_loc, wo_rc)

            # --- environment shift (base escaped): BSDF eval only --------
            wo_env = m.to_local(wo_w4, ss_o, ts_o, o_its.ns)
            f_env = self._beval(par_o, wi_o_loc, wo_env)
            pb_env = self._bpdf(par_o, wi_o_loc, wo_env)

            # FUSED reconnection/environment visibility: the two shifts
            # are mutually exclusive per lane (esc selects), so ONE 4N
            # traversal call serves both; lanes that can use neither are
            # masked with maxt=-1
            dir_sh = _where(_b3(esc[None]), wo_w4, dir_rc)
            sh_all = common.offset_ray_origin(o_its.p, o_its.ng, dir_sh,
                                              eps)
            live_sh = (o_alive & is0 & recon_sel &
                       _where(esc[None],
                              torch.full((4, N), self.has_env,
                                         device=dev),
                              its_n.valid[None]))
            maxt_sh = _where(
                live_sh,
                _where(esc[None], 1e7,
                       dist_o - 2 * eps / torch.clamp_min(cos_n_o, 1e-3)),
                -1.0)
            occ_sh = occl4(sh_all, dir_sh, maxt_sh)
            ok_rc = (recon_sel & its_n.valid[None] & ~occ_sh &
                     (f_rc.amax(-1) > 0))
            ok_env = (recon_sel & esc[None] & ~occ_sh & live_sh &
                      (f_env.amax(-1) > 0))
        else:
            # no NOT-CONNECTED offsets can exist past bounce 0 in
            # all-diffuse scenes
            dir_rc = wo_w4
            conv_o_seg = conv_m_seg[None].expand(o_r.shape)
            jac_rc = torch.ones_like(o_r)
            f_rc = torch.zeros_like(o_tp)
            pb_rc = torch.zeros_like(o_r)
            ok_rc = torch.zeros_like(o_alive)
            f_env = torch.zeros_like(o_tp)
            pb_env = torch.zeros_like(o_r)
            ok_env = torch.zeros_like(o_alive)

        # --- half-vector copy --------------------------------------------
        hv_on = self.any_specular and allow_conn0
        if hv_on:
            use_hv = is0 & ~recon_sel
            hv = self._half_vector_shift(wi_m, par_m, bs, par_o, wi_o_loc)
            wo_hv_w = m.to_world(hv["wo"], ss_o, ts_o, o_its.ns)
            ok_hv = ~recon_sel & hv["valid"] & main_cont[None]
            # the offset's own continuation ray (maxt=-1 elsewhere: the
            # kernel skips those lanes and the ray counter stays honest)
            o_hv = common.offset_ray_origin(o_its.p, o_its.ng, wo_hv_w, eps)
            its_hv = trace4(o_hv, wo_hv_w, _where(ok_hv, 3e38, -1.0))
            fac_hv = hv["f"] * _b3(hv["jac"])
            r_fac_hv = hv["pdf"] * hv["jac"]
        else:
            # all-diffuse scene: a lane that can neither reconnect nor
            # take the environment shift kills the shift (the reference's
            # all-diffuse branch): zero throughput, pdf and emission
            ok_hv = torch.zeros_like(o_alive)
            fac_hv = r_fac_hv = 0.0

        # ---------------- merge the conn==0 strategies -------------------
        use_rc = is0 & recon_sel & ~esc[None]
        use_env = is0 & recon_sel & esc[None]

        pb_base = _where(bs.is_delta, 1.0, pb_m_sa)[None]
        # throughput factor f_offset*J / pdf_base (the unified measure
        # folds into jac_rc for reconnection; env / hv Jacobians explicit)
        fac0 = _where(
            _b3(use_rc), f_rc * _b3(jac_rc),
            _where(_b3(use_env), f_env, fac_hv)) / _b3(
            torch.clamp_min(pb_base, 1e-30))
        ok0 = _where(use_rc, ok_rc, _where(use_env, ok_env, ok_hv))
        # pdf ratio factor for this segment
        r_fac0 = _where(
            use_rc, pb_rc * jac_rc,
            _where(use_env, pb_env, r_fac_hv)) / torch.clamp_min(pb_base,
                                                                 1e-30)

        # ---------------- combine across connection states ---------------
        fac = _where(_b3(is2), f_w_conn,
                     _where(_b3(is1),
                            f_o1 / _b3(torch.clamp_min(pb_conn, 1e-30)),
                            fac0))
        r_fac = _where(is2, 1.0,
                       _where(is1, pb_o1 / torch.clamp_min(pb_conn, 1e-30),
                              r_fac0))
        ok = _where(is2, main_cont[None],
                    _where(is1, ok1 & main_cont[None], ok0))
        o_alive2 = o_alive & ok
        o_tp2 = _where(_b3(o_alive2), o_tp * fac, 0.0)
        o_r2 = _where(o_alive2, o_r * r_fac, 0.0)

        # ---------------- offset emission at the new vertex --------------
        # connected / recently / reconnection / env: the offset path
        # arrives at the SAME vertex as base (its_n) or the same
        # environment direction
        dir_in = _where(_b3(use_rc), dir_rc, wo_w4)
        cosf_o = m.dot(its_n.ns[None], -dir_in)
        hit_em_o = (its_n.valid[None] & (its_n.emitter_id[None] >= 0) &
                    (cosf_o > 0))
        if self.aux_only:
            hit_em_o = torch.zeros_like(hit_em_o)
        rad_np = scene.emitters.radiance[
            torch.clamp_min(its_n.emitter_id, 0).long()]
        env_rad_m = em_ops.eval_env(scene, self.env_kind, wo_w)
        pe_env_m = em_ops.pdf_env_direct(scene, self.n_area, self.env_kind,
                                         wo_w, n_delta=self.n_delta)
        pe_area_n = _where(
            its_n.valid & (its_n.emitter_id >= 0),
            1.0 / (torch.clamp_min(
                scene.emitters.total_area[
                    torch.clamp_min(its_n.emitter_id, 0).long()], 1e-12)
                * max(self.n_lights, 1)), 0.0)
        off_emit = (_where(_b3(hit_em_o), rad_np[None], 0.0) +
                    _where(_b3(esc[None]), env_rad_m[None], 0.0))
        off_pe_u = _where(esc[None], pe_env_m[None], pe_area_n[None])
        pb_hv_u = 0.0
        if hv_on:
            # HV: the offset has its OWN new vertex its_hv (or its own env
            # escape), with its unified-measure pdfs
            emit_hv, pe_hv, pb_hv_u = self._hv_emission(scene, N, hv,
                                                        its_hv, wo_hv_w,
                                                        ok_hv)
            off_emit = _where(_b3(use_hv), emit_hv, off_emit)
            off_pe_u = _where(use_hv, pe_hv, off_pe_u)
        # offset bsdf technique density in the unified measure
        pb_rc_u = pb_rc * conv_o_seg
        pb_o1_u = pb_o1 * conv_m_seg[None]
        pb_conn_u = _where(bs.is_delta, 0.0, pb_m_sa)[None] * \
            conv_m_seg[None]
        off_pb_u = _where(is2, pb_conn_u,
                          _where(is1, pb_o1_u,
                                 _where(use_rc, pb_rc_u,
                                        _where(use_env, pb_env, pb_hv_u))))

        # ---------------- next-state bookkeeping -------------------------
        o_conn2 = _where(is2 | is1, CONN_DONE,
                         _where(use_rc | use_env, CONN_RECENT, CONN_NONE))
        o_conn2 = _where(o_alive2, o_conn2.to(o_conn.dtype), o_conn)
        # a reconnected offset keeps its own incoming direction at the
        # base's next vertex; a half-vector one its own vertex
        o_wi2 = _where(_b3(use_rc & o_alive2), -dir_rc, -wo_w4)
        o_its2 = tree_map(lambda a: a[None].expand((4,) + a.shape), its_n)
        if hv_on:
            o_wi2 = _where(_b3(use_hv & o_alive2), -wo_hv_w, o_wi2)
            o_its2 = tree_map(
                lambda hv_a, b_a: _where(
                    use_hv.reshape(use_hv.shape + (1,) * (hv_a.dim() - 2)),
                    hv_a, b_a), its_hv, o_its2)
            # HV offsets die when their own ray escapes (its contribution
            # is recorded above)
            o_alive2 = o_alive2 & _where(use_hv, its_hv.valid, True)

        return (o_its2, o_wi2, o_tp2, o_r2, o_conn2, o_alive2,
                off_emit, off_pb_u, off_pe_u)

    def _hv_emission(self, scene, N, hv, its_hv, wo_hv_w, ok_hv):
        """Emission a half-vector offset sees at its own new vertex (or
        along its own escaped ray) [4,N,3], with its light-sampling and
        BSDF-sampling densities in the unified measure [4,N]."""
        cosf_hv = m.dot(its_hv.ns, -wo_hv_w)
        hit_em_hv = (its_hv.valid & (its_hv.emitter_id >= 0) &
                     (cosf_hv > 0))
        if self.aux_only:
            hit_em_hv = torch.zeros_like(hit_em_hv)
        rad_hv = scene.emitters.radiance[
            torch.clamp_min(its_hv.emitter_id, 0).long()]
        d4 = wo_hv_w.reshape(4 * N, 3)
        env_rad_hv = em_ops.eval_env(scene, self.env_kind,
                                     d4).reshape(4, N, 3)
        pe_env_hv = em_ops.pdf_env_direct(
            scene, self.n_area, self.env_kind, d4,
            n_delta=self.n_delta).reshape(4, N)
        esc_hv = ok_hv & ~its_hv.valid
        pe_area_hv = _where(
            its_hv.valid & (its_hv.emitter_id >= 0),
            1.0 / (torch.clamp_min(
                scene.emitters.total_area[
                    torch.clamp_min(its_hv.emitter_id, 0).long()], 1e-12)
                * max(self.n_lights, 1)), 0.0)
        emit_hv = (_where(_b3(hit_em_hv), rad_hv, 0.0) +
                   _where(_b3(esc_hv), env_rad_hv, 0.0))
        pe_hv = _where(esc_hv, pe_env_hv, pe_area_hv)
        conv_hv = _where(
            its_hv.valid,
            torch.abs(m.dot(its_hv.ng, wo_hv_w)) /
            torch.clamp_min(its_hv.t ** 2, 1e-12), 1.0)
        pb_hv_u = _where(hv["is_delta"], 0.0, hv["pdf"]) * conv_hv
        return emit_hv, pe_hv, pb_hv_u

    def _half_vector_shift(self, wi_m, par_m, bs, par_o, wi_o_loc):
        """Half-vector copy for the 4 lockstep offsets: the base
        quantities broadcast to the [4, N] offset batch, then the shared
        half_vector_copy (gpt.cpp halfVectorShift semantics)."""
        def b4(a):
            return a[None].expand((4,) + a.shape)
        return half_vector_copy(self._beval, self._bpdf, b4(wi_m),
                                b4(bs.wo), tree_map(b4, par_m),
                                b4(bs.is_delta), wi_o_loc, par_o)

    # ------------------------------------------------------------------
    def samples_per_batch(self, n_samples):
        """Samples per pass: as many whole frames as fit the lane target
        (GDMT_LANES, read at each call as the reference reads it; default
        LANES), rounded down to a divisor of n_samples (the reference's
        rule)."""
        target = int(os.environ.get("GDMT_LANES", str(LANES)))
        N = self.settings.width * self.settings.height
        spb = max(1, target // max(N, 1))
        while n_samples % spb:
            spb -= 1
        return spb

    def render_chunk(self, scene, seed, sample_start, n_samples):
        """Accumulate n_samples samples per pixel from sample index
        sample_start into un-normalized film buffers."""
        st = self.settings
        H, W = st.height, st.width
        N = W * H
        dev = self.device
        spb = self.samples_per_batch(n_samples)
        ids = torch.arange(N, dtype=torch.int64, device=dev).repeat(spb)
        zero = lambda: torch.zeros((H, W, 3), device=dev)  # noqa: E731
        bufs = dict(primal=zero(), dx=zero(), dy=zero(),
                    very_direct=zero(),
                    wsum=torch.zeros((H, W), device=dev))
        self.ray_tally = (torch.zeros((), dtype=torch.int64, device=dev)
                          if self.count_rays else None)
        try:
            for i in range(n_samples // spb):
                sidx = (sample_start + i * spb + torch.arange(
                    spb, dtype=torch.int64, device=dev).repeat_interleave(N))
                pos, primal, very, grad = self.trace_pass(
                    scene, seed, sidx, pixel_id=ids)
                # grid-aligned: dense filtered adds, no scatter
                jit = (pos % 1.0).reshape(spb, N, 2)
                fb, wb = film_ops.splat_grid(bufs["primal"], bufs["wsum"],
                                             jit, primal.reshape(spb, N, 3),
                                             self.filter_kind)
                vd, _ = film_ops.splat_grid(bufs["very_direct"],
                                            torch.zeros_like(wb), jit,
                                            very.reshape(spb, N, 3),
                                            self.filter_kind)
                # gradients: lattice adds at fixed integer offsets
                g4 = grad.reshape(4, spb, N, 3)
                dx = film_ops.add_grid_shifted(bufs["dx"], g4[0], 0, 0)
                dx = film_ops.add_grid_shifted(dx, -g4[1], -1, 0)
                dy = film_ops.add_grid_shifted(bufs["dy"], g4[2], 0, 0)
                dy = film_ops.add_grid_shifted(dy, -g4[3], 0, -1)
                bufs = dict(primal=fb, dx=dx, dy=dy, very_direct=vd,
                            wsum=wb)
            if self.ray_tally is not None:
                bufs["rays"] = self.ray_tally
        finally:
            self.ray_tally = None
        return bufs

    def finalize(self, state, spp):
        """Sample-normalize accumulated buffers; with count_rays, read the
        measured ray count into last_ray_count (one host read)."""
        if self.count_rays and "rays" in state:
            self.last_ray_count = int(state["rays"])
        return self._normalize(state, spp)

    @staticmethod
    def _normalize(state, spp):
        w = torch.clamp_min(state["wsum"], 1e-12)[..., None]
        return {
            "primal": state["primal"] / w,
            "very_direct": state["very_direct"] / w,
            # gradients are per-sample averages on the pixel lattice;
            # each pixel receives `spp` base samples per involved pair
            "dx": state["dx"] / spp,
            "dy": state["dy"] / spp,
        }

    def render(self, scene, seed=0, spp=None, chunk=64,
               checkpoint_path=None, resume=False, progress=None):
        """Render through render_accumulate (checkpointable).  Returns the
        sample-normalized buffers primal, dx, dy, very_direct as device
        tensors; with count_rays, last_ray_count holds the measured rays."""
        from ..parallel.checkpoint import render_accumulate
        spp = spp or self.settings.spp
        state, spp = render_accumulate(
            self, scene, seed, spp, chunk,
            checkpoint_path=checkpoint_path, resume=resume,
            progress=progress)
        return self.finalize(state, spp)

    def render_final(self, scene, seed, spp, alpha=0.2, mode="L1",
                     l2_iters=100, l1_outer=8, l1_inner=40):
        """Render + finalize + screened-Poisson reconstruction on the
        scene's device.  Returns (final image, buffers dict); with
        count_rays the buffers hold the measured ray count as "rays" (a
        0-d int64 tensor on the device)."""
        from . import poisson
        state = self.render_chunk(scene, seed, 0, spp)
        bufs = self._normalize(state, spp)
        if "rays" in state:
            bufs["rays"] = state["rays"]
        if mode.upper() == "L2":
            rec = poisson.solve_l2(bufs["primal"], bufs["dx"], bufs["dy"],
                                   alpha=alpha, iters=l2_iters)
        else:
            rec = poisson.solve_l1(bufs["primal"], bufs["dx"], bufs["dy"],
                                   alpha=alpha, outer_iters=l1_outer,
                                   inner_iters=l1_inner)
        return rec + bufs["very_direct"], bufs
