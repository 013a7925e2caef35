"""Gradient-Domain Bidirectional Path Tracing (G-BDPT).

Counterpart of gradientdomain_mitsuba_tpu/models/gbdpt.py (the fork's
src/integrators/gbdpt/gbdpt.cpp + gbdpt_proc.cpp, Manzi et al., EGSR
2015): per pixel sample, the base BDPT evaluation (models/bdpt.py) is
augmented with FOUR shifted evaluations whose EYE subpath is offset to
the neighboring pixel; the light subpath is shared.  The shift map with
its specular-prefix replay (the reconnection junction tested at every
vertex, the base bounce replayed by gpt.half_vector_copy where it
fails), the decomposed gradient MIS

    g_st = 1/(1 + r^2) * ( w_st(ybar) * c_off - w_st(xbar) * c_base ),
    r    = |J| * prod_i pdf_fwd_offset(z_i) / pdf_fwd_base(z_i),

the image-space shift of the light-tracing (t=1) paths and, in
all-diffuse scenes, the suffix factorization are the reference's, step
for step (see its module docstring).  The four offset views evaluate as
one 4N-lane batch.

Ported: area-lit scenes of every kind of bsdf.PORTED_KINDS (door.xml,
cbox-mats.xml, the cloth board of tools/cloth_board.py), with or
without specular vertices, every texture and the blend / coating
wrappers; the offset views read textures at the finest mip level (no
footprint), as the reference does, and replay woven cloth's yarn
azimuth at the offset camera vertex, along the half-vector replay and at
the t=1 shift's retraced vertex (the reference's junction fixups at
the base vertex z_{k+2} and the replayed base bounce read the cloth
without it: its diffuse term).  The environment / delta-light family
is estimated with its gradients by an embedded aux-only G-PT pass
(aux_via_gpt, as in the reference): its primal, very_direct and
gradients add to the strategies' buffers, and the eye walk skips its
own aux collection.  The eye images and
eye-gradient pairs are grid-aligned and go through the dense film
adds; the light image and its image-space
gradient pairs go through the deterministic scatter.  The final image
is models/poisson.reconstruct on the buffers `render` returns (L1 by
default), as the reference's CLI does.
"""
from __future__ import annotations

import torch

from ..core import math as m
from ..core.records import tree_map
from ..core.rng import DimAllocator as DA
from ..ops import bsdf as bsdf_ops
from ..ops import common, film as film_ops
from ..ops import sensor as sensor_ops
from .bdpt import (BDPTracer, SlotOverlay, SubPath, _b3, _dir_to_area,
                   _is_delta_kind, _remap0, one_pass, synth_bary_from_az)
from .gpt import OFFSETS, half_vector_copy


def _tile4(tree):
    """Repeat every leaf of a record 4 times along its first axis."""
    return tree_map(lambda a: a.repeat((4,) + (1,) * (a.dim() - 1)), tree)


class GBDPTracer(BDPTracer):
    """G-BDPT: BDPT base + 4 shifted eye-subpath evaluations."""

    def __init__(self, scene, settings):
        super().__init__(scene, settings)
        p = settings.integrator_props
        self.shift_threshold = float(p.get("shiftThreshold", 0.001))
        # static: all-diffuse scenes skip the prefix replay (the junction
        # always fires at the first vertex when it fires at all)
        self.any_specular = bsdf_ops.any_specular(scene.materials,
                                                  self.shift_threshold)
        # the light-tracing strategies (t=1, lightImage) are shifted in
        # image space for the gradients; lightImageGradients=false keeps
        # the light image primal-only (no t=1 retrace, no reconnection
        # visibility)
        self.light_image_grads = (self.light_image and
                                  bool(p.get("lightImageGradients", True)))
        # the environment / delta-light family WITH gradients: an
        # aux-only G-PT tracer tracing through this tracer's intersectors
        # (looked up at each call), so its rays and kernel launches count
        # with this tracer's, as the reference shares its ray tally
        self.aux_via_gpt = self.aux_nee
        if self.aux_via_gpt:
            from .gpt import GPTracer
            aux = GPTracer(scene, settings, aux_only=True)
            aux.closest = lambda *a: self.closest(*a)
            aux.occluded = lambda *a: self.occluded(*a)
            aux.kernels = self.kernels
            self._aux_tracer = aux

    def _classify_diffuse(self, scene, bsdf_id, valid):
        rough = bsdf_ops.roughness(scene.materials,
                                   torch.clamp_min(bsdf_id, 0))
        return valid & (rough > self.shift_threshold)

    # ------------------------------------------------------------------
    def _offset_primaries(self, scene, seed, sample_idx, pixel_id, W, H):
        """Trace ALL FOUR offset-pixel camera rays as one 4N batch."""
        N = pixel_id.shape[0]
        dev = self.device
        px = (pixel_id % W).to(torch.float32)
        py = (pixel_id // W).to(torch.float32)
        jitter = self._u2(seed, pixel_id, sample_idx, DA.PIXEL_JITTER)
        base = torch.stack([px, py], -1) + jitter
        offs = torch.tensor(OFFSETS, dtype=torch.float32, device=dev)
        pos = (base[None] + offs[:, None, :]).reshape(4 * N, 2)
        u_ap = self._u2(seed, pixel_id, sample_idx, DA.APERTURE).repeat(4, 1)
        o, d = sensor_ops.sample_ray(self.sensor, W, H, pos, u_ap)
        hit = self.closest(o, d, torch.zeros(4 * N, device=dev),
                           torch.full((4 * N,), 3e38, device=dev),
                           scene.geom)
        return common.fill_intersection(scene, o, d, hit), d

    def _build_offset_view(self, scene, eye: SubPath, its1, d_cam, N, eps):
        """Shifted eye-subpath view with specular-prefix replay.

        The piecewise shift map (one per neighbor): starting from the
        offset camera vertex z'_1, at each vertex index i the reconnection
        junction c(z_i) & c(z'_i) & c(z_{i+1}) is tested; when it holds the
        offset reconnects z'_i -> z_{i+1} (suffix shared with the base),
        otherwise the base bounce is replayed by HALF-VECTOR COPY
        (gpt.half_vector_copy, one N-lane closest-hit call a step) and the
        walk continues.  The junction slot varies per lane; the view
        stores, per slot, either the offset prefix vertex (with its TRUE
        sampling density) or the base vertex with junction fixups, so
        every strategy (s,t) reads a consistent path out of the same
        arrays.  Without specular vertices the junction can only fire at
        slot 0 and the walk is its first step.

        Returns dict(view, rcum, ok_recon, ok_end, ok_end_s0), indexed by
        the strategy's endpoint slot e = t-2:
          rcum[:, e]     r(s,t) = |J| prod pdf_off/pdf_base, slots 1..e
                         (slot 0's factor is exactly 1: the image-plane
                         shift through the camera is measure-preserving)
          ok_recon[:, e] junction fired validly at some slot <= e-1
          ok_end[:, e]   endpoint mode incl. c(z_e) & c(z'_e)
          ok_end_s0[:, e] endpoint mode without classifications (s=0:
                         the HV chain itself hits the emitter)
        """
        TE = self.TE
        dev = self.device
        cls = self._classify_diffuse
        c_walk = [cls(scene, eye.bsdf_id[:, k], eye.valid[:, k])
                  for k in range(TE)]
        n_steps = max(TE - 1, 1) if self.any_specular else 1

        def set_(arr, k, val, mask):
            mk = mask.reshape(mask.shape + (1,) * (val.dim() - 1))
            arr[:, k] = torch.where(mk, val, arr[:, k])

        # view arrays start as copies of the base walk; prefix slots are
        # overwritten
        v = {name: getattr(eye, name).clone() for name in
             ("p", "ng", "ns", "uv", "wi", "bsdf_id", "emitter_id", "beta",
              "pdf_fwd", "pdf_rev", "delta")}
        v["aux"] = None if eye.aux is None else eye.aux.clone()
        rfac = torch.ones((N, TE), device=dev)
        no = torch.zeros(N, dtype=torch.bool, device=dev)
        prefix_ok = [no] * TE
        jun_struct = [no] * TE
        jun_valid = [no] * TE
        slot_iota = torch.arange(TE, device=dev)

        # ---- slot 0: offset camera vertex z'_1, TRUE camera density ----
        ok0 = its1.valid & eye.valid[:, 0]
        prefix_ok[0] = ok0
        pf0_off = self._camera_pdf_area(scene, its1.p, its1.ng)
        v["p"][:, 0] = its1.p
        v["ng"][:, 0] = its1.ng
        v["ns"][:, 0] = its1.ns
        v["uv"][:, 0] = its1.uv
        v["wi"][:, 0] = -d_cam
        v["bsdf_id"][:, 0] = its1.bsdf_id
        v["emitter_id"][:, 0] = its1.emitter_id
        v["beta"][:, 0] = 1.0
        set_(v["pdf_fwd"], 0, pf0_off, ok0)
        v["delta"][:, 0] = _is_delta_kind(scene.materials, its1.bsdf_id)
        if v["aux"] is not None and its1.bary is not None:
            v["aux"][:, 0] = its1.bary[..., 4:6]

        # the replay head z'_{k+1} (with woven cloth, its yarn azimuth)
        # and its throughput
        cur = dict(p=its1.p, ng=its1.ng, ns=its1.ns, uv=its1.uv,
                   bsdf_id=its1.bsdf_id, wi=-d_cam)
        if self.has_cloth and its1.bary is not None:
            cur["az"] = its1.bary[..., 4:6]
        beta_cur = torch.ones((N, 3), device=dev)
        replaying = ok0

        for k in range(n_steps):
            kn = min(k + 1, TE - 1)   # slot of z_{k+2}
            kn2 = min(k + 2, TE - 1)  # slot of z_{k+3} (clamped)
            have_next = eye.valid[:, kn]
            co_k = cls(scene, cur["bsdf_id"], prefix_ok[k])
            jst = replaying & c_walk[k] & co_k & c_walk[kn] & have_next
            jun_struct[k] = jst

            # frames/params at the current offset vertex
            ssc, tsc = m.build_frame(cur["ns"])
            wi_c = m.to_local(cur["wi"], ssc, tsc, cur["ns"])
            par_c = common.material_params(
                scene, self.has_textures, cur["bsdf_id"], cur["uv"],
                bary=(synth_bary_from_az(cur["az"]) if "az" in cur
                      else None))

            # base bounce z_{k+1} -> z_{k+2}: geometry + solid-angle pdf
            dir_b = -eye.wi[:, kn]
            d2b = torch.clamp_min(
                m.squared_length(eye.p[:, kn] - eye.p[:, k]), 1e-12)
            cosb = torch.clamp_min(torch.abs(m.dot(dir_b, eye.ng[:, kn])),
                                   1e-9)
            pdf_base_sa = eye.pdf_fwd[:, kn] * d2b / cosb

            # ======== junction: reconnect z'_{k+1} -> z_{k+2} ==========
            to_j = eye.p[:, kn] - cur["p"]
            d2j = torch.clamp_min(m.squared_length(to_j), 1e-12)
            distj = torch.sqrt(d2j)
            dir_rc = to_j / _b3(distj)
            occ = self.occluded(
                common.offset_ray_origin(cur["p"], cur["ng"], dir_rc, eps),
                dir_rc, torch.zeros(N, device=dev),
                torch.where(jst, distj - 2 * eps, -1.0), scene.geom)
            wo_rc = m.to_local(dir_rc, ssc, tsc, cur["ns"])
            f_rc = self._beval(par_c, wi_c, wo_rc)
            pb_rc = self._bpdf(par_c, wi_c, wo_rc)
            jok = (jst & ~occ & (f_rc.amax(-1) > 0) & (pb_rc > 0) &
                   (pdf_base_sa > 0))
            jun_valid[k] = jok

            cosj = torch.abs(m.dot(dir_rc, eye.ng[:, kn]))
            conv_o = cosj / d2j
            jac_rc = conv_o / torch.clamp_min(cosb / d2b, 1e-30)
            beta_j = beta_cur * f_rc * _b3(
                jac_rc / torch.clamp_min(pdf_base_sa, 1e-30))
            rfac_j = pb_rc * jac_rc / torch.clamp_min(pdf_base_sa, 1e-30)
            pf_j = pb_rc * conv_o

            # "recently connected" fixups at slot k+2 (z_{k+2}'s incoming
            # changed to come from z'_{k+1})
            ns2 = eye.ns[:, kn]
            ss2, ts2 = m.build_frame(ns2)
            par2 = common.material_params(scene, self.has_textures,
                                          eye.bsdf_id[:, kn], eye.uv[:, kn])
            wi2_off = m.to_local(-dir_rc, ss2, ts2, ns2)
            wi2_base = m.to_local(eye.wi[:, kn], ss2, ts2, ns2)
            to3 = eye.p[:, kn2] - eye.p[:, kn]
            d3sq = torch.clamp_min(m.squared_length(to3), 1e-12)
            dir23 = to3 / _b3(torch.sqrt(d3sq))
            wo2 = m.to_local(dir23, ss2, ts2, ns2)
            f2_off = self._beval(par2, wi2_off, wo2)
            f2_base = self._beval(par2, wi2_base, wo2)
            pdf2_off_sa = self._bpdf(par2, wi2_off, wo2)
            pf_recent = _dir_to_area(pdf2_off_sa, dir23, d3sq,
                                     eye.ng[:, kn2])
            ratio_f2 = torch.where(
                _b3(f2_base.amax(-1) > 0),
                f2_off / torch.clamp_min(f2_base, 1e-20), 0.0)
            # re-sampling z'_{k+1} from z_{k+2} (view pdf_rev[k])
            pr_j_sa = self._bpdf(par2, wo2, wi2_off)
            pr_j = _dir_to_area(pr_j_sa, -dir_rc, d2j, cur["ng"])
            scale = torch.where(
                _b3(torch.abs(eye.beta[:, kn]).amax(-1) > 0),
                beta_j / torch.clamp_min(eye.beta[:, kn], 1e-30),
                0.0) * ratio_f2

            set_(v["wi"], kn, -dir_rc, jok)
            set_(v["beta"], kn, beta_j, jok)
            set_(v["pdf_fwd"], kn, pf_j, jok)
            set_(v["pdf_rev"], k, torch.where(jok, pr_j, 0.0), jok)
            set_(rfac, kn, rfac_j, jok)
            if k + 2 <= TE - 1:
                set_(v["pdf_fwd"], kn2, pf_recent, jok)
                set_(rfac, kn2, pf_recent / _remap0(eye.pdf_fwd[:, kn2]),
                     jok)
                # suffix throughput: beta'[j>=k+2] = beta_base[j] * scale
                suff = (slot_iota >= k + 2)[None, :, None]
                v["beta"] = torch.where(jok[:, None, None] & suff,
                                        eye.beta * scale[:, None, :],
                                        v["beta"])
            if k >= 1:
                # re-sampling z'_k from z'_{k+1} whose outgoing changed
                pr_prev_sa = self._bpdf(par_c, wo_rc, wi_c)
                set_(v["pdf_rev"], k - 1,
                     self._pdf_to_prev(v, k, cur, pr_prev_sa), jok)

            if not self.any_specular:
                break  # n_steps is 1: nothing to replay
            # ======== half-vector replay step ==========================
            hv_can = replaying & ~jst & have_next
            ssm, tsm = m.build_frame(eye.ns[:, k])
            wi_m = m.to_local(eye.wi[:, k], ssm, tsm, eye.ns[:, k])
            wo_m = m.to_local(dir_b, ssm, tsm, eye.ns[:, k])
            par_m = common.material_params(scene, self.has_textures,
                                           eye.bsdf_id[:, k], eye.uv[:, k])
            hv = half_vector_copy(self._beval, self._bpdf, wi_m, wo_m,
                                  par_m, eye.delta[:, k], wi_c, par_c)
            hv_ok = hv_can & hv["valid"]
            wo_w = m.to_world(hv["wo"], ssc, tsc, cur["ns"])
            o_new = common.offset_ray_origin(cur["p"], cur["ng"], wo_w, eps)
            hit = self.closest(o_new, wo_w, torch.zeros(N, device=dev),
                               torch.where(hv_ok, 3e38, -1.0), scene.geom)
            its_n = common.fill_intersection(scene, o_new, wo_w, hit)
            adv = hv_ok & its_n.valid

            pb_base = torch.where(eye.delta[:, k], 1.0,
                                  torch.clamp_min(pdf_base_sa, 1e-30))
            beta_hv = beta_cur * hv["f"] * _b3(hv["jac"] / pb_base)
            rfac_hv = hv["pdf"] * hv["jac"] / pb_base
            conv_n = torch.abs(m.dot(its_n.ng, wo_w)) / torch.clamp_min(
                its_n.t ** 2, 1e-12)
            pf_hv = torch.where(hv["is_delta"], 0.0, hv["pdf"]) * conv_n

            prefix_ok[kn] = adv
            set_(v["p"], kn, its_n.p, adv)
            set_(v["ng"], kn, its_n.ng, adv)
            set_(v["ns"], kn, its_n.ns, adv)
            set_(v["uv"], kn, its_n.uv, adv)
            set_(v["wi"], kn, -wo_w, adv)
            set_(v["bsdf_id"], kn, its_n.bsdf_id, adv)
            set_(v["emitter_id"], kn, its_n.emitter_id, adv)
            set_(v["beta"], kn, beta_hv, adv)
            set_(v["pdf_fwd"], kn, torch.where(adv, pf_hv, 0.0), adv)
            set_(v["delta"], kn,
                 _is_delta_kind(scene.materials, its_n.bsdf_id), adv)
            set_(rfac, kn, rfac_hv, adv)
            if k >= 1:
                # re-sampling z'_k from z'_{k+1} given the HV outgoing
                pr_sa = self._bpdf(par_c, hv["wo"], wi_c)
                set_(v["pdf_rev"], k - 1,
                     self._pdf_to_prev(v, k, cur, pr_sa), adv)

            # advance the replay head
            repl = [("p", its_n.p), ("ng", its_n.ng), ("ns", its_n.ns),
                    ("uv", its_n.uv), ("bsdf_id", its_n.bsdf_id),
                    ("wi", -wo_w)]
            if its_n.bary is not None:
                if v["aux"] is not None:
                    set_(v["aux"], kn, its_n.bary[..., 4:6], adv)
                if "az" in cur:
                    repl.append(("az", its_n.bary[..., 4:6]))
            for key, val in repl:
                mk = adv.reshape(adv.shape + (1,) * (val.dim() - 1))
                cur[key] = torch.where(mk, val, cur[key])
            beta_cur = torch.where(_b3(adv), beta_hv, beta_cur)
            replaying = adv

        # ---- per-endpoint masks ----------------------------------------
        recon_before = []   # junction fired validly at slot <= e-1
        struct_before = []  # junction fired structurally at slot <= e-1
        acc_v = acc_s = no
        for e in range(TE):
            recon_before.append(acc_v)
            struct_before.append(acc_s)
            acc_v = acc_v | jun_valid[e]
            acc_s = acc_s | jun_struct[e]
        ok_recon = torch.stack(recon_before, dim=1)
        prefix = torch.stack(prefix_ok, dim=1)
        ok_end_s0 = prefix & ~torch.stack(struct_before, dim=1)
        c_off_all = torch.stack(
            [cls(scene, v["bsdf_id"][:, e], prefix_ok[e])
             for e in range(TE)], dim=1)
        ok_end = ok_end_s0 & torch.stack(c_walk, dim=1) & c_off_all

        rfac[:, 0] = 1.0
        rcum = torch.cumprod(rfac, dim=1)

        # slot validity: the offset prefix where it exists, base slots
        # past a valid junction (slot k is post-junction iff the junction
        # fired at some slot <= k-1, which is exactly ok_recon[:, k])
        valid = prefix | (ok_recon & eye.valid)

        view = SubPath(valid=valid, **v)
        return dict(view=view, rcum=rcum, ok_recon=ok_recon,
                    ok_end=ok_end, ok_end_s0=ok_end_s0)

    @staticmethod
    def _pdf_to_prev(v, k, cur, pdf_sa):
        """Area density, at the view's slot k-1, of re-sampling z'_k from
        the replay head z'_{k+1} with solid-angle density pdf_sa."""
        to_prev = v["p"][:, k - 1] - cur["p"]
        d2p = torch.clamp_min(m.squared_length(to_prev), 1e-12)
        return _dir_to_area(pdf_sa, to_prev / _b3(torch.sqrt(d2p)), d2p,
                            v["ng"][:, k - 1])

    # ------------------------------------------------------------------
    def _t1_prev(self, scene, light4, y04, s):
        """(prev_p, prev_ng, prev_ok, c_prev) behind the t=1 endpoint:
        y_{s-2} for s>=3, the emitter point y_0 for s==2."""
        kl = s - 2
        if s >= 3:
            prev_ok = light4.valid[:, kl - 1]
            return (light4.p[:, kl - 1], light4.ng[:, kl - 1], prev_ok,
                    self._classify_diffuse(scene, light4.bsdf_id[:, kl - 1],
                                           prev_ok))
        # emitter surface: always connectable
        return y04.p, y04.ng, y04.ok, y04.ok

    def _t1_cam_rays(self, scene, film_base, N, W, H):
        """Camera retrace rays through the 4 neighbors of the base t=1
        splat position (batched across strategies by the caller)."""
        M = 4 * N
        offs = torch.tensor(OFFSETS, dtype=torch.float32, device=self.device)
        film_o = (film_base[None] + offs[:, None, :]).reshape(M, 2)
        return sensor_ops.sample_ray(
            self.sensor, W, H, film_o,
            torch.full((M, 2), 0.5, device=self.device))

    def _t1_occ_ray(self, scene, light4, y04, s, its1, eps):
        """Reconnection-visibility ray z'_1 -> prev for one t=1 strategy
        (origin, dir, maxt); concatenated across strategies into one
        occlusion call by the caller."""
        prev_p, prev_ng, _, _ = self._t1_prev(scene, light4, y04, s)
        to1 = its1.p - prev_p
        d2 = torch.clamp_min(m.squared_length(to1), 1e-12)
        dist = torch.sqrt(d2)
        dirp = to1 / _b3(dist)
        return (common.offset_ray_origin(prev_p, prev_ng, dirp, eps),
                dirp, dist - 2 * eps)

    def _t1_offset(self, scene, light4, y04, s, N, eps, W, H,
                   c_light_end, its1, occ):
        """Image-space shift of a light-tracing path (t=1, reference
        gbdpt_proc.cpp light-image handling): z'_1 (the closest hit of
        the camera ray retraced through the base splat position + offset)
        reconnects to y_{s-2}; the shifted t=1 contribution and its
        technique sum are evaluated on a light-subpath VIEW with slot s-2
        replaced (a SlotOverlay: nothing is copied).

        light4/y04 are the 4x-tiled subpaths ([4N] lanes); all four
        offset directions evaluate as ONE batch.  Returns (value*J
        [4,N,3], sri_off [4,N], r [4,N]).  The shift fails (r=0) unless
        y_{s-1}, z'_1 and y_{s-2} are all classified diffuse."""
        kl = s - 2
        M = 4 * N
        prev_p, prev_ng, prev_ok, c_prev = self._t1_prev(
            scene, light4, y04, s)

        pf_base = _remap0(light4.pdf_fwd[:, kl])
        jbase = self._camera_pdf_area(scene, light4.p[:, kl],
                                      light4.ng[:, kl])
        c_off = self._classify_diffuse(scene, its1.bsdf_id, its1.valid)

        to1 = its1.p - prev_p
        d2 = torch.clamp_min(m.squared_length(to1), 1e-12)
        dist = torch.sqrt(d2)
        dirp = to1 / _b3(dist)
        conv_rc = torch.abs(m.dot(dirp, its1.ng)) / d2

        ok = (its1.valid & prev_ok & light4.valid[:, kl] & c_light_end &
              c_off & c_prev & ~occ)

        # BSDF / emission factor at y_{s-2} toward z'_1 (adjoint side)
        if s >= 3:
            f_prev, pdf_prev_sa = self._eval_at(scene, light4, kl - 1,
                                                dirp)
            wi_w = light4.wi[:, kl - 1]
            ns_p, ng_p = light4.ns[:, kl - 1], light4.ng[:, kl - 1]
            corr = ((torch.abs(m.dot(dirp, ns_p)) *
                     torch.abs(m.dot(wi_w, ng_p))) /
                    torch.clamp_min(torch.abs(m.dot(dirp, ng_p)) *
                                    torch.abs(m.dot(wi_w, ns_p)), 1e-9))
            f_prev = f_prev * _b3(corr)
        else:
            cos0 = torch.clamp_min(m.dot(dirp, y04.ng), 0.0)
            f_prev = _b3(cos0).expand(M, 3)
            pdf_prev_sa = cos0 / torch.pi
        ok = ok & (f_prev.amax(-1) > 0) & (pdf_prev_sa > 0)

        # image-plane Jacobian: dA(z'_1)/dA(y_{s-1}) in image coords
        joff = self._camera_pdf_area(scene, its1.p, its1.ng)
        jimg = jbase / torch.clamp_min(joff, 1e-30)

        beta_prev = y04.beta if s == 2 else light4.beta[:, kl - 1]
        beta_off = beta_prev * f_prev * _b3(conv_rc / pf_base)
        pf_off = pdf_prev_sa * conv_rc

        # reverse-pdf fixups behind the junction
        y0_view = y04
        over = {
            ("p", kl): its1.p, ("ng", kl): its1.ng, ("ns", kl): its1.ns,
            ("uv", kl): its1.uv, ("wi", kl): -dirp,
            ("bsdf_id", kl): its1.bsdf_id, ("beta", kl): beta_off,
            ("pdf_fwd", kl): pf_off,
            ("delta", kl): _is_delta_kind(scene.materials, its1.bsdf_id),
            ("valid", kl): ok,
        }
        if s >= 4:
            over[("pdf_rev", kl - 2)] = self._pdf_toward_prev(
                scene, light4, kl - 1, dirp, light4.p[:, kl - 2],
                light4.ng[:, kl - 2])
        elif s == 3:
            y0_view = y04._replace(pdf_rev=self._pdf_toward_prev(
                scene, light4, kl - 1, dirp, y04.p, y04.ng))
        if light4.aux is not None and its1.bary is not None:
            over[("aux", kl)] = its1.bary[..., 4:6]
        view = SlotOverlay(light4, over)

        # the eye side of _mis_sum is empty for t=1: pass the light view.
        # occ=False: z'_1 IS the closest hit along the retraced camera
        # ray, so its camera visibility holds by construction
        _, val, sri = self._strategy_t1(
            scene, view, view, y0_view, s, M, eps, W, H,
            occ=torch.zeros(M, dtype=torch.bool, device=self.device))
        r = torch.where(ok, (pf_off / pf_base) * jimg, 0.0)
        val = torch.where(_b3(ok), val * _b3(jimg), 0.0)
        sri = torch.where(ok, sri, 0.0)
        return (val.reshape(4, N, 3), sri.reshape(4, N), r.reshape(4, N))

    # ------------------------------------------------------------------
    @one_pass
    def trace_pass(self, scene, seed, sample_idx, pixel_id=None):
        """One sample for a batch of pixels (default: the whole frame).
        Returns (film positions [N,2], primal [N,3], very_direct [N,3],
        eye gradients [4,N,3], light-image positions [M,2] and values
        [M,3], light-image gradient positions [M',2] and pairs [4,M',3])."""
        st = self.settings
        W, H = st.width, st.height
        dev = self.device
        if pixel_id is None:
            pixel_id = torch.arange(W * H, dtype=torch.int64, device=dev)
        N = pixel_id.shape[0]
        M = 4 * N
        eps = scene.ray_eps

        pos_film, eye, very = self._gen_eye_path(scene, seed, sample_idx,
                                                 pixel_id, W, H)
        y0, light = self._gen_light_path(scene, seed, sample_idx, pixel_id)

        # ---- all 4 offset views as ONE 4N-lane batch -------------------
        its4, d4 = self._offset_primaries(scene, seed, sample_idx,
                                          pixel_id, W, H)
        eye4 = _tile4(eye)
        V4 = self._build_offset_view(scene, eye4, its4, d4, M, eps)
        view4 = V4["view"]
        light4 = _tile4(light)
        y04 = _tile4(y0)
        TE = self.TE
        r4 = V4["rcum"].reshape(4, N, TE)
        ok_recon4 = V4["ok_recon"].reshape(4, N, TE)
        ok_end4 = V4["ok_end"].reshape(4, N, TE)
        ok_end_s04 = V4["ok_end_s0"].reshape(4, N, TE)

        primal = torch.zeros((N, 3), device=dev)
        grad = torch.zeros((4, N, 3), device=dev)
        if self.aux_via_gpt:
            # the environment / delta-light family with gradients: the
            # aux-only G-PT pass on the same counter-RNG pixel stream (its
            # depth-1 environment radiance is the family's very-direct
            # part); `very` is zeros since the eye walk skipped the family
            _, aux_primal, aux_very, aux_grad = self._aux_tracer.trace_pass(
                scene, seed, sample_idx, pixel_id=pixel_id)
            primal = primal + aux_primal
            very = very + aux_very
            grad = grad + aux_grad
        splat_pos, splat_val = [], []
        t1_pos, t1_grad = [], []

        def pair_grad(c_base, sri_base, c_off, sri_off, r, ok):
            """Decomposed gradient estimate for one (strategy, offset)
            pair.  Guards: invalid offset views can carry inf/NaN
            technique sums and r*r can overflow to inf (a 2-way weight of
            0 on this side — the neighbor's sample covers the pair)."""
            sri_off = torch.where(ok, sri_off, 0.0)
            r = torch.where(ok, r, 0.0)
            c_off = torch.where(_b3(ok), c_off, 0.0)
            a = 1.0 / (1.0 + r * r)
            a = torch.where(torch.isnan(a), 0.0, a)
            w_off = torch.where(ok, 1.0 / (1.0 + sri_off), 0.0)
            w_base = 1.0 / (1.0 + sri_base)
            return _b3(a) * (_b3(w_off) * c_off - _b3(w_base) * c_base)

        def classify_light_end(s):
            """Shift-map classification of the reconnection target when it
            is a light vertex (t=2 endpoint / t=1 second vertex)."""
            if s <= 1:
                return torch.ones(N, dtype=torch.bool, device=dev)
            return self._classify_diffuse(scene, light.bsdf_id[:, s - 2],
                                          light.valid[:, s - 2])

        # ---- t=1 strategies: all traversal work batched across s --------
        t1_list = self._t1_list()
        occ_t1 = self._batched_t1_occlusion(scene, light, t1_list, N, eps)
        t1_data = {}
        for s in t1_list:
            pos, val, sri = self._strategy_t1(scene, eye, light, y0, s, N,
                                              eps, W, H, occ=occ_t1[s])
            t1_data[s] = dict(pos=pos, val=val, sri=sri)
        if t1_list and self.light_image_grads:
            nb = len(t1_list)
            cam = [self._t1_cam_rays(scene, t1_data[s]["pos"], N, W, H)
                   for s in t1_list]
            o_c = torch.cat([c[0] for c in cam])
            d_c = torch.cat([c[1] for c in cam])
            hit = self.closest(o_c, d_c, torch.zeros(nb * M, device=dev),
                               torch.full((nb * M,), 3e38, device=dev),
                               scene.geom)
            its1_all = common.fill_intersection(scene, o_c, d_c, hit)
            sl = [tree_map(lambda a, i=i: a[i * M:(i + 1) * M], its1_all)
                  for i in range(nb)]
            orays = [self._t1_occ_ray(scene, light4, y04, s, sl[i], eps)
                     for i, s in enumerate(t1_list)]
            occ_all = self.occluded(
                torch.cat([r[0] for r in orays]),
                torch.cat([r[1] for r in orays]),
                torch.zeros(nb * M, device=dev),
                torch.cat([r[2] for r in orays]), scene.geom)
            for i, s in enumerate(t1_list):
                t1_data[s]["its1"] = sl[i]
                t1_data[s]["occ"] = occ_all[i * M:(i + 1) * M]

        for s in t1_list:
            pos = t1_data[s]["pos"]
            val = t1_data[s]["val"]
            sri_base = t1_data[s]["sri"]
            splat_pos.append(pos)
            splat_val.append(val * _b3(1.0 / (1.0 + sri_base)))
            if self.light_image_grads:
                v_off, sri_off, r = self._t1_offset(
                    scene, light4, y04, s, N, eps, W, H,
                    classify_light_end(s).repeat(4),
                    t1_data[s]["its1"], t1_data[s]["occ"])
                t1_pos.append(pos)
                t1_grad.append(pair_grad(val[None], sri_base[None], v_off,
                                         sri_off, r, r > 0))

        for s, t in self._strategies():
            e = t - 2
            c_base, sri_base, auxd = self._run_strategy(
                scene, eye, light, y0, s, t, N, eps, return_aux=True)
            w_base = 1.0 / (1.0 + sri_base)
            if s == 0 and t == 2:
                very = very + c_base * _b3(w_base)
                continue  # very direct: excluded from gradients
            primal = primal + c_base * _b3(w_base)

            # reconnected mode: the junction fired inside this strategy's
            # eye prefix.  Endpoint mode: the light connection IS the
            # reconnection, gated by the same classifications.
            if s == 0:
                ok = ok_recon4[:, :, e] | ok_end_s04[:, :, e]
            else:
                ok = ok_recon4[:, :, e] | (
                    ok_end4[:, :, e] & classify_light_end(s)[None])
            if e >= 2 and not self.any_specular:
                # SUFFIX FACTORIZATION (all-diffuse scenes): the junction
                # can only fire at slot 0, so every contributing offset
                # lane of an endpoint slot e >= 2 reads a pure shared
                # suffix — the offset contribution is c_base * (beta'/beta)
                # and only the technique sum over the view's pdfs is left
                # to evaluate, with the base strategy's own fixups
                bb = eye.beta[:, e]
                vb = view4.beta[:, e].reshape(4, N, 3)
                ratio = torch.where(
                    (bb.amax(-1) > 0)[None, :, None],
                    vb / torch.clamp_min(bb, 1e-30)[None], 0.0)
                c_off = c_base[None] * ratio
                sri_off = self._mis_sum(
                    view4, light4, y04, s, t,
                    *(auxd[k].repeat(4) for k in (
                        "pdf_rev_pt", "pdf_rev_pt_minus", "pdf_rev_qs",
                        "pdf_rev_qs_minus"))).reshape(4, N)
            else:
                # e == 1 in an all-diffuse scene: the only contributing
                # mode is reconnected at slot 0, whose endpoint is the BASE
                # z_2 — the base strategy's shadow ray is reused.  With a
                # specular prefix the view is evaluated in full.
                occ4 = (auxd["occ"].repeat(4)
                        if e == 1 and s >= 1 and not self.any_specular
                        else None)
                c_off, sri_off = self._run_strategy(
                    scene, view4, light4, y04, s, t, M, eps, occ=occ4)
                c_off = c_off.reshape(4, N, 3)
                sri_off = sri_off.reshape(4, N)
            grad = grad + pair_grad(c_base[None], sri_base[None], c_off,
                                    sri_off, r4[:, :, e], ok)

        def cat(parts, shape):
            if parts:
                return torch.cat(parts, dim=-2 if len(shape) == 3 else 0)
            return torch.zeros(shape, device=dev)

        return (pos_film, primal, very, grad,
                cat(splat_pos, (0, 2)), cat(splat_val, (0, 3)),
                cat(t1_pos, (0, 2)), cat(t1_grad, (4, 0, 3)))

    def _run_strategy(self, scene, eye, light, y0, s, t, N, eps,
                      return_aux=False, occ=None):
        if s == 0:
            return self._strategy_s0(scene, eye, light, y0, t, N,
                                     return_aux=return_aux)
        if s == 1:
            return self._strategy_s1(scene, eye, light, y0, t, N, eps,
                                     return_aux=return_aux, occ=occ)
        return self._strategy_connect(scene, eye, light, y0, s, t, N, eps,
                                      return_aux=return_aux, occ=occ)

    # ------------------------------------------------------------------
    def render_chunk(self, scene, seed, sample_start, n_samples):
        """Accumulate n_samples samples per pixel from sample index
        sample_start, one sample per pixel a pass, into un-normalized
        buffers (primal, dx, dy, very_direct, light_img, wsum, and rays
        with count_rays) on the device."""
        st = self.settings
        H, W = st.height, st.width
        dev = self.device
        offs = torch.tensor(OFFSETS, dtype=torch.float32, device=dev)

        def zero():
            return torch.zeros((H, W, 3), device=dev)

        b = dict(primal=zero(), dx=zero(), dy=zero(), very_direct=zero(),
                 light_img=zero(), wsum=torch.zeros((H, W), device=dev))
        self.ray_tally = (torch.zeros((), dtype=torch.int64, device=dev)
                          if self.count_rays else None)
        try:
            for i in range(n_samples):
                (pos, primal, very, grad, spos, sval, t1p,
                 t1g) = self.trace_pass(scene, seed, sample_start + i)
                # eye samples are grid-aligned: dense filtered adds, and
                # the eye-gradient pairs as lattice adds at fixed offsets
                jit = (pos % 1.0)[None]
                b["primal"], b["wsum"] = film_ops.splat_grid(
                    b["primal"], b["wsum"], jit, primal[None],
                    self.filter_kind)
                b["very_direct"], _ = film_ops.splat_grid(
                    b["very_direct"], torch.zeros_like(b["wsum"]), jit,
                    very[None], self.filter_kind)
                dx = film_ops.add_grid_shifted(b["dx"], grad[0][None], 0, 0)
                dx = film_ops.add_grid_shifted(dx, -grad[1][None], -1, 0)
                dy = film_ops.add_grid_shifted(b["dy"], grad[2][None], 0, 0)
                dy = film_ops.add_grid_shifted(dy, -grad[3][None], 0, -1)
                # light image and its gradient pairs: arbitrary pixels,
                # the deterministic scatter; the pairs use the same
                # forward/backward lattice convention
                b["light_img"] = film_ops.splat_unfiltered(
                    b["light_img"], spos, sval)
                b["dx"] = film_ops.splat_unfiltered(
                    dx, torch.cat([t1p, t1p + offs[1]]),
                    torch.cat([t1g[0], -t1g[1]]))
                b["dy"] = film_ops.splat_unfiltered(
                    dy, torch.cat([t1p, t1p + offs[3]]),
                    torch.cat([t1g[2], -t1g[3]]))
            if self.ray_tally is not None:
                b["rays"] = self.ray_tally
        finally:
            self.ray_tally = None
        return b

    def finalize(self, state, spp):
        """Sample-normalized buffers on the device.  The light image is
        merged into primal: its gradients are estimated (t=1 image-space
        shifts), so it takes part in the reconstruction; very_direct is
        re-added after it."""
        if self.count_rays and "rays" in state:
            self.last_ray_count = int(state["rays"])
        w = torch.clamp_min(state["wsum"], 1e-12)[..., None]
        return {
            "primal": state["primal"] / w + state["light_img"] / spp,
            "very_direct": state["very_direct"] / w,
            "dx": state["dx"] / spp,
            "dy": state["dy"] / spp,
        }

    def render(self, scene, seed=0, spp=None, chunk=32,
               checkpoint_path=None, resume=False, progress=None):
        """Returns the buffers dict (primal incl. the light image,
        very_direct, dx, dy); models/poisson.reconstruct makes the final
        image from it."""
        from ..parallel.checkpoint import render_accumulate
        spp = spp or self.settings.spp
        state, spp = render_accumulate(
            self, scene, seed, spp, chunk,
            checkpoint_path=checkpoint_path, resume=resume,
            progress=progress)
        return self.finalize(state, spp)
