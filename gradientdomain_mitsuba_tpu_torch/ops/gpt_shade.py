"""G-PT's shading wavefront as a few launches a pass.

No counterpart in the reference: its bounce and shift (models/gpt.py
GPTracer._bounce, _shift_offsets) are jnp code that XLA fuses.  The
port's eager bounce runs thousands of launches a pass, each over whole
[4, N] lane arrays; csrc/gpt_shade.cu does the same work for the scenes
ops/shade.fused_scene admits (diffuse rows, no textures, area lights
only, the independent sampler) when the tracer is neither aux_only nor
has a specular vertex, in one launch between each pair of traversal
calls.  In such a scene every offset is NOT CONNECTED at bounce 0 and
CONNECTED (or dead) from bounce 1 on, so a pass is:

  start    after the camera's closest hits (base N, offsets 4N): the five
           hit records, very_direct, the base's NEE and the offsets'
           NOT-CONNECTED NEE toward the same light point (one 5N shadow
           batch), the base's BSDF sample (the N next rays);
  connect  after that 5N any-hit call and the N closest-hit call: the NEE
           terms of primal and the gradients, the new base hit and its
           emission, the offsets' reconnection rays (4N, maxt = -1 where
           a lane cannot reconnect);
  shift    after the 4N any-hit call: the reconnection (Jacobian, f, pdf,
           visibility), the offsets' emission pair MIS, Russian roulette,
           the offset states, then bounce 1's shadow and next rays;
  bounce b after bounce b's N any-hit and N closest-hit calls (b >= 1):
           bounce b's NEE and emission (bounce 1 with its RECENT / DONE
           offsets, later bounces into the suffix's primal), Russian
           roulette, then bounce b+1's rays; the last one applies the
           suffix factorization grad += (rho - 1) / (1 + r^2) * rest.

A launch recomputes what it needs of its vertex (the hit record, the
NEE and BSDF samples, from the hit, the ray that reached it and the
counter RNG) instead of reading it back: the lane state between launches
is only what the eager bounce carries from one bounce to the next.

A CPU tensor runs the plain version (GPTShade.plain_*: state in, state
out, the ops/ functions and the expressions the eager bounce evaluates,
so it is the eager bounce's arithmetic); a CUDA tensor launches the
kernel.  The kernels are compiled with nvcc at first use (sm_90a,
-fmad=false, plain C interface, bound with ctypes) into the package's
git-ignored _build/ directory.
"""
from __future__ import annotations

import ctypes
import functools
import os
from typing import NamedTuple

import numpy as np
import torch

from .. import native
from ..core import math as m
from ..core.records import tree_map
from ..core.rng import DimAllocator as DA
from ..core.rng import uniform_2d, uniform_float
from . import bsdf as bsdf_ops
from . import common
from . import emitter as em_ops
from . import shade as shade_ops
from .shade import SHADE_COLUMNS, _check, _counter

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "gpt_shade.cu")

CONN_NONE, CONN_RECENT, CONN_DONE = 0, 1, 2
START, CONNECT, SHIFT, BOUNCE = 0, 1, 2, 3     # the kernel's stages


def _b3(x):
    return x[..., None]


class GPTState(NamedTuple):
    """The lanes between launches.  What the eager bounce carries from
    one bounce to the next (tp, alive, the offsets' o_*, primal, grad;
    `rest` the suffix's primal from bounce 2 on and `coeff` its
    factorization, set after bounce 1), very_direct, and the rays of the
    next traversal calls: shadow_* (5N at bounce 0, N after), recon_*
    (the offsets' 4N reconnection rays), ray_* (the base's next rays) and
    vtx_* (the rays that reached the current base vertex)."""
    very: torch.Tensor         # [N, 3]
    primal: torch.Tensor       # [N, 3]
    rest: torch.Tensor         # [N, 3]
    grad: torch.Tensor         # [4, N, 3]
    coeff: torch.Tensor        # [4, N, 3]
    tp: torch.Tensor           # [N, 3]
    alive: torch.Tensor        # [N] bool
    o_tp: torch.Tensor         # [4, N, 3]
    o_r: torch.Tensor          # [4, N]
    o_conn: torch.Tensor       # [4, N] int32
    o_alive: torch.Tensor      # [4, N] bool
    o_wi: torch.Tensor         # [4, N, 3]
    shadow_o: torch.Tensor     # [5N, 3]
    shadow_d: torch.Tensor     # [5N, 3]
    shadow_maxt: torch.Tensor  # [5N]
    recon_o: torch.Tensor      # [4N, 3]
    recon_d: torch.Tensor      # [4N, 3]
    recon_maxt: torch.Tensor   # [4N]
    ray_o: torch.Tensor        # [N, 3]
    ray_d: torch.Tensor        # [N, 3]
    ray_maxt: torch.Tensor     # [N]
    vtx_o: torch.Tensor        # [N, 3]
    vtx_d: torch.Tensor        # [N, 3]
    vtx_maxt: torch.Tensor     # [N]

    def shadow(self, n):
        """The next any-hit call's rays: the first n of the buffer."""
        return self.shadow_o[:n], self.shadow_d[:n], self.shadow_maxt[:n]


class Camera(NamedTuple):
    """A pass's camera rays and their closest hits: the base's [N] and
    the four offsets' [4N] (offset k's lanes k*N ... k*N + N-1)."""
    o: torch.Tensor
    d: torch.Tensor
    hit: tuple
    o_off: torch.Tensor
    d_off: torch.Tensor
    hit_off: tuple


_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float

_POINTERS = (
    "cam_o", "cam_d", "cam_t", "cam_u", "cam_v", "cam_prim", "cam_valid",
    "off_o", "off_d", "off_t", "off_u", "off_v", "off_prim", "off_valid",
    "vtx_t", "vtx_u", "vtx_v", "vtx_prim", "vtx_valid",
    "hit_t", "hit_u", "hit_v", "hit_prim", "hit_valid", "occl",
    "seed", "pixel", "sample", "tri_shade", "mat", "em_offset", "em_count",
    "em_cdf", "em_geo", "em_area", "em_radiance", "shape_emitter", "eps",
    "very", "primal", "rest", "grad", "coeff", "tp", "alive", "o_tp", "o_r",
    "o_conn", "o_alive", "o_wi", "shadow_o", "shadow_d", "shadow_maxt",
    "recon_o", "recon_d", "recon_maxt", "ray_o", "ray_d", "ray_maxt",
    "vtx_o", "vtx_d")
_INTS = ("n", "n_tri", "shade_cols", "n_mat", "mat_cols", "n_area",
         "n_shapes", "cdf_len", "cdf_iters", "stage", "bounce", "n_bounces",
         "max_depth", "rr_depth", "diffuse_vertex", "seed_stride",
         "pixel_stride", "sample_stride")


class _Args(ctypes.Structure):
    """csrc/gpt_shade.cu GptArgs, field for field."""
    _fields_ = ([(n, _P) for n in _POINTERS] + [(n, _I) for n in _INTS] +
                [(n, _U) for n in ("seed_value", "pixel_value",
                                   "sample_value")] +
                [(n, _F) for n in ("n_total", "pick_pdf", "n_lights")])


def load_library():
    """Build (first call only) and load the G-PT shading kernels'
    library (csrc/shade.cu, whose helpers it includes, is hashed with
    it), each float operation rounded on its own (-fmad=false) as the
    eager ops round it; raises if its argument struct and _Args disagree
    in size."""
    lib = native.load_cuda("gpt_shade", _SRC, {
        "gpt_shade": [_P, _P], "gpt_shade_args_size": []},
        flags=("-fmad=false",), deps=(shade_ops._SRC,))
    size = lib.gpt_shade_args_size()
    if size != ctypes.sizeof(_Args):
        raise RuntimeError(f"csrc/gpt_shade.cu GptArgs is {size} bytes, "
                           f"ops/gpt_shade.py _Args {ctypes.sizeof(_Args)}")
    return lib


class _Vertex(NamedTuple):
    """One bounce's base vertex as the eager bounce sees it before its
    traversal calls: the hit record, the shading frame, the NEE sample
    and the BSDF sample, with the quantities both strategies derive."""
    its: object
    alive: torch.Tensor
    ss: torch.Tensor
    ts: torch.Tensor
    par: object
    c: torch.Tensor
    ds: object
    conv: torch.Tensor
    pe_u: torch.Tensor
    wo_l: torch.Tensor
    f: torch.Tensor
    pb_u: torch.Tensor
    sh_o: torch.Tensor
    nee_live: torch.Tensor
    maxt_sh: torch.Tensor
    bs: object
    cont: torch.Tensor
    wo_w: torch.Tensor
    o_new: torch.Tensor
    tp: torch.Tensor
    tp_new: torch.Tensor


class GPTShade:
    """The bounces of GPTracer.trace_pass on the scenes it admits, with
    their launch count: start / connect / shift / bounce (see the module
    note).  `launches` counts kernel launches only: a CPU call runs the
    plain version."""

    def __init__(self, tracer, scene):
        st = tracer.settings
        self.kinds = tracer.kinds
        self.n_area = int(tracer.n_area)
        self.n_lights = max(int(tracer.n_lights), 1)
        self.max_depth = int(st.max_depth)
        self.rr_depth = int(st.rr_depth)
        self.n_bounces = int(tracer.n_bounces)
        self.shift_threshold = tracer.shift_threshold
        # gpt.cpp getVertexType: a diffuse row's roughness (1e9 in the
        # table) against shiftThreshold, as the eager classification
        # compares it (float32)
        rough = bsdf_ops.roughness(scene.materials, torch.zeros(
            1, dtype=torch.int32, device=scene.materials.kind.device))
        self.diffuse_vertex = bool((rough > self.shift_threshold).all())
        self.launches = 0

    # ------------------------------------------------------------------
    def start(self, scene, cam, rng):
        if cam.o.device.type == "cpu":
            return self.plain_start(scene, cam, rng)
        return self._launch(START, scene, 0, cam, rng, None, None, None,
                            None)

    def connect(self, scene, cam, rng, st, occl, hit):
        if cam.o.device.type == "cpu":
            return self.plain_connect(scene, cam, rng, st, occl, hit)
        return self._launch(CONNECT, scene, 0, cam, rng, st, None, occl,
                            hit)

    def shift(self, scene, cam, rng, st, hit, occl):
        if cam.o.device.type == "cpu":
            return self.plain_shift(scene, cam, rng, st, hit, occl)
        return self._launch(SHIFT, scene, 0, cam, rng, st, None, occl, hit)

    def bounce(self, scene, b, rng, st, hit_v, occl, hit):
        if st.tp.device.type == "cpu":
            return self.plain_bounce(scene, b, rng, st, hit_v, occl, hit)
        return self._launch(BOUNCE, scene, b, None, rng, st, hit_v, occl,
                            hit)

    # ---------------- the plain version: the eager bounce's ops ---------
    def _classify(self, scene, its):
        rough = bsdf_ops.roughness(scene.materials,
                                   torch.clamp_min(its.bsdf_id, 0))
        return its.valid & (rough > self.shift_threshold)

    def _vertex(self, scene, b, rng, its, d, tp, alive):
        """GPTracer._bounce up to its traversal calls, for the base."""
        seed, pixel_id, sample_idx = rng
        eps = scene.ray_eps
        depth = b + 1
        alive = alive & its.valid
        ss, ts = m.build_frame(its.ns)
        wi = m.to_local(-d, ss, ts, its.ns)
        par = common.material_params(scene, 0, its.bsdf_id, its.uv)
        c = self._classify(scene, its)
        ext_alive = alive
        if self.max_depth > 0:
            ext_alive = alive & (depth < self.max_depth)
        dim = functools.partial(DA.bounce_dim, b)
        u_sel = uniform_float(seed, pixel_id, sample_idx,
                              dim(DA.D_LIGHT_SELECT))
        u_pos = uniform_2d(seed, pixel_id, sample_idx, dim(DA.D_LIGHT_UV))
        ds = em_ops.sample_direct(scene, self.n_area, em_ops.ENV_NONE,
                                  its.p, u_sel, u_pos)
        conv = (torch.clamp_min(-m.dot(ds.d, ds.n), 0.0) /
                torch.clamp_min(ds.dist ** 2, 1e-12))
        pe_u = ds.pdf_area
        wo_l = m.to_local(ds.d, ss, ts, its.ns)
        f = bsdf_ops.eval(par, wi, wo_l, kinds=self.kinds)
        pb_u = bsdf_ops.pdf(par, wi, wo_l, kinds=self.kinds) * conv
        sh_o = common.offset_ray_origin(its.p, its.ng, ds.d, eps)
        nee_live = ext_alive & ds.valid & (pe_u > 0)
        maxt_sh = torch.where(
            nee_live, ds.dist - 2 * eps / torch.clamp_min(
                torch.abs(m.dot(ds.d, ds.n)), 1e-3), -1.0)
        u2 = uniform_2d(seed, pixel_id, sample_idx, dim(DA.D_BSDF_UV))
        uc = uniform_float(seed, pixel_id, sample_idx,
                           dim(DA.D_BSDF_COMPONENT))
        bs = bsdf_ops.sample(par, wi, u2, uc, kinds=self.kinds)
        cont = ext_alive & bs.valid
        wo_w = m.to_world(bs.wo, ss, ts, its.ns)
        o_new = common.offset_ray_origin(its.p, its.ng, wo_w, eps)
        tp_new = torch.where(_b3(cont), tp * bs.weight, 0.0)
        return _Vertex(its, alive, ss, ts, par, c, ds, conv, pe_u, wo_l, f,
                       pb_u, sh_o, nee_live, maxt_sh, bs, cont, wo_w, o_new,
                       tp, tp_new)

    def _camera(self, scene, cam, rng):
        """The camera's hit records and bounce 0's vertex: the base's
        and the offsets' (their own vertices, frames and materials, the
        NOT-CONNECTED state's), with the offsets' NEE toward the base's
        light point."""
        N = cam.o.shape[0]
        eps = scene.ray_eps
        its_m = common.fill_intersection(scene, cam.o, cam.d, cam.hit)
        its_o = tree_map(lambda a: a.reshape((4, N) + a.shape[1:]),
                         common.fill_intersection(scene, cam.o_off,
                                                  cam.d_off, cam.hit_off))
        d_o = cam.d_off.reshape(4, N, 3)
        tp = torch.ones((N, 3), device=cam.o.device)
        v = self._vertex(scene, 0, rng, its_m, cam.d, tp, its_m.valid)
        o_wi = -d_o
        o_alive = its_o.valid & its_m.valid[None] & v.alive[None]
        o_conn = torch.zeros((4, N), dtype=torch.int32, device=cam.o.device)
        ss_o, ts_o = m.build_frame(its_o.ns)
        wi_o_loc = m.to_local(o_wi, ss_o, ts_o, its_o.ns)
        par_o = common.material_params(scene, 0, its_o.bsdf_id, its_o.uv)
        c_off = self._classify(scene, its_o)
        ds = v.ds
        to_l = ds.p[None] - its_o.p
        dist_o = torch.sqrt(torch.clamp_min(m.squared_length(to_l), 1e-12))
        d_o_l = to_l / _b3(dist_o)
        conv_o0 = (torch.clamp_min(-m.dot(d_o_l, ds.n[None]), 0.0) /
                   torch.clamp_min(dist_o ** 2, 1e-12))
        wo_l_o0 = m.to_local(d_o_l, ss_o, ts_o, its_o.ns)
        f_o0 = bsdf_ops.eval(par_o, wi_o_loc, wo_l_o0, kinds=self.kinds)
        pb_o0_u = bsdf_ops.pdf(par_o, wi_o_loc, wo_l_o0,
                               kinds=self.kinds) * conv_o0
        sh_oo = common.offset_ray_origin(its_o.p, its_o.ng, d_o_l, eps)
        nee_live_o = (o_alive & (o_conn == CONN_NONE) & v.nee_live[None])
        maxt_o_sh = torch.where(
            nee_live_o, dist_o - 2 * eps / torch.clamp_min(
                torch.abs(m.dot(d_o_l, ds.n[None])), 1e-3), -1.0)
        return dict(
            v=v, its_o=its_o, o_wi=o_wi, o_alive=o_alive, o_conn=o_conn,
            wi_o_main=m.to_local(o_wi, v.ss[None], v.ts[None],
                                 its_m.ns[None]),
            ss_o=ss_o, ts_o=ts_o, wi_o_loc=wi_o_loc, par_o=par_o,
            c_off=c_off, conn0=(f_o0, pb_o0_u, conv_o0), sh_oo=sh_oo,
            d_o_l=d_o_l, maxt_o_sh=maxt_o_sh,
            o_tp=torch.ones((4, N, 3), device=cam.o.device),
            o_r=torch.ones((4, N), device=cam.o.device))

    def _nee(self, v, wi_o_main, o_alive, o_conn, o_tp, o_r, occ_m, conn0,
             occ_o0, primal, grad):
        """The NEE strategy's terms once its shadow rays have their
        answers: primal with the standard MIS, the offsets' pair MIS
        gradient (conn0: the NOT-CONNECTED offsets' f, pdf and measure
        conversion at bounce 0, else None)."""
        ds = v.ds
        primal, vis_m, contrib_m = self._nee_base(v, occ_m, primal)
        if conn0 is None:
            f_o0 = torch.zeros_like(o_tp)
            pb_o0_u = torch.zeros_like(o_r)
            conv_o0 = torch.zeros_like(o_r)
            occ_o0 = torch.ones_like(o_alive)
        else:
            f_o0, pb_o0_u, conv_o0 = conn0
        f_o1 = bsdf_ops.eval(v.par, wi_o_main, v.wo_l[None],
                             kinds=self.kinds)
        pb_o1_u = bsdf_ops.pdf(v.par, wi_o_main, v.wo_l[None],
                               kinds=self.kinds) * v.conv[None]
        is0 = o_conn == CONN_NONE
        is1 = o_conn == CONN_RECENT
        f_o = torch.where(_b3(is0), f_o0,
                          torch.where(_b3(is1), f_o1, v.f[None]))
        pb_o_u = torch.where(is0, pb_o0_u,
                             torch.where(is1, pb_o1_u, v.pb_u[None]))
        conv_o = torch.where(is0, conv_o0, v.conv[None])
        vis_o = torch.where(is0, ~occ_o0, ~occ_m[None])
        ok_o = o_alive & vis_o & vis_m[None]
        c_o_val = (o_tp * f_o * ds.radiance[None] *
                   _b3(conv_o / torch.clamp_min(v.pe_u, 1e-30)[None]))
        contrib_o = torch.where(_b3(ok_o), c_o_val, 0.0)
        r_eff = torch.where(ok_o, o_r, 0.0)
        pe2 = (v.pe_u * v.pe_u)[None]
        den = (pe2 + (v.pb_u * v.pb_u)[None] +
               r_eff * r_eff * (pe2 + pb_o_u * pb_o_u))
        w_pair = torch.where(vis_m[None] | ok_o,
                             pe2 / torch.clamp_min(den, 1e-30), 0.0)
        grad = grad + w_pair[..., None] * (contrib_o - contrib_m[None])
        return primal, grad

    def _emission(self, scene, v, its_n):
        """The base's emission at its new vertex (the BSDF strategy),
        with the densities the pair MIS reads."""
        bs = v.bs
        cos_n_m = torch.abs(m.dot(its_n.ng, v.wo_w))
        dist2_m = torch.clamp_min(its_n.t ** 2, 1e-12)
        conv_m_seg = torch.where(its_n.valid, cos_n_m / dist2_m, 1.0)
        pb_m_u = bs.pdf * conv_m_seg
        cosf_n = m.dot(its_n.ns, -v.wo_w)
        hit_em = its_n.valid & (its_n.emitter_id >= 0) & (cosf_n > 0)
        em = scene.emitters
        rad_n = em.radiance[torch.clamp_min(its_n.emitter_id, 0).long()]
        em_of_shape = scene.geom.shape_emitter[
            torch.clamp_min(its_n.shape_id, 0).long()]
        pe_area_n = torch.where(
            hit_em, 1.0 / (torch.clamp_min(
                em.total_area[torch.clamp_min(em_of_shape, 0).long()],
                1e-12) * self.n_lights), 0.0)
        esc = v.cont & ~its_n.valid
        env_rad = em_ops.eval_env(scene, em_ops.ENV_NONE, v.wo_w)
        pe_env = em_ops.pdf_env_direct(scene, self.n_area, em_ops.ENV_NONE,
                                       v.wo_w)
        emit_m = (torch.where(_b3(hit_em), rad_n, 0.0) +
                  torch.where(_b3(esc), env_rad, 0.0))
        pe_u_n = torch.where(esc, pe_env, pe_area_n)
        pb_for_mis = torch.where(esc, bs.pdf, pb_m_u)
        has_emit_m = v.cont & (hit_em | esc)
        contrib_m_b = torch.where(_b3(has_emit_m), v.tp_new * emit_m, 0.0)
        w_std_b = em_ops.mis_weight(pb_for_mis, pe_u_n)
        return dict(conv_m_seg=conv_m_seg, esc=esc, pe_u_n=pe_u_n,
                    pb_for_mis=pb_for_mis, has_emit_m=has_emit_m,
                    contrib_m_b=contrib_m_b, w_std_b=w_std_b)

    def _recon(self, scene, cam0, v, its_n, e):
        """The NOT-CONNECTED offsets' reconnection to the base's new
        vertex: geometry, the offsets' BSDF toward it, and the 4N
        visibility rays."""
        eps = scene.ray_eps
        its_o, o_alive = cam0["its_o"], cam0["o_alive"]
        ss_o, ts_o, par_o = cam0["ss_o"], cam0["ts_o"], cam0["par_o"]
        wi_o_loc = cam0["wi_o_loc"]
        esc = e["esc"]
        c_next = self._classify(scene, its_n)
        recon_sel = v.c[None] & cam0["c_off"] & (c_next[None] | esc[None])
        wo_w4 = v.wo_w[None].expand(cam0["o_wi"].shape)
        to_n = its_n.p[None] - its_o.p
        dist_o2 = torch.clamp_min(m.squared_length(to_n), 1e-12)
        dist_o = torch.sqrt(dist_o2)
        dir_rc = to_n / _b3(dist_o)
        cos_n_o = torch.abs(m.dot(its_n.ng[None], dir_rc))
        conv_o_seg = cos_n_o / dist_o2
        jac_rc = conv_o_seg / torch.clamp_min(e["conv_m_seg"][None], 1e-30)
        wo_rc = m.to_local(dir_rc, ss_o, ts_o, its_o.ns)
        f_rc = bsdf_ops.eval(par_o, wi_o_loc, wo_rc, kinds=self.kinds)
        pb_rc = bsdf_ops.pdf(par_o, wi_o_loc, wo_rc, kinds=self.kinds)
        wo_env = m.to_local(wo_w4, ss_o, ts_o, its_o.ns)
        f_env = bsdf_ops.eval(par_o, wi_o_loc, wo_env, kinds=self.kinds)
        pb_env = bsdf_ops.pdf(par_o, wi_o_loc, wo_env, kinds=self.kinds)
        dir_sh = torch.where(_b3(esc[None]), wo_w4, dir_rc)
        sh_all = common.offset_ray_origin(its_o.p, its_o.ng, dir_sh, eps)
        is0 = cam0["o_conn"] == CONN_NONE
        live_sh = (o_alive & is0 & recon_sel &
                   torch.where(esc[None], torch.zeros_like(is0),
                               its_n.valid[None]))
        maxt_sh = torch.where(
            live_sh, torch.where(
                esc[None], 1e7,
                dist_o - 2 * eps / torch.clamp_min(cos_n_o, 1e-3)), -1.0)
        return dict(recon_sel=recon_sel, dir_rc=dir_rc, conv_o_seg=conv_o_seg,
                    jac_rc=jac_rc, f_rc=f_rc, pb_rc=pb_rc, f_env=f_env,
                    pb_env=pb_env, sh_all=sh_all, dir_sh=dir_sh,
                    live_sh=live_sh, maxt_sh=maxt_sh)

    def _shift(self, scene, v, wi_o_main, its_n, e, o_tp, o_r, o_conn,
               o_alive, rc=None, occ_sh=None, c_off=None):
        """GPTracer._shift_offsets in an all-diffuse scene (rc: bounce
        0's reconnection, None past it), then the pair MIS of the
        emission at the new vertex.  Returns the offsets' new state and
        the gradient term."""
        bs = v.bs
        esc = e["esc"]
        conv_m_seg = e["conv_m_seg"]
        is0 = o_conn == CONN_NONE
        is1 = o_conn == CONN_RECENT
        is2 = o_conn == CONN_DONE
        c_next = self._classify(scene, its_n)
        f_w_conn = bs.weight[None]
        pb_conn = bs.pdf[None]
        f_o1 = bsdf_ops.eval(v.par, wi_o_main, bs.wo[None], kinds=self.kinds)
        pb_o1 = bsdf_ops.pdf(v.par, wi_o_main, bs.wo[None], kinds=self.kinds)
        ok1 = torch.abs(f_o1).amax(-1) >= 0
        if c_off is None:
            # past bounce 0 the offsets' vertex is the base's
            c_off = v.c[None]
        recon_sel = v.c[None] & c_off & (c_next[None] | esc[None])
        wo_w4 = v.wo_w[None].expand(o_tp.shape)
        if rc is not None:
            dir_rc, conv_o_seg, jac_rc = rc["dir_rc"], rc["conv_o_seg"], \
                rc["jac_rc"]
            f_rc, pb_rc, f_env, pb_env = rc["f_rc"], rc["pb_rc"], \
                rc["f_env"], rc["pb_env"]
            ok_rc = (recon_sel & its_n.valid[None] & ~occ_sh &
                     (f_rc.amax(-1) > 0))
            ok_env = (recon_sel & esc[None] & ~occ_sh & rc["live_sh"] &
                      (f_env.amax(-1) > 0))
        else:
            dir_rc = wo_w4
            conv_o_seg = conv_m_seg[None].expand(o_r.shape)
            jac_rc = torch.ones_like(o_r)
            f_rc = torch.zeros_like(o_tp)
            pb_rc = torch.zeros_like(o_r)
            ok_rc = torch.zeros_like(o_alive)
            f_env = torch.zeros_like(o_tp)
            pb_env = torch.zeros_like(o_r)
            ok_env = torch.zeros_like(o_alive)
        ok_hv = torch.zeros_like(o_alive)
        use_rc = is0 & recon_sel & ~esc[None]
        use_env = is0 & recon_sel & esc[None]
        pb_base = bs.pdf[None]
        fac0 = torch.where(
            _b3(use_rc), f_rc * _b3(jac_rc),
            torch.where(_b3(use_env), f_env, 0.0)) / _b3(
            torch.clamp_min(pb_base, 1e-30))
        ok0 = torch.where(use_rc, ok_rc, torch.where(use_env, ok_env, ok_hv))
        r_fac0 = torch.where(
            use_rc, pb_rc * jac_rc,
            torch.where(use_env, pb_env, 0.0)) / torch.clamp_min(pb_base,
                                                                 1e-30)
        fac = torch.where(
            _b3(is2), f_w_conn,
            torch.where(_b3(is1),
                        f_o1 / _b3(torch.clamp_min(pb_conn, 1e-30)), fac0))
        r_fac = torch.where(
            is2, 1.0,
            torch.where(is1, pb_o1 / torch.clamp_min(pb_conn, 1e-30), r_fac0))
        ok = torch.where(is2, v.cont[None],
                         torch.where(is1, ok1 & v.cont[None], ok0))
        o_alive2 = o_alive & ok
        o_tp2 = torch.where(_b3(o_alive2), o_tp * fac, 0.0)
        o_r2 = torch.where(o_alive2, o_r * r_fac, 0.0)

        # the offsets' emission at the base's new vertex
        dir_in = torch.where(_b3(use_rc), dir_rc, wo_w4)
        cosf_o = m.dot(its_n.ns[None], -dir_in)
        hit_em_o = (its_n.valid[None] & (its_n.emitter_id[None] >= 0) &
                    (cosf_o > 0))
        em = scene.emitters
        rad_np = em.radiance[torch.clamp_min(its_n.emitter_id, 0).long()]
        env_rad_m = em_ops.eval_env(scene, em_ops.ENV_NONE, v.wo_w)
        pe_env_m = em_ops.pdf_env_direct(scene, self.n_area,
                                         em_ops.ENV_NONE, v.wo_w)
        pe_area_n = torch.where(
            its_n.valid & (its_n.emitter_id >= 0),
            1.0 / (torch.clamp_min(
                em.total_area[torch.clamp_min(its_n.emitter_id, 0).long()],
                1e-12) * self.n_lights), 0.0)
        off_emit = (torch.where(_b3(hit_em_o), rad_np[None], 0.0) +
                    torch.where(_b3(esc[None]), env_rad_m[None], 0.0))
        off_pe_u = torch.where(esc[None], pe_env_m[None], pe_area_n[None])
        pb_rc_u = pb_rc * conv_o_seg
        pb_o1_u = pb_o1 * conv_m_seg[None]
        pb_conn_u = bs.pdf[None] * conv_m_seg[None]
        off_pb_u = torch.where(
            is2, pb_conn_u,
            torch.where(is1, pb_o1_u,
                        torch.where(use_rc, pb_rc_u,
                                    torch.where(use_env, pb_env, 0.0))))
        o_conn2 = torch.where(is2 | is1, CONN_DONE,
                              torch.where(use_rc | use_env, CONN_RECENT,
                                          CONN_NONE))
        o_conn2 = torch.where(o_alive2, o_conn2.to(o_conn.dtype), o_conn)
        o_wi2 = torch.where(_b3(use_rc & o_alive2), -dir_rc, -wo_w4)

        # the pair MIS of the emission at the new vertex
        pb_for_mis, pe_u_n = e["pb_for_mis"], e["pe_u_n"]
        has_pair = e["has_emit_m"] | (o_alive2 &
                                      (m.squared_length(off_emit) > 0))
        r_eff_b = torch.where(o_alive2, o_r2, 0.0)
        num_b = (pb_for_mis * pb_for_mis)[None].expand(off_pb_u.shape)
        den_b = ((pb_for_mis * pb_for_mis + pe_u_n * pe_u_n)[None] +
                 r_eff_b * r_eff_b * (off_pb_u * off_pb_u +
                                      off_pe_u * off_pe_u))
        w_pair_b = torch.where(has_pair,
                               num_b / torch.clamp_min(den_b, 1e-30), 0.0)
        contrib_o_b = torch.where(_b3(o_alive2), o_tp2 * off_emit, 0.0)
        g = w_pair_b[..., None] * (contrib_o_b - e["contrib_m_b"][None])
        return o_tp2, o_r2, o_conn2, o_alive2, o_wi2, g

    def _roulette(self, rng, b, v, its_n):
        """Russian roulette after bounce b (its shared decision) from
        gpt.py's depth: (throughput, the 1/q factor, alive after)."""
        seed, pixel_id, sample_idx = rng
        depth = b + 1
        u_rr = uniform_float(seed, pixel_id, sample_idx,
                             DA.bounce_dim(b, DA.D_RR))
        eta_new = torch.ones_like(u_rr)
        q = torch.clamp_max(v.tp_new.amax(-1) * eta_new * eta_new, 0.95)
        if (depth + 1) >= self.rr_depth:
            survive = u_rr < q
            inv_q = 1.0 / torch.clamp_min(q, 1e-9)
        else:
            survive = torch.ones_like(v.cont)
            inv_q = torch.ones_like(q)
        tp = v.tp_new * _b3(inv_q)
        alive = v.cont & its_n.valid & survive & (tp.amax(-1) > 0)
        return tp, inv_q, alive

    def _next_rays(self, scene, b, rng, its, d, tp, alive):
        """Bounce b's shadow and next rays from its vertex."""
        v = self._vertex(scene, b, rng, its, d, tp, alive)
        return dict(shadow_o=v.sh_o, shadow_d=v.ds.d, shadow_maxt=v.maxt_sh,
                    ray_o=v.o_new, ray_d=v.wo_w,
                    ray_maxt=torch.where(v.cont, 3e38, -1.0))

    def plain_start(self, scene, cam, rng):
        N = cam.o.shape[0]
        dev = cam.o.device
        c0 = self._camera(scene, cam, rng)
        v = c0["v"]
        its_m = v.its
        cosf = m.dot(its_m.ns, -cam.d)
        is_em = its_m.valid & (its_m.emitter_id >= 0) & (cosf > 0)
        rad = scene.emitters.radiance[
            torch.clamp_min(its_m.emitter_id, 0).long()]
        very = torch.zeros((N, 3), device=dev) + torch.where(
            _b3(is_em), rad, 0.0)
        z3, z = torch.zeros((N, 3), device=dev), torch.zeros(N, device=dev)
        return GPTState(
            very=very, primal=z3, rest=z3,
            grad=torch.zeros((4, N, 3), device=dev),
            coeff=torch.zeros((4, N, 3), device=dev), tp=v.tp,
            alive=its_m.valid, o_tp=c0["o_tp"], o_r=c0["o_r"],
            o_conn=c0["o_conn"], o_alive=c0["o_alive"], o_wi=c0["o_wi"],
            shadow_o=torch.cat([v.sh_o[None], c0["sh_oo"]]).reshape(
                5 * N, 3),
            shadow_d=torch.cat([v.ds.d[None], c0["d_o_l"]]).reshape(5 * N, 3),
            shadow_maxt=torch.cat([v.maxt_sh[None],
                                   c0["maxt_o_sh"]]).reshape(5 * N),
            recon_o=torch.zeros((4 * N, 3), device=dev),
            recon_d=torch.zeros((4 * N, 3), device=dev),
            recon_maxt=torch.zeros(4 * N, device=dev),
            ray_o=v.o_new, ray_d=v.wo_w,
            ray_maxt=torch.where(v.cont, 3e38, -1.0),
            vtx_o=z3, vtx_d=z3, vtx_maxt=z)

    def plain_connect(self, scene, cam, rng, st, occl, hit):
        N = cam.o.shape[0]
        c0 = self._camera(scene, cam, rng)
        v = c0["v"]
        occ5 = occl.reshape(5, N)
        primal, grad = self._nee(
            v, c0["wi_o_main"], c0["o_alive"], c0["o_conn"], c0["o_tp"],
            c0["o_r"], occ5[0], c0["conn0"], occ5[1:],
            torch.zeros_like(st.primal), torch.zeros_like(st.grad))
        its_n = common.fill_intersection(scene, v.o_new, v.wo_w, hit)
        e = self._emission(scene, v, its_n)
        primal = primal + e["contrib_m_b"] * _b3(e["w_std_b"])
        rc = self._recon(scene, c0, v, its_n, e)
        return st._replace(
            primal=primal, grad=grad,
            recon_o=rc["sh_all"].reshape(4 * N, 3),
            recon_d=rc["dir_sh"].reshape(4 * N, 3),
            recon_maxt=rc["maxt_sh"].reshape(4 * N))

    def plain_shift(self, scene, cam, rng, st, hit, occl):
        N = cam.o.shape[0]
        c0 = self._camera(scene, cam, rng)
        v = c0["v"]
        its_n = common.fill_intersection(scene, v.o_new, v.wo_w, hit)
        e = self._emission(scene, v, its_n)
        rc = self._recon(scene, c0, v, its_n, e)
        o_tp, o_r, o_conn, o_alive, o_wi, g = self._shift(
            scene, v, c0["wi_o_main"], its_n, e, c0["o_tp"], c0["o_r"],
            c0["o_conn"], c0["o_alive"], rc=rc, occ_sh=occl.reshape(4, N),
            c_off=c0["c_off"])
        grad = st.grad + g
        tp, inv_q, alive = self._roulette(rng, 0, v, its_n)
        st = st._replace(
            grad=grad, tp=tp, alive=alive, o_tp=o_tp * inv_q[None, :, None],
            o_r=o_r, o_conn=o_conn, o_alive=o_alive & alive[None],
            o_wi=o_wi)
        return self._advance(scene, 0, rng, st, its_n, v.wo_w)

    def plain_bounce(self, scene, b, rng, st, hit_v, occl, hit):
        its = common.fill_intersection(scene, st.vtx_o, st.vtx_d, hit_v)
        v = self._vertex(scene, b, rng, its, st.vtx_d, st.tp, st.alive)
        N = st.tp.shape[0]
        occ_m = occl[:N]
        offsets = b == 1
        its_n = common.fill_intersection(scene, v.o_new, v.wo_w, hit)
        e = self._emission(scene, v, its_n)
        if offsets:
            o_alive = st.o_alive & v.alive[None]
            wi_o_main = m.to_local(st.o_wi, v.ss[None], v.ts[None],
                                   its.ns[None])
            primal, grad = self._nee(v, wi_o_main, o_alive, st.o_conn,
                                     st.o_tp, st.o_r, occ_m, None, None,
                                     st.primal, st.grad)
            primal = primal + e["contrib_m_b"] * _b3(e["w_std_b"])
            o_tp, o_r, o_conn, o_alive, o_wi, g = self._shift(
                scene, v, wi_o_main, its_n, e, st.o_tp, st.o_r, st.o_conn,
                o_alive)
            grad = grad + g
            tp, inv_q, alive = self._roulette(rng, b, v, its_n)
            st = st._replace(
                primal=primal, grad=grad, tp=tp, alive=alive,
                o_tp=o_tp * inv_q[None, :, None], o_r=o_r, o_conn=o_conn,
                o_alive=o_alive & alive[None], o_wi=o_wi)
            if self.n_bounces > 2:
                # the suffix factorization (gpt.py trace_pass)
                tp_safe = torch.clamp_min(st.tp, 1e-30)
                rho = torch.where(_b3(st.o_alive), st.o_tp / tp_safe[None],
                                  0.0)
                r_c = torch.where(st.o_alive, st.o_r, 0.0)
                coeff = torch.where(_b3(st.o_alive | st.alive[None]),
                                    (rho - 1.0) / _b3(1.0 + r_c * r_c), 0.0)
                st = st._replace(coeff=coeff,
                                 rest=torch.zeros_like(st.primal))
        else:
            rest = self._nee_base(v, occ_m, st.rest)[0]
            rest = rest + e["contrib_m_b"] * _b3(e["w_std_b"])
            tp, _, alive = self._roulette(rng, b, v, its_n)
            st = st._replace(rest=rest, tp=tp, alive=alive)
            if b == self.n_bounces - 1:
                st = st._replace(primal=st.primal + st.rest,
                                 grad=st.grad + st.coeff * st.rest[None])
        return self._advance(scene, b, rng, st, its_n, v.wo_w)

    def _nee_base(self, v, occ_m, primal):
        """The base's NEE term once its shadow ray has its answer:
        (primal, the light's visibility, the unweighted contribution)."""
        vis_m = v.nee_live & ~occ_m
        c_m_val = (v.tp * v.f * v.ds.radiance *
                   _b3(v.conv / torch.clamp_min(v.pe_u, 1e-30)))
        contrib_m = torch.where(_b3(vis_m), c_m_val, 0.0)
        w_std = em_ops.mis_weight(v.pe_u, v.pb_u)
        return primal + contrib_m * _b3(w_std), vis_m, contrib_m

    def _advance(self, scene, b, rng, st, its_n, d):
        """After bounce b: bounce b+1's rays from the new vertex, the
        current rays becoming the vertex's (none after the last)."""
        if b + 1 >= self.n_bounces:
            return st
        r = self._next_rays(scene, b + 1, rng, its_n, d, st.tp, st.alive)
        return st._replace(vtx_o=st.ray_o, vtx_d=st.ray_d,
                           vtx_maxt=st.ray_maxt, **r)

    # ---------------- the kernel ----------------------------------------
    def _launch(self, stage, scene, b, cam, rng, st, hit_v, occl, hit):
        """One kernel launch on CUDA tensors; validates every pointer it
        passes.  Returns the lane state (the kernel's buffers, updated in
        place; after a stage that writes the next rays, the ray and vertex
        buffers trade places)."""
        f32, i32, u8 = torch.float32, torch.int32, torch.bool
        dev = (cam.o if st is None else st.tp).device
        N = (cam.o if st is None else st.tp).shape[0]
        if N >= 2 ** 29:
            raise ValueError(f"{N} lanes exceed the kernel's int32 index "
                             f"over the 5N shadow buffer")
        if st is None:
            def empty(*shape, dtype=f32):
                return torch.empty(shape, dtype=dtype, device=dev)
            st = GPTState(
                very=empty(N, 3), primal=empty(N, 3), rest=empty(N, 3),
                grad=empty(4, N, 3), coeff=empty(4, N, 3), tp=empty(N, 3),
                alive=empty(N, dtype=u8), o_tp=empty(4, N, 3),
                o_r=empty(4, N), o_conn=empty(4, N, dtype=i32),
                o_alive=empty(4, N, dtype=u8), o_wi=empty(4, N, 3),
                shadow_o=empty(5 * N, 3), shadow_d=empty(5 * N, 3),
                shadow_maxt=empty(5 * N), recon_o=empty(4 * N, 3),
                recon_d=empty(4 * N, 3), recon_maxt=empty(4 * N),
                ray_o=empty(N, 3), ray_d=empty(N, 3), ray_maxt=empty(N),
                vtx_o=empty(N, 3), vtx_d=empty(N, 3), vtx_maxt=empty(N))
        g, em, mat = scene.geom, scene.emitters, scene.materials.packed
        T, E, C = g.tri_shade.shape[0], em.total_area.shape[0], \
            em.tri_cdf.shape[0]
        S = g.shape_emitter.shape[0]
        if g.tri_shade.shape[1] != SHADE_COLUMNS:
            raise ValueError(f"tri_shade has {g.tri_shade.shape[1]} columns, "
                             f"the kernel reads {SHADE_COLUMNS}")
        if not 1 <= self.n_area <= E:
            raise ValueError(f"{self.n_area} area lights of {E} emitters")
        checks = [
            ("tri_shade", g.tri_shade, (T, SHADE_COLUMNS), f32),
            ("materials", mat, tuple(mat.shape), f32),
            ("tri_offset", em.tri_offset, (E,), i32),
            ("tri_count", em.tri_count, (E,), i32),
            ("tri_cdf", em.tri_cdf, (C,), f32),
            ("tri_geo", em.tri_geo, (C, 12), f32),
            ("total_area", em.total_area, (E,), f32),
            ("radiance", em.radiance, (E, 3), f32),
            ("shape_emitter", g.shape_emitter, (S,), i32),
            ("ray_eps", scene.ray_eps, (), f32)]
        checks += [(f"state.{k}", x, x.shape, x.dtype)
                   for k, x in st._asdict().items()]
        hits = {"cam": None, "off": None, "vtx": hit_v, "hit": hit}
        if cam is not None:
            hits.update(cam=cam.hit, off=cam.hit_off)
            checks += [("cam.o", cam.o, (N, 3), f32),
                       ("cam.d", cam.d, (N, 3), f32),
                       ("cam.o_off", cam.o_off, (4 * N, 3), f32),
                       ("cam.d_off", cam.d_off, (4 * N, 3), f32)]
        for name, h in hits.items():
            if h is None:
                continue
            R = 4 * N if name == "off" else N
            checks += [(f"{name}.t", h.t, (R,), f32),
                       (f"{name}.u", h.u, (R,), f32),
                       (f"{name}.v", h.v, (R,), f32),
                       (f"{name}.prim", h.prim, (R,), i32),
                       (f"{name}.valid", h.valid, (R,), u8)]
        if occl is not None:
            R = {CONNECT: 5 * N, SHIFT: 4 * N, BOUNCE: N}[stage]
            checks.append(("occl", occl, (R,), u8))
        for name, x, shape, dtype in checks:
            _check(name, x, shape, dtype, dev)

        def ptr(x):
            return None if x is None else x.data_ptr()

        def hit_ptrs(h):
            return [ptr(None if h is None else getattr(h, k))
                    for k in ("t", "u", "v", "prim", "valid")]
        # the next rays go to the vertex buffers, which then trade places
        # with the ray buffers (in place over the vertex's own rays, each
        # lane reading its own before it writes)
        dest = (st.ray_o, st.ray_d, st.ray_maxt) if stage == START else \
            (st.vtx_o, st.vtx_d, st.vtx_maxt)
        counters = [_counter(x, N, dev) for x in rng]
        n_total = np.float32(self.n_area)
        pointers = (
            [ptr(None if cam is None else cam.o),
             ptr(None if cam is None else cam.d)] + hit_ptrs(hits["cam"]) +
            [ptr(None if cam is None else cam.o_off),
             ptr(None if cam is None else cam.d_off)] +
            hit_ptrs(hits["off"]) + hit_ptrs(hit_v) + hit_ptrs(hit) +
            [ptr(occl)] + [ptr(c[0]) for c in counters] +
            [ptr(x) for x in (g.tri_shade, mat, em.tri_offset, em.tri_count,
                              em.tri_cdf, em.tri_geo, em.total_area,
                              em.radiance, g.shape_emitter, scene.ray_eps)] +
            [ptr(getattr(st, k)) for k in GPTState._fields[:18]] +
            [ptr(x) for x in dest] + [ptr(st.vtx_o), ptr(st.vtx_d)])
        args = _Args(
            *pointers, N, T, SHADE_COLUMNS, mat.shape[0], mat.shape[1],
            self.n_area, S, C, em_ops.search_iters(C), stage, b,
            self.n_bounces, self.max_depth, self.rr_depth,
            int(self.diffuse_vertex), *(c[1] for c in counters),
            *(c[2] for c in counters), float(n_total),
            float(np.float32(1.0 / self.n_area)), float(self.n_lights))
        lib = load_library()
        with torch.cuda.device(dev):
            err = lib.gpt_shade(ctypes.addressof(args),
                                torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"gpt_shade launch failed: CUDA error {err}")
        self.launches += 1
        if stage in (SHIFT, BOUNCE):
            st = st._replace(ray_o=st.vtx_o, ray_d=st.vtx_d,
                             ray_maxt=st.vtx_maxt, vtx_o=st.ray_o,
                             vtx_d=st.ray_d, vtx_maxt=st.ray_maxt)
        return st
