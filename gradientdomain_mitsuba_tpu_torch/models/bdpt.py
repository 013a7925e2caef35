"""Bidirectional path tracing (BDPT) with full multiple importance sampling.

Counterpart of gradientdomain_mitsuba_tpu/models/bdpt.py (the bdpt
integrator + libbidir path machinery, src/integrators/bdpt/bdpt.cpp,
src/libbidir/{path,vertex,edge}.cpp): both subpaths live in fixed-shape
SoA tensors

    eye   vertices z_1..z_TE     -> [N, TE, ...]   (z_0 = camera)
    light vertices y_1..y_{SM-1} -> [N, SM-1, ...] (y_0 separate)

filled by a bounded random walk; every connection strategy (s,t) is one
batched evaluation over all N pixel samples with one shadow-ray batch.
The reference's conventions hold unchanged (its module docstring):
area-measure pdf_fwd / pdf_rev with delta events stored as 0 and
remapped to 1 in the MIS ratios, the power heuristic over all strategies
of equal length with (1,1) left to (0,2), a pinhole camera whose t >= 2
estimators use per-pixel sampling and whose t = 1 light image is
scattered and normalized by spp, light subpaths starting on area
emitters with cosine-weighted emission, no Russian roulette inside
subpaths, and the shading-normal correction on the adjoint walk.

The strategy loop is the reference's static Python loop, run eagerly:
GDMT_SCAN_STRATEGIES only chose between unrolling it and scanning it in
XLA (the same image), so it is not read.  GDMT_MAX_BDPT_DEPTH is read as
the reference reads it.  The eye image is grid-aligned and accumulates
through the dense film adds; the light image lands at arbitrary pixels
and goes through the deterministic scatter (ops/film.splat_unfiltered).

Ported: the scenes the port's ops cover (diffuse BSDFs, area lights,
pinhole perspective, no textures, the independent sampler).  Environment
and delta-light NEE on the eye walk (item 14), the woven-cloth payload
(item 12) and every other unported branch raise NotImplementedError
naming its ROADMAP Queue 1 item.  The delta-vertex bookkeeping
(_is_delta_kind) is kept, but no ported scene reaches a delta vertex.
"""
from __future__ import annotations

import functools
import os
from typing import NamedTuple

import torch

from ..config import configure
from ..core import math as m
from ..core import warp
from ..core.rng import DimAllocator as DA
from ..core.rng import make_sampler
from ..ops import bsdf as bsdf_ops
from ..ops import common, film as film_ops
from ..ops import sensor as sensor_ops
from ..ops.emitter import _searchsorted_segment, sample_emitter_triangle
from ..scene.materials import CONDUCTOR, DIELECTRIC, THIN_DIELECTRIC

# Depth cap used when maxDepth=-1 (unbounded in the reference's own
# renderer, bounded here as in the reference); GDMT_MAX_BDPT_DEPTH
# overrides it, read at import as the reference reads it.
MAX_BDPT_DEPTH = int(os.environ.get("GDMT_MAX_BDPT_DEPTH", "8"))
LIGHT_DIM_BASE = 4096  # rng dim offset separating the light-path stream


class SubPath(NamedTuple):
    """SoA subpath vertex storage [N, D, ...].  Array index j holds the
    (j+1)-th vertex of the walk (z_{j+1} / y_{j+1})."""
    p: torch.Tensor         # [N, D, 3]
    ng: torch.Tensor        # [N, D, 3]
    ns: torch.Tensor        # [N, D, 3]
    wi: torch.Tensor        # [N, D, 3] unit, toward the PREVIOUS vertex
    uv: torch.Tensor        # [N, D, 2] texture coordinates
    bsdf_id: torch.Tensor   # [N, D] i32
    emitter_id: torch.Tensor  # [N, D] i32
    beta: torch.Tensor      # [N, D, 3] throughput up to (incl) vertex
    pdf_fwd: torch.Tensor   # [N, D] area pdf of sampling this vertex
    pdf_rev: torch.Tensor   # [N, D] area pdf of re-sampling THIS vertex
    #                         from its successor (walk's own reverse pdf)
    delta: torch.Tensor     # [N, D] vertex BSDF is pure delta
    valid: torch.Tensor     # [N, D]
    # the reference's woven-cloth (irawan) yarn azimuth payload; not
    # ported (ROADMAP Queue 1 item 12), always None here
    aux: torch.Tensor = None


class LightStart(NamedTuple):
    """y_0: the sampled emitter vertex."""
    p: torch.Tensor         # [N, 3]
    ng: torch.Tensor        # [N, 3]
    rad: torch.Tensor       # [N, 3] emitted radiance (front side)
    pdf_pos: torch.Tensor   # [N] area pdf incl emitter pick
    beta: torch.Tensor      # [N, 3] = rad / pdf_pos
    ok: torch.Tensor        # [N] bool
    pdf_rev: torch.Tensor   # [N] area pdf of re-sampling y_0 from y_1


class SlotOverlay:
    """Read-only stand-in for a SubPath with individual (field, slot)
    columns replaced.

    G-BDPT's t=1 image-space shift replaces one light-subpath vertex
    (plus one pdf_rev column) per strategy; the overlay keeps the base
    arrays and serves the overridden columns, so nothing is copied.
    Every column read goes through _col; reading a field that has an
    overridden column as a whole array raises (the reference's overlay
    silently passed such reads through to the base arrays).  Fields
    without overrides read through whole."""

    def __init__(self, base: SubPath, overrides):
        object.__setattr__(self, "_base", base)
        object.__setattr__(self, "_ov", dict(overrides))
        object.__setattr__(self, "_names",
                           frozenset(name for name, _ in overrides))

    def col(self, name, k):
        v = self._ov.get((name, int(k)))
        if v is not None:
            return v
        base_f = getattr(self._base, name)
        return None if base_f is None else base_f[:, k]

    def __getattr__(self, name):
        if name in object.__getattribute__(self, "_names"):
            raise AttributeError(
                f"SlotOverlay: field {name!r} has overridden columns; "
                "read it column by column through _col")
        return getattr(object.__getattribute__(self, "_base"), name)

    def __setattr__(self, name, value):
        raise AttributeError("SlotOverlay is read-only")


def _col(sp, name, k):
    """Column k of SubPath field `name`, honoring SlotOverlay overrides."""
    if isinstance(sp, SlotOverlay):
        return sp.col(name, k)
    f = getattr(sp, name)
    return None if f is None else f[:, k]


def _remap0(x):
    return torch.where(x > 0, x, 1.0)


def _dir_to_area(pdf_sa, d, dist2, ng_at_target):
    return pdf_sa * torch.abs(m.dot(d, ng_at_target)) / torch.clamp_min(
        dist2, 1e-12)


def _is_delta_kind(materials, bsdf_id):
    """Per-lane: is the vertex's BSDF a pure delta (conductor, dielectric,
    thin dielectric)?  A per-row predicate over the material table, then
    a row gather."""
    kind = materials.kind
    delta = ((kind == CONDUCTOR) | (kind == DIELECTRIC) |
             (kind == THIN_DIELECTRIC))
    return delta[torch.clamp_min(bsdf_id, 0).long()]


def _b3(x):
    return x[..., None]


def check_scene(scene, settings):
    """Raise NotImplementedError naming the ROADMAP Queue 1 item for a
    scene a ported bidirectional tracer cannot render yet: emitters and
    sensors first, then materials, then textures.  Returns the scene's
    material kinds."""
    if settings.env_kind != 0 or settings.n_delta > 0:
        raise NotImplementedError(
            "environment / delta-light NEE on the eye walk: ROADMAP "
            "Queue 1 item 14")
    sensor_ops.check_supported(scene.camera)
    if bool(int(settings.has_textures) & 16):
        raise NotImplementedError(
            "woven-cloth (irawan) vertex payload: ROADMAP Queue 1 item 12")
    kinds = bsdf_ops.scene_kinds(scene)
    if not kinds <= bsdf_ops.PORTED_KINDS:
        raise NotImplementedError(
            f"material kinds {sorted(kinds)}: only diffuse is ported "
            "(delta vertices: item 12a; ROADMAP Queue 1 item 12)")
    if settings.has_textures:
        raise NotImplementedError(
            "textured materials: ROADMAP Queue 1 item 13")
    return kinds


class BDPTracer:
    """Bidirectional path tracer over SoA wavefronts (reference parity:
    bdpt.cpp with lightImage=true, sampleDirect via s=1 strategies)."""

    def __init__(self, scene, settings):
        configure()
        self.kinds = check_scene(scene, settings)
        self._beval = functools.partial(bsdf_ops.eval, kinds=self.kinds)
        self._bpdf = functools.partial(bsdf_ops.pdf, kinds=self.kinds)
        self._bsample = functools.partial(bsdf_ops.sample, kinds=self.kinds)
        self.settings = settings
        self.device = scene.geom.linC.device
        self.n_area = int((scene.emitters.tri_count > 0).sum())
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
        self.depth = md if md > 0 else MAX_BDPT_DEPTH  # max path edges
        self.TE = self.depth                 # eye surface vertices stored
        self.SM = self.depth                 # max s (y_0..y_{SM-1})
        self.filter_kind = film_ops.FILTERS.get(settings.rfilter, 0)
        self.has_textures = settings.has_textures
        self._u1, self._u2 = make_sampler(settings.sampler, settings.spp)
        self.light_image = bool(
            settings.integrator_props.get("lightImage", True))
        # whether the camera counts as a connectable endpoint in MIS: when
        # light tracing (t=1) is disabled, its technique must leave the
        # denominators too or every weight underestimates its strategy
        self.camera_connectable = self.light_image
        cam = scene.camera
        self._cam_pos = cam.to_world[:3, 3]
        self._cam_fwd = cam.to_world[:3, 2]
        self._a_img = sensor_ops.image_area(cam)

    # -- camera helpers -------------------------------------------------
    def _camera_pdf_area(self, scene, p, ng):
        """Full-film area pdf at p of the camera sampling a ray through it."""
        to_p = p - self._cam_pos
        dist2 = torch.clamp_min(m.squared_length(to_p), 1e-12)
        d = to_p / torch.sqrt(dist2)[..., None]
        cos_cam = torch.clamp_min(
            m.dot(d, self._cam_fwd.expand(d.shape)), 1e-6)
        pdf_dir = 1.0 / (self._a_img * cos_cam ** 3)
        return _dir_to_area(pdf_dir, d, dist2, ng)

    # -- random walk ------------------------------------------------------
    def _random_walk(self, scene, seed, sample_idx, pixel_id, o0, d0,
                     beta0, pdf_sa0, dim_base, n_steps, adjoint=False):
        """Fill a SubPath with up to n_steps vertices.

        adjoint=True applies the shading-normal importance-transport
        correction |cos_ns(wo) cos_ng(wi)| / |cos_ng(wo) cos_ns(wi)| to
        beta at every bounce (Veach 5.3; pbrt CorrectShadingNormal).

        Returns (SubPath, rev0_sa): rev0_sa is the reverse solid-angle pdf
        at the FIRST vertex toward the walk origin (needed for the
        origin's pdf_rev)."""
        N = o0.shape[0]
        dev = self.device
        eps = scene.ray_eps

        def empty(shape, val=0.0, dtype=torch.float32):
            return torch.full((N, n_steps) + shape, val, dtype=dtype,
                              device=dev)

        sp = SubPath(
            p=empty((3,)), ng=empty((3,)), ns=empty((3,)), wi=empty((3,)),
            uv=empty((2,)),
            bsdf_id=empty((), -1, torch.int32),
            emitter_id=empty((), -1, torch.int32),
            beta=empty((3,)), pdf_fwd=empty(()), pdf_rev=empty(()),
            delta=empty((), False, torch.bool),
            valid=empty((), False, torch.bool))

        o, d, beta, pdf_sa = o0, d0, beta0, pdf_sa0
        alive = torch.ones(N, dtype=torch.bool, device=dev)
        rev0_sa = torch.zeros(N, device=dev)
        zeros = torch.zeros(N, device=dev)

        for k in range(n_steps):
            hit = self.closest(o, d, zeros, torch.where(alive, 3e38, -1.0),
                               scene.geom)
            its = common.fill_intersection(scene, o, d, hit)
            alive = alive & its.valid

            pdf_fwd = _dir_to_area(pdf_sa, d, its.t ** 2, its.ng)
            delta = _is_delta_kind(scene.materials, its.bsdf_id)

            def put(arr, val, fill=0.0):
                mask = alive.reshape((-1,) + (1,) * (val.dim() - 1))
                arr[:, k] = torch.where(mask, val, fill)

            put(sp.p, its.p)
            put(sp.ng, its.ng)
            put(sp.ns, its.ns)
            put(sp.wi, -d)
            put(sp.uv, its.uv)
            put(sp.bsdf_id, its.bsdf_id, -1)
            put(sp.emitter_id, its.emitter_id, -1)
            put(sp.beta, beta)
            put(sp.pdf_fwd, pdf_fwd)
            put(sp.delta, delta, False)
            sp.valid[:, k] = alive

            # sample continuation at vertex k
            ss, ts = m.build_frame(its.ns)
            wi = m.to_local(-d, ss, ts, its.ns)
            par = common.material_params(scene, self.has_textures,
                                         its.bsdf_id, its.uv)
            u2 = self._u2(seed, pixel_id, sample_idx,
                          dim_base + DA.bounce_dim(k, DA.D_BSDF_UV))
            uc = self._u1(
                seed, pixel_id, sample_idx,
                dim_base + DA.bounce_dim(k, DA.D_BSDF_COMPONENT))
            bs = self._bsample(par, wi, u2, uc)
            # reverse pdf toward the previous vertex, given the sampled wo
            pdf_rev_sa = self._bpdf(par, bs.wo, wi)
            if k == 0:
                rev0_sa = torch.where(alive, pdf_rev_sa, 0.0)
            else:
                to_prev = sp.p[:, k - 1] - its.p
                d2p = torch.clamp_min(m.squared_length(to_prev), 1e-12)
                dirp = to_prev / torch.sqrt(d2p)[..., None]
                rev_area = _dir_to_area(pdf_rev_sa, dirp, d2p,
                                        sp.ng[:, k - 1])
                sp.pdf_rev[:, k - 1] = torch.where(alive, rev_area, 0.0)

            wo_w = m.to_world(bs.wo, ss, ts, its.ns)
            weight = bs.weight
            if adjoint:
                num = (torch.abs(m.dot(wo_w, its.ns)) *
                       torch.abs(m.dot(d, its.ng)))
                den = (torch.abs(m.dot(wo_w, its.ng)) *
                       torch.abs(m.dot(d, its.ns)))
                corr = torch.where(den > 1e-9,
                                   num / torch.clamp_min(den, 1e-9), 0.0)
                weight = weight * corr[..., None]
            o = common.offset_ray_origin(its.p, its.ng, wo_w, eps)
            d = wo_w
            alive = alive & bs.valid
            beta = torch.where(alive[..., None], beta * weight, 0.0)
            pdf_sa = torch.where(bs.is_delta, 0.0, bs.pdf)

        return sp, rev0_sa

    # -- subpath generation -------------------------------------------------
    def _gen_eye_path(self, scene, seed, sample_idx, pixel_id, W, H):
        N = pixel_id.shape[0]
        px = (pixel_id % W).to(torch.float32)
        py = (pixel_id // W).to(torch.float32)
        jitter = self._u2(seed, pixel_id, sample_idx, DA.PIXEL_JITTER)
        pos_film = torch.stack([px, py], -1) + jitter
        u_ap = self._u2(seed, pixel_id, sample_idx, DA.APERTURE)
        o, d = sensor_ops.sample_ray(scene.camera, W, H, pos_film, u_ap)
        cos_cam = torch.clamp_min(m.dot(d, self._cam_fwd.expand(d.shape)),
                                  1e-6)
        pdf_dir = 1.0 / (self._a_img * cos_cam ** 3)
        sp, _ = self._random_walk(
            scene, seed, sample_idx, pixel_id, o, d,
            torch.ones((N, 3), device=self.device), pdf_dir, 0, self.TE)
        return pos_film, sp

    def _gen_light_path(self, scene, seed, sample_idx, pixel_id):
        N = pixel_id.shape[0]
        em = scene.emitters
        u_sel = self._u1(seed, pixel_id, sample_idx, LIGHT_DIM_BASE)
        u_pos = self._u2(seed, pixel_id, sample_idx, LIGHT_DIM_BASE + 1)
        u_dir = self._u2(seed, pixel_id, sample_idx, LIGHT_DIM_BASE + 3)

        n_area = max(self.n_area, 1)
        e = torch.clamp_max((u_sel * n_area).to(torch.int32), n_area - 1)
        u_res = torch.clamp(u_sel * n_area - e, 0.0, 1.0)
        e = e.long()
        off = em.tri_offset[e]
        cnt = em.tri_count[e]
        flat = _searchsorted_segment(em.tri_cdf, off, off + cnt - 1, u_res)
        y0p, ng0 = sample_emitter_triangle(scene, flat, u_pos)
        pdf_pos = 1.0 / (torch.clamp_min(em.total_area[e], 1e-12) * n_area)
        rad = common.fast_row_gather(em.radiance, e)
        ok = torch.full((N,), self.n_area > 0, device=self.device)

        ssf, tsf = m.build_frame(ng0)
        d_local = warp.square_to_cosine_hemisphere(u_dir)
        d0 = m.to_world(d_local, ssf, tsf, ng0)
        pdf_dir = torch.clamp_min(
            warp.square_to_cosine_hemisphere_pdf(d_local), 1e-12)
        cos0 = torch.clamp_min(d_local[..., 2], 0.0)

        beta0 = rad / _b3(pdf_pos)
        beta1 = beta0 * _b3(cos0 / pdf_dir)
        o0 = common.offset_ray_origin(y0p, ng0, d0, scene.ray_eps)
        # at least one slot so downstream indexing stays well-formed even
        # when maxDepth==1 (no s>=2 strategy ever reads it then)
        sp, rev0_sa = self._random_walk(
            scene, seed, sample_idx, pixel_id, o0, d0, beta1, pdf_dir,
            LIGHT_DIM_BASE + 8, max(self.SM - 1, 1), adjoint=True)

        # pdf_rev of y_0: reverse pdf at y_1 toward y_0, area measure
        to0 = y0p - sp.p[:, 0]
        d20 = torch.clamp_min(m.squared_length(to0), 1e-12)
        dir0 = to0 / torch.sqrt(d20)[..., None]
        pdf_rev_y0 = torch.where(sp.valid[:, 0],
                                 _dir_to_area(rev0_sa, dir0, d20, ng0), 0.0)

        y0 = LightStart(p=y0p, ng=ng0, rad=rad, pdf_pos=pdf_pos,
                        beta=beta0, ok=ok, pdf_rev=pdf_rev_y0)
        return y0, sp

    # -- BSDF evaluation at a stored vertex ---------------------------------
    def _vertex_params(self, scene, sp, k):
        return common.material_params(scene, self.has_textures,
                                      _col(sp, "bsdf_id", k),
                                      _col(sp, "uv", k))

    def _eval_at(self, scene, sp, k, wo_world):
        """(f*cos, pdf_sa) at vertex k toward world direction wo."""
        ns_k = _col(sp, "ns", k)
        ss, ts = m.build_frame(ns_k)
        wi = m.to_local(_col(sp, "wi", k), ss, ts, ns_k)
        wo = m.to_local(wo_world, ss, ts, ns_k)
        par = self._vertex_params(scene, sp, k)
        return self._beval(par, wi, wo), self._bpdf(par, wi, wo)

    def _pdf_toward_prev(self, scene, sp, k, d_new_in, prev_p, prev_ng):
        """Area pdf at sp[k] of sampling the direction toward prev_p given
        the NEW incoming direction d_new_in (strategy-specific pdf_rev
        fixup for the vertex behind a connection endpoint)."""
        to_prev = prev_p - _col(sp, "p", k)
        d2 = torch.clamp_min(m.squared_length(to_prev), 1e-12)
        dirp = to_prev / torch.sqrt(d2)[..., None]
        ns_k = _col(sp, "ns", k)
        ssf, tsf = m.build_frame(ns_k)
        par = self._vertex_params(scene, sp, k)
        pdf_sa = self._bpdf(
            par, m.to_local(d_new_in, ssf, tsf, ns_k),
            m.to_local(dirp, ssf, tsf, ns_k))
        return _dir_to_area(pdf_sa, dirp, d2, prev_ng)

    # -- MIS ------------------------------------------------------------
    def _mis_sum(self, eye, light, y0: LightStart, s, t, pdf_rev_pt,
                 pdf_rev_pt_minus, pdf_rev_qs, pdf_rev_qs_minus):
        """Power-heuristic (beta=2) technique sum for strategy (s,t):
        sum over competing strategies of (p_other/p_this)^2.  The MIS
        weight is 1/(1+sum); G-BDPT additionally combines base+offset sums
        (gbdpt.py).  pdf_rev_* are the strategy-specific area-pdf fixups
        for the vertices adjacent to the connection ([N] each)."""
        N = pdf_rev_pt.shape[0]
        dev = pdf_rev_pt.device
        sum_ri = torch.zeros(N, device=dev)
        if s + t == 2:
            return sum_ri

        # eye side: hypothetical connections at z_i, i = t-1 .. 1
        ri = torch.ones(N, device=dev)
        for i in range(t - 1, 0, -1):
            idx = i - 1
            if i == t - 1:
                num = pdf_rev_pt
            elif i == t - 2:
                num = pdf_rev_pt_minus
            else:
                num = _col(eye, "pdf_rev", idx)
            den = _col(eye, "pdf_fwd", idx)
            ri = ri * (_remap0(num) / _remap0(den))
            v_delta = _col(eye, "delta", idx)
            if i >= 2:
                use = ~v_delta & ~_col(eye, "delta", idx - 1)
            elif self.camera_connectable:
                use = ~v_delta
            else:
                # z_0 = camera: connectable only when light tracing is on
                use = torch.zeros_like(v_delta)
            sum_ri = sum_ri + torch.where(use, ri * ri, 0.0)

        # light side: hypothetical connections at y_i, i = s-1 .. 0
        ri = torch.ones(N, device=dev)
        for i in range(s - 1, -1, -1):
            if i == s - 1:
                num = pdf_rev_qs
            elif i == s - 2:
                num = pdf_rev_qs_minus
            elif i == 0:
                num = y0.pdf_rev
            else:
                num = _col(light, "pdf_rev", i - 1)
            den = y0.pdf_pos if i == 0 else _col(light, "pdf_fwd", i - 1)
            ri = ri * (_remap0(num) / _remap0(den))
            if i == 0:
                # area light origin, not delta
                sum_ri = sum_ri + ri * ri
                continue
            use = ~_col(light, "delta", i - 1)
            if i >= 2:   # y_0 (i == 1's predecessor) is not delta
                use = use & ~_col(light, "delta", i - 2)
            sum_ri = sum_ri + torch.where(use, ri * ri, 0.0)

        return sum_ri

    # -- strategies -------------------------------------------------------
    def _strategy_s0(self, scene, eye, light, y0, t, N, return_aux=False):
        """Eye path hits an emitter at z_{t-1}.

        return_aux=True additionally returns the strategy's pdf_rev
        fixups (for G-BDPT's suffix-factorized offset MIS sums, which
        re-run _mis_sum on the shifted view with the SAME fixups)."""
        dev = self.device
        k = t - 2
        em_id = _col(eye, "emitter_id", k)
        cosf = m.dot(_col(eye, "ns", k), _col(eye, "wi", k))
        ok = _col(eye, "valid", k) & (em_id >= 0) & (cosf > 0)
        em_c = torch.clamp_min(em_id, 0)
        rad = common.fast_row_gather(scene.emitters.radiance, em_c)
        contrib = _col(eye, "beta", k) * rad

        n_area = max(self.n_area, 1)
        area = scene.emitters.total_area[em_c.long()]
        pdf_rev_pt = 1.0 / (torch.clamp_min(area, 1e-12) * n_area)
        zeros = torch.zeros(N, device=dev)
        if t >= 3:
            km = k - 1
            to_prev = _col(eye, "p", km) - _col(eye, "p", k)
            d2 = torch.clamp_min(m.squared_length(to_prev), 1e-12)
            dirp = to_prev / torch.sqrt(d2)[..., None]
            pdf_dir = torch.abs(m.dot(dirp, _col(eye, "ng", k))) / torch.pi
            pdf_rev_pt_minus = _dir_to_area(pdf_dir, dirp, d2,
                                            _col(eye, "ng", km))
        else:
            pdf_rev_pt_minus = zeros
        sum_ri = self._mis_sum(eye, light, y0, 0, t, pdf_rev_pt,
                               pdf_rev_pt_minus, zeros, zeros)
        out = torch.where(_b3(ok), contrib, 0.0)
        if return_aux:
            return out, sum_ri, dict(
                pdf_rev_pt=pdf_rev_pt, pdf_rev_pt_minus=pdf_rev_pt_minus,
                pdf_rev_qs=zeros, pdf_rev_qs_minus=zeros,
                occ=torch.zeros(N, dtype=torch.bool, device=dev))
        return out, sum_ri

    def _strategy_s1(self, scene, eye, light, y0, t, N, eps,
                     return_aux=False, occ=None):
        """Connect eye vertex z_{t-1} to the sampled light point y_0.

        occ: precomputed connection-visibility result.  G-BDPT's offset
        views pass the BASE strategy's occlusion when the view's endpoint
        vertex coincides with the base's (reconnected mode in all-diffuse
        scenes: identical endpoints -> identical shadow ray)."""
        dev = self.device
        k = t - 2
        zp = _col(eye, "p", k)
        ng_k = _col(eye, "ng", k)
        ok = _col(eye, "valid", k) & ~_col(eye, "delta", k) & y0.ok
        to_l = y0.p - zp
        d2 = torch.clamp_min(m.squared_length(to_l), 1e-12)
        dist = torch.sqrt(d2)
        d = to_l / _b3(dist)
        cos_l = torch.clamp_min(-m.dot(d, y0.ng), 0.0)
        ok = ok & (cos_l > 1e-6)

        f_eye, pdf_eye_sa = self._eval_at(scene, eye, k, d)
        if occ is None:
            sh_o = common.offset_ray_origin(zp, ng_k, d, eps)
            occ = self.occluded(
                sh_o, d, torch.zeros(N, device=dev),
                dist - 2 * eps / torch.clamp_min(cos_l, 1e-3), scene.geom)
        ok = ok & ~occ
        contrib = _col(eye, "beta", k) * f_eye * y0.beta * _b3(cos_l / d2)

        zeros = torch.zeros(N, device=dev)
        pdf_rev_qs = _dir_to_area(pdf_eye_sa, d, d2, y0.ng)
        pdf_dir_l = cos_l / torch.pi
        pdf_rev_pt = _dir_to_area(pdf_dir_l, -d, d2, ng_k)
        if t >= 3:
            pdf_rev_pt_minus = self._pdf_toward_prev(
                scene, eye, k, d, _col(eye, "p", k - 1),
                _col(eye, "ng", k - 1))
        else:
            pdf_rev_pt_minus = zeros
        sum_ri = self._mis_sum(eye, light, y0, 1, t, pdf_rev_pt,
                               pdf_rev_pt_minus, pdf_rev_qs, zeros)
        out = torch.where(_b3(ok), contrib, 0.0)
        if return_aux:
            return out, sum_ri, dict(
                pdf_rev_pt=pdf_rev_pt, pdf_rev_pt_minus=pdf_rev_pt_minus,
                pdf_rev_qs=pdf_rev_qs, pdf_rev_qs_minus=zeros, occ=occ)
        return out, sum_ri

    def _strategy_connect(self, scene, eye, light, y0, s, t, N, eps,
                          return_aux=False, occ=None):
        """General connection z_{t-1} <-> y_{s-1} (s>=2, t>=2).
        occ: precomputed visibility (see _strategy_s1)."""
        dev = self.device
        ke = t - 2
        kl = s - 2
        zp = _col(eye, "p", ke)
        yp = _col(light, "p", kl)
        ng_e = _col(eye, "ng", ke)
        ng_l = _col(light, "ng", kl)
        ok = (_col(eye, "valid", ke) & ~_col(eye, "delta", ke) &
              _col(light, "valid", kl) & ~_col(light, "delta", kl))
        to_l = yp - zp
        d2 = torch.clamp_min(m.squared_length(to_l), 1e-12)
        dist = torch.sqrt(d2)
        d = to_l / _b3(dist)

        f_eye, pdf_eye_sa = self._eval_at(scene, eye, ke, d)
        f_lt, pdf_lt_sa = self._eval_at(scene, light, kl, -d)
        if occ is None:
            sh_o = common.offset_ray_origin(zp, ng_e, d, eps)
            occ = self.occluded(sh_o, d, torch.zeros(N, device=dev),
                                dist - 2 * eps, scene.geom)
        ok = ok & ~occ
        contrib = (_col(eye, "beta", ke) * f_eye * f_lt *
                   _col(light, "beta", kl) / _b3(d2))

        pdf_rev_qs = _dir_to_area(pdf_eye_sa, d, d2, ng_l)
        pdf_rev_pt = _dir_to_area(pdf_lt_sa, -d, d2, ng_e)
        if t >= 3:
            pdf_rev_pt_minus = self._pdf_toward_prev(
                scene, eye, ke, d, _col(eye, "p", ke - 1),
                _col(eye, "ng", ke - 1))
        else:
            pdf_rev_pt_minus = torch.zeros(N, device=dev)
        if s >= 3:
            pdf_rev_qs_minus = self._pdf_toward_prev(
                scene, light, kl, -d, _col(light, "p", kl - 1),
                _col(light, "ng", kl - 1))
        else:  # s == 2: the previous light vertex is y_0
            pdf_rev_qs_minus = self._pdf_toward_prev(
                scene, light, kl, -d, y0.p, y0.ng)
        sum_ri = self._mis_sum(eye, light, y0, s, t, pdf_rev_pt,
                               pdf_rev_pt_minus, pdf_rev_qs,
                               pdf_rev_qs_minus)
        out = torch.where(_b3(ok), contrib, 0.0)
        if return_aux:
            return out, sum_ri, dict(
                pdf_rev_pt=pdf_rev_pt, pdf_rev_pt_minus=pdf_rev_pt_minus,
                pdf_rev_qs=pdf_rev_qs, pdf_rev_qs_minus=pdf_rev_qs_minus,
                occ=occ)
        return out, sum_ri

    def _t1_shadow_ray(self, scene, light, s, eps):
        """The base t=1 strategy's camera-visibility shadow ray for light
        vertex y_{s-1}: (origin, dir, maxt).  Callers concatenate these
        across all t=1 strategies into one occlusion call."""
        kl = s - 2
        yp = _col(light, "p", kl)
        to_cam = self._cam_pos.expand(yp.shape) - yp
        d2 = torch.clamp_min(m.squared_length(to_cam), 1e-12)
        dist = torch.sqrt(d2)
        d = to_cam / _b3(dist)
        sh_o = common.offset_ray_origin(yp, _col(light, "ng", kl), d, eps)
        return sh_o, d, dist - 2 * eps

    def _batched_t1_occlusion(self, scene, light, t1_list, N, eps):
        """One occlusion call covering every t=1 strategy's camera shadow
        ray; returns {s: occ [N]}."""
        if not t1_list:
            return {}
        rays = [self._t1_shadow_ray(scene, light, s, eps) for s in t1_list]
        nb = len(t1_list)
        occ = self.occluded(
            torch.cat([r[0] for r in rays]),
            torch.cat([r[1] for r in rays]),
            torch.zeros(nb * N, device=self.device),
            torch.cat([r[2] for r in rays]), scene.geom)
        return {s: occ[i * N:(i + 1) * N] for i, s in enumerate(t1_list)}

    def _strategy_t1(self, scene, eye, light, y0, s, N, eps, W, H,
                     occ=None):
        """Light tracing (s>=2): connect y_{s-1} to the camera.  Returns
        (film_pos, value UNWEIGHTED, technique sum) — the caller folds the
        MIS weight (G-BDPT needs the raw sum for its pair weights).

        occ: precomputed camera-visibility result; G-BDPT's t=1 offset
        views pass all-False because their endpoint z'_1 IS the closest
        hit along the retraced camera ray (visibility by construction)."""
        dev = self.device
        kl = s - 2
        yp = _col(light, "p", kl)
        yng = _col(light, "ng", kl)
        beta = _col(light, "beta", kl)
        ok = _col(light, "valid", kl) & ~_col(light, "delta", kl)

        film, we, in_frustum = sensor_ops.importance_sample_direct(
            scene.camera, W, H, yp)
        to_cam = self._cam_pos.expand(yp.shape) - yp
        d2 = torch.clamp_min(m.squared_length(to_cam), 1e-12)
        dist = torch.sqrt(d2)
        d = to_cam / _b3(dist)
        cos_cam = torch.clamp_min(m.dot(-d, self._cam_fwd.expand(d.shape)),
                                  1e-6)

        f_eval, _ = self._eval_at(scene, light, kl, d)
        if occ is None:
            sh_o = common.offset_ray_origin(yp, yng, d, eps)
            occ = self.occluded(sh_o, d, torch.zeros(N, device=dev),
                                dist - 2 * eps, scene.geom)
        ok = ok & ~occ & in_frustum
        value = beta * f_eval * _b3(we * cos_cam / d2)

        pdf_rev_qs = self._camera_pdf_area(scene, yp, yng)
        if s >= 3:
            pdf_rev_qs_minus = self._pdf_toward_prev(
                scene, light, kl, d, _col(light, "p", kl - 1),
                _col(light, "ng", kl - 1))
        else:
            pdf_rev_qs_minus = self._pdf_toward_prev(
                scene, light, kl, d, y0.p, y0.ng)
        zeros = torch.zeros(N, device=dev)
        sum_ri = self._mis_sum(eye, light, y0, s, 1, zeros, zeros,
                               pdf_rev_qs, pdf_rev_qs_minus)
        value = torch.where(_b3(ok), value, 0.0)
        return film, value, sum_ri

    def _t1_list(self):
        """The light-tracing strategies s of this depth (none without the
        light image)."""
        if not self.light_image:
            return []
        return [s for s in range(2, self.SM + 1) if s <= self.depth]

    def _strategies(self):
        """The (s, t) strategies with t >= 2 of this depth, in the
        reference's loop order."""
        return [(s, t) for t in range(2, self.TE + 2)
                for s in range(0, self.SM + 1)
                if s + t - 1 <= self.depth]

    # -- per-sample evaluation ---------------------------------------------
    def trace_pass(self, scene, seed, sample_idx, pixel_id=None):
        """One sample for a batch of pixels (default: the whole frame).
        Returns (film positions [N,2], eye radiance [N,3], light-image
        splat positions [M,2], splat values [M,3])."""
        st = self.settings
        W, H = st.width, st.height
        if pixel_id is None:
            pixel_id = torch.arange(W * H, dtype=torch.int64,
                                    device=self.device)
        N = pixel_id.shape[0]
        eps = scene.ray_eps

        pos_film, eye = self._gen_eye_path(scene, seed, sample_idx,
                                           pixel_id, W, H)
        y0, light = self._gen_light_path(scene, seed, sample_idx, pixel_id)

        L = torch.zeros((N, 3), device=self.device)
        splat_pos, splat_val = [], []
        t1_list = self._t1_list()
        occ_t1 = self._batched_t1_occlusion(scene, light, t1_list, N, eps)
        # (1,1) is covered by (0,2)
        for s in t1_list:
            pos, val, sri = self._strategy_t1(scene, eye, light, y0, s, N,
                                              eps, W, H, occ=occ_t1[s])
            splat_pos.append(pos)
            splat_val.append(val * _b3(1.0 / (1.0 + sri)))
        for s, t in self._strategies():
            if s == 0:
                c, sri = self._strategy_s0(scene, eye, light, y0, t, N)
            elif s == 1:
                c, sri = self._strategy_s1(scene, eye, light, y0, t, N, eps)
            else:
                c, sri = self._strategy_connect(scene, eye, light, y0, s, t,
                                                N, eps)
            L = L + c * _b3(1.0 / (1.0 + sri))

        if splat_pos:
            splat_pos = torch.cat(splat_pos, 0)
            splat_val = torch.cat(splat_val, 0)
        else:
            splat_pos = torch.zeros((0, 2), device=self.device)
            splat_val = torch.zeros((0, 3), device=self.device)
        return pos_film, L, splat_pos, splat_val

    # -- frame rendering -----------------------------------------------------
    def render_chunk(self, scene, seed, sample_start, n_samples):
        """Accumulate n_samples samples per pixel from sample index
        sample_start, one sample per pixel a pass: (eye film [H,W,3],
        filter weights [H,W], light image [H,W,3], measured rays (0-d
        int64; zero unless count_rays)), all on the device."""
        st = self.settings
        H, W = st.height, st.width
        dev = self.device
        fb = torch.zeros((H, W, 3), device=dev)
        wb = torch.zeros((H, W), device=dev)
        li = torch.zeros((H, W, 3), device=dev)
        self.ray_tally = (torch.zeros((), dtype=torch.int64, device=dev)
                          if self.count_rays else None)
        try:
            for i in range(n_samples):
                pos, L, spos, sval = self.trace_pass(scene, seed,
                                                     sample_start + i)
                # the eye samples are grid-aligned: dense filtered adds
                fb, wb = film_ops.splat_grid(fb, wb, (pos % 1.0)[None],
                                             L[None], self.filter_kind)
                li = film_ops.splat_unfiltered(li, spos, sval)
            rays = (self.ray_tally if self.ray_tally is not None else
                    torch.zeros((), dtype=torch.int64, device=dev))
        finally:
            self.ray_tally = None
        return fb, wb, li, rays

    def finalize(self, state, spp):
        return film_ops.develop(state["0"], state["1"]) + state["2"] / spp

    def render(self, scene, seed=0, spp=None, chunk=32,
               checkpoint_path=None, resume=False, progress=None):
        """Render spp samples per pixel through render_accumulate; returns
        the image [H, W, 3] on the device (eye image + light image / spp);
        with count_rays, last_ray_count holds the measured rays (one host
        read at the end)."""
        from ..parallel.checkpoint import render_accumulate
        spp = spp or self.settings.spp
        state, spp = render_accumulate(
            self, scene, seed, spp, chunk,
            checkpoint_path=checkpoint_path, resume=resume,
            progress=progress)
        if self.count_rays and "3" in state:
            self.last_ray_count = int(state["3"])
        return self.finalize(state, spp)
