"""Stochastic progressive photon mapping on a sorted hash grid.

Counterpart of gradientdomain_mitsuba_tpu/models/sppm.py (the photon-
mapping family, src/integrators/photonmapper/{photonmapper,ppm,sppm}.cpp
+ src/librender/photonmap.cpp).  Every pass

  1. traces one camera "visible point" per pixel through the specular
     chain (delta vertices continue, the first storable vertex stops;
     emitter radiance along the chain accumulates directly),
  2. traces a fixed-size wavefront of photon random walks from the area
     and delta emitters (adjoint BSDF sampling with the shading-normal
     correction),
  3. bins the deposited photons into a uniform hash grid with cell size
     equal to the current gather radius, sorts them by cell key and
     gathers each pixel's 27 neighbour cells with a fixed per-cell scan
     cap (`gatherCap`).

Radius schedule: the memoryless Knaus-Zwicker 2011 formulation, a global
per-pass radius with r2_{i+1} = r2_i (i+alpha)/(i+1), the image the mean
of the per-pass estimates.  `photonmapper` and `ppm` map to the same
machinery, as in the reference.

Which photons a cell's scan reaches when it holds more than `gatherCap`
depends on the order of equal keys, so the sort is stable, as
jnp.argsort is, and the keys sort as unsigned (dead photons' 0xFFFFFFFF
last).  Photons leave the area lights (uniform area, cosine direction)
and the delta lights: a point light samples the uniform sphere, a spot
light the uniform cone with its falloff factor, a collimated beam
emits along its axis with unit pdf, and a directional light emits at
zero power (it would need a scene-bounding disk), as in the reference.
The environment is seen along the camera chain.
"""
from __future__ import annotations

import functools
import math

import torch

from ..core import math as m
from ..core import warp
from ..core.records import tree_map
from ..core.rng import DimAllocator as DA
from ..core.rng import MASK
from ..ops import bsdf as bsdf_ops
from ..ops import common, emitter as em_ops
from ..ops import film as film_ops
from ..ops import sensor as sensor_ops
from .bdpt import _is_delta_kind
from .path import PathTracer, _b3

PHOTON_DIM_BASE = 16384   # rng dims for the photon stream
DEAD_KEY = 0xFFFFFFFF     # hash key of photons that deposited nothing
_HASH_PRIMES = (73856093, 19349663, 83492791)


def broadcast_params(params, shape, axis):
    """MatParams of [n] lanes as views of `shape` = (N, K): each field
    gets a new axis at `axis` (1 for per-row lanes, 0 for per-column
    lanes) and is expanded, not copied."""
    def bc(a):
        return a.unsqueeze(axis).expand(tuple(shape) + tuple(a.shape[1:]))
    return tree_map(bc, params)


class SPPMTracer(PathTracer):
    """Progressive photon mapper.  integrator_props:
      photonCount   photons per pass               (default 1 << 16)
      initialRadius starting gather radius (0 = auto from scene extent)
      alpha         radius-shrink exponent          (default 0.7)
      gatherCap     per-cell scan bound             (default 32)
      maxDepth / rrDepth as usual."""

    def __init__(self, scene, settings):
        super().__init__(scene, settings)
        props = settings.integrator_props
        self.n_photons = int(props.get("photonCount", 1 << 16))
        self.alpha = float(props.get("alpha", 0.7))
        self.gather_cap = int(props.get("gatherCap", 32))
        r0 = float(props.get("initialRadius", 0.0))
        if r0 <= 0.0:
            extent = float(scene.ray_eps) / 1e-4
            r0 = extent * 5.0 / max(settings.width, settings.height)
        self.r0 = r0
        self.photon_depth = (settings.max_depth if settings.max_depth > 0
                             else 8)
        self.cam_chain = self.photon_depth
        self.last_radius = None

    # ---------------- camera pass ------------------------------------------
    def _visible_points(self, scene, seed, pass_idx, pixel_id):
        """Camera chain to the first non-delta vertex.  Returns (film
        positions [N,2], radiance picked up along the chain [N,3], the
        visible-point record dict)."""
        st = self.settings
        W, H = st.width, st.height
        N = pixel_id.shape[0]
        dev = self.device
        eps = scene.ray_eps
        px = (pixel_id % W).to(torch.float32)
        py = (pixel_id // W).to(torch.float32)
        jitter = self._u2(seed, pixel_id, pass_idx, DA.PIXEL_JITTER)
        pos_film = torch.stack([px, py], -1) + jitter
        u_ap = self._u2(seed, pixel_id, pass_idx, DA.APERTURE)
        o, d = sensor_ops.sample_ray(self.sensor, W, H, pos_film, u_ap)

        z3 = torch.zeros((N, 3), device=dev)
        L = z3
        tp = torch.ones((N, 3), device=dev)
        alive = torch.ones(N, dtype=torch.bool, device=dev)
        stored = torch.zeros(N, dtype=torch.bool, device=dev)
        vp = dict(p=z3, ns=z3, ng=z3, wi=z3,
                  bsdf=torch.full((N,), -1, dtype=torch.int32, device=dev),
                  uv=torch.zeros((N, 2), device=dev), tp=z3)

        for b in range(self.cam_chain):
            hit = self.closest(o, d, torch.zeros(N, device=dev),
                               torch.where(alive, 3e38, -1.0), scene.geom)
            its = common.fill_intersection(scene, o, d, hit)
            wi_world = -d
            cos_front = m.dot(its.ns, wi_world)
            is_em = its.valid & (its.emitter_id >= 0) & (cos_front > 0)
            rad = scene.emitters.radiance[
                torch.clamp_min(its.emitter_id, 0).long()]
            L = L + torch.where(_b3(alive & is_em), tp * rad, 0.0)
            if self.has_env:
                L = L + torch.where(_b3(alive & ~its.valid),
                                    tp * em_ops.eval_env(scene, self.env_kind,
                                                         d), 0.0)
            alive = alive & its.valid

            storable = alive & ~_is_delta_kind(scene.materials, its.bsdf_id)
            newly = storable & ~stored
            for key, val in (("p", its.p), ("ns", its.ns), ("ng", its.ng),
                             ("wi", wi_world), ("uv", its.uv), ("tp", tp)):
                vp[key] = torch.where(_b3(newly), val, vp[key])
            vp["bsdf"] = torch.where(newly, its.bsdf_id, vp["bsdf"])
            stored = stored | storable
            alive = alive & ~storable   # the chain stops at the store

            # delta continuation
            ss, ts = m.build_frame(its.ns)
            wi = m.to_local(wi_world, ss, ts, its.ns)
            par = common.material_params(scene, self.has_textures,
                                         its.bsdf_id, its.uv, bary=its.bary)
            u2 = self._u2(seed, pixel_id, pass_idx,
                          DA.bounce_dim(b, DA.D_BSDF_UV))
            uc = self._u1(seed, pixel_id, pass_idx,
                          DA.bounce_dim(b, DA.D_BSDF_COMPONENT))
            bs = self._bsample(par, wi, u2, uc)
            alive = alive & bs.valid
            tp = torch.where(_b3(alive), tp * bs.weight, tp)
            d = m.to_world(bs.wo, ss, ts, its.ns)
            o = common.offset_ray_origin(its.p, its.ng, d, eps)

        vp["valid"] = stored
        return pos_film, L, vp

    def _delta_photons(self, em, de, u, total_lights):
        """Start of the photons picked on delta light de: (position,
        direction, power).  Point: uniform sphere; spot: uniform cone
        about its axis times the falloff factor; collimated: its axis
        with unit pdf; directional: zero power (the reference's own
        deviation, for want of a scene-bounding emission disk)."""
        de = torch.clamp(de, 0, self.n_delta - 1).long()
        dkind = em.delta_kind[de]
        ddir = em.delta_dir[de]
        sph = warp.square_to_uniform_sphere(u)
        cos_total = em.delta_cos_total[de]
        cone = warp.square_to_uniform_cone(u, cos_total)
        ssd, tsd = m.build_frame(ddir)
        is_spot = dkind == 1
        is_coll = dkind == 3
        d0 = torch.where(is_spot[..., None], m.to_world(cone, ssd, tsd, ddir),
                         sph)
        pdf = torch.where(is_spot, warp.square_to_uniform_cone_pdf(cos_total),
                          warp.square_to_uniform_sphere_pdf())
        d0 = torch.where(is_coll[..., None], ddir, d0)
        pdf = torch.where(is_coll, 1.0, pdf)
        cos_d = m.dot(d0, ddir)
        cos_fall = em.delta_cos_falloff[de]
        t = torch.clamp((cos_d - cos_total) /
                        torch.clamp_min(cos_fall - cos_total, 1e-6), 0.0, 1.0)
        spot_fac = torch.where(is_spot, t, 1.0)
        beta = (em.delta_intensity[de] *
                (spot_fac / torch.clamp_min(pdf, 1e-12))[..., None] *
                total_lights)
        beta = torch.where((dkind == 2)[..., None], 0.0, beta)
        return em.delta_pos[de], d0, beta

    # ---------------- photon pass ------------------------------------------
    def _emit_photons(self, scene, seed, pass_idx):
        """One photon wavefront from the area and delta emitters: flat
        deposits (pos, power, dir, valid) of length photon_depth *
        photonCount, bounce-major."""
        P = self.n_photons
        dev = self.device
        em = scene.emitters
        ids = torch.arange(P, dtype=torch.int64, device=dev)
        eps = scene.ray_eps
        u1 = functools.partial(self._u1, seed, ids, pass_idx)
        u2 = functools.partial(self._u2, seed, ids, pass_idx)

        n_area = max(self.n_area, 1)
        n_delta = self.n_delta
        n_lights = n_area if self.n_area > 0 else 0
        total_lights = max(n_lights + n_delta, 1)
        u_sel = u1(PHOTON_DIM_BASE)
        pick = torch.clamp_max((u_sel * total_lights).to(torch.int32),
                               total_lights - 1)
        # area emitter start (uniform area, cosine direction)
        e = torch.clamp(pick, 0, n_area - 1).long()
        u_res = torch.clamp(u_sel * total_lights - pick, 0.0, 1.0)
        off = em.tri_offset[e]
        cnt = em.tri_count[e]
        flat = em_ops._searchsorted_segment(em.tri_cdf, off, off + cnt - 1,
                                            u_res)
        pos0, ng0 = em_ops.sample_emitter_triangle(
            scene, flat, u2(PHOTON_DIM_BASE + 1))
        d_local = warp.square_to_cosine_hemisphere(u2(PHOTON_DIM_BASE + 3))
        ss0, ts0 = m.build_frame(ng0)
        d = m.to_world(d_local, ss0, ts0, ng0)
        # power = Le cos / (pick * pos * dir pdfs) = pi A Le total_lights
        beta = (em.radiance[e] * math.pi * em.total_area[e][..., None] *
                total_lights)
        if n_delta > 0:
            is_area = (pick < n_lights)[..., None]
            pos_d, d_d, beta_d = self._delta_photons(
                em, pick - n_lights, u2(PHOTON_DIM_BASE + 5), total_lights)
            pos0 = torch.where(is_area, pos0, pos_d)
            d = torch.where(is_area, d, d_d)
            beta = torch.where(is_area, beta, beta_d)
            ng0 = torch.where(is_area, ng0, d_d)
        o = common.offset_ray_origin(pos0, ng0, d, eps)
        alive = torch.full((P,), self.n_area > 0 or n_delta > 0,
                           dtype=torch.bool, device=dev)
        beta = torch.where(_b3(alive), beta, 0.0)

        ph_pos, ph_pow, ph_dir, ph_ok = [], [], [], []
        for k in range(self.photon_depth):
            hit = self.closest(o, d, torch.zeros(P, device=dev),
                               torch.where(alive, 3e38, -1.0), scene.geom)
            its = common.fill_intersection(scene, o, d, hit)
            alive = alive & its.valid
            storable = alive & ~_is_delta_kind(scene.materials, its.bsdf_id)
            ph_pos.append(its.p)
            ph_pow.append(beta)
            ph_dir.append(d)
            ph_ok.append(storable)

            ss, ts = m.build_frame(its.ns)
            wi = m.to_local(-d, ss, ts, its.ns)
            par = common.material_params(scene, self.has_textures,
                                         its.bsdf_id, its.uv, bary=its.bary)
            dim = PHOTON_DIM_BASE + 8 + 8 * k
            bs = self._bsample(par, wi, u2(dim), u1(dim + 2))
            urr = u1(dim + 3)
            wo_w = m.to_world(bs.wo, ss, ts, its.ns)
            # adjoint (importance-transport) shading-normal correction
            num = (torch.abs(m.dot(wo_w, its.ns)) *
                   torch.abs(m.dot(d, its.ng)))
            den = (torch.abs(m.dot(wo_w, its.ng)) *
                   torch.abs(m.dot(d, its.ns)))
            corr = torch.where(den > 1e-9,
                               num / torch.clamp_min(den, 1e-9), 0.0)
            alive = alive & bs.valid
            beta = torch.where(_b3(alive), beta * bs.weight * _b3(corr),
                               beta)
            # photon RR (keep power bounded; from the fourth bounce)
            if k >= 3:
                q = torch.clamp(bs.weight.amax(-1), 0.05, 0.95)
                survive = urr < q
                beta = torch.where(_b3(alive & survive), beta / _b3(q), beta)
                alive = alive & survive
            d = wo_w
            o = common.offset_ray_origin(its.p, its.ng, d, eps)

        return (torch.cat(ph_pos), torch.cat(ph_pow), torch.cat(ph_dir),
                torch.cat(ph_ok))

    # ---------------- hash-grid gather -------------------------------------
    @staticmethod
    def _cell_hash(q):
        """uint32 hash of integer [..., 3] cell coordinates (negative ones
        wrap as uint32 does), as an int64 in [0, 2^32)."""
        q = q.to(torch.int64) & MASK
        a, b, c = (((q[..., i] * p) & MASK)
                   for i, p in enumerate(_HASH_PRIMES))
        return a ^ b ^ c

    def _gather(self, scene, vp, photons, r):
        """Sum photon contributions within radius r of each visible point
        via 27-cell scans of the sorted hash grid.  r: 0-d f32 tensor."""
        pos, power, pdir, ok = photons
        M = pos.shape[0]
        dev = self.device
        inv_r = 1.0 / r
        q_ph = torch.floor(pos * inv_r).to(torch.int32)
        key = torch.where(ok, self._cell_hash(q_ph), DEAD_KEY)
        key_s, order = torch.sort(key, stable=True)
        pos_s = pos[order]
        pow_s = power[order]
        dir_s = pdir[order]

        N = vp["p"].shape[0]
        K = self.gather_cap
        q_vp = torch.floor(vp["p"] * inv_r).to(torch.int32)
        params = common.material_params(scene, self.has_textures,
                                        vp["bsdf"], vp["uv"])
        ssv, tsv = m.build_frame(vp["ns"])
        wi_loc = m.to_local(vp["wi"], ssv, tsv, vp["ns"])
        params_bc = broadcast_params(params, (N, K), 1)
        wi_bc = wi_loc[:, None].expand(N, K, 3)

        acc = torch.zeros((N, 3), device=dev)
        kk = torch.arange(K, dtype=torch.int64, device=dev)
        for ox in (-1, 0, 1):
            for oy in (-1, 0, 1):
                for oz in (-1, 0, 1):
                    off = torch.tensor([ox, oy, oz], dtype=torch.int32,
                                       device=dev)
                    h = self._cell_hash(q_vp + off)
                    start = torch.searchsorted(key_s, h, side="left")
                    idx = torch.clamp(start[:, None] + kk[None, :], 0, M - 1)
                    match = key_s[idx] == h[:, None]
                    d2 = m.squared_length(pos_s[idx] - vp["p"][:, None])
                    sel = match & (d2 < r * r)
                    wi_ph_loc = m.to_local(-dir_s[idx], ssv[:, None],
                                           tsv[:, None], vp["ns"][:, None])
                    # the photon must arrive in the camera-side hemisphere
                    sel = sel & (wi_ph_loc[..., 2] * wi_loc[..., 2][:, None]
                                 > 0)
                    f_cos = bsdf_ops.eval(params_bc, wi_bc, wi_ph_loc,
                                          self.kinds)
                    f = f_cos / _b3(torch.clamp_min(
                        torch.abs(wi_ph_loc[..., 2]), 0.05))
                    acc = acc + torch.sum(
                        torch.where(_b3(sel), f * pow_s[idx], 0.0), 1)

        scale = 1.0 / (math.pi * r * r * self.n_photons)
        L_ph = vp["tp"] * acc * scale
        return torch.where(_b3(vp["valid"]), L_ph, 0.0)

    # ---------------- per-pass + progressive loop ---------------------------
    def _splat(self, pos_film, L):
        st = self.settings
        fb = torch.zeros((st.height, st.width, 3), device=self.device)
        wb = torch.zeros((st.height, st.width), device=self.device)
        return film_ops.splat_grid(fb, wb, (pos_film % 1.0)[None], L[None],
                                   self.filter_kind)

    def _one_pass(self, scene, seed, pass_idx, r):
        st = self.settings
        pixel_id = torch.arange(st.width * st.height, dtype=torch.int64,
                                device=self.device)
        pos_film, L_direct, vp = self._visible_points(scene, seed, pass_idx,
                                                      pixel_id)
        photons = self._emit_photons(scene, seed, pass_idx)
        return self._splat(pos_film,
                           L_direct + self._gather(scene, vp, photons, r))

    def render(self, scene, seed=0, spp=None, progress=None, **_):
        """spp = number of SPPM passes (each: one camera sample a pixel +
        one photon wavefront).  Returns the image [H, W, 3] on the
        device."""
        spp = spp or self.settings.spp
        r2 = [self.r0 * self.r0]
        for i in range(spp):
            r2.append(r2[-1] * (i + 1 + self.alpha) / (i + 2))
        self.last_radius = math.sqrt(r2[-1])
        return self._accumulate(spp, progress, lambda i: self._one_pass(
            scene, seed, i, torch.tensor(math.sqrt(r2[i]),
                                         dtype=torch.float32,
                                         device=self.device)))

    @staticmethod
    def _accumulate(spp, progress, one_pass):
        """The mean of spp passes: one_pass(i) gives pass i's (film,
        weights); the film over the summed weights."""
        fb_acc = wb_acc = None
        for i in range(spp):
            fb, wb = one_pass(i)
            fb_acc = fb if fb_acc is None else fb_acc + fb
            wb_acc = wb if wb_acc is None else wb_acc + wb
            if progress:
                progress(i + 1, spp)
        return fb_acc / torch.clamp_min(wb_acc, 1e-12)[..., None]


def render(scene, settings, seed=0, spp=None):
    return SPPMTracer(scene, settings).render(scene, seed=seed, spp=spp)
