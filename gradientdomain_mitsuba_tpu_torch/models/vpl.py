"""Virtual point lights / instant radiosity.

Counterpart of gradientdomain_mitsuba_tpu/models/vpl.py
(src/integrators/vpl/vpl.cpp): VPLs are the deposits of photon random
walks from the emitters (SPPM's photon walk); every pixel is shaded
against every VPL with clamped point-to-point transport.  The camera pass
makes one shading record per pixel, and the [pixels x vplChunk]
contribution matrix is evaluated branch-free with one shadow-ray batch
per chunk.

Estimator (as the reference):
  - direct light: one NEE sample at the first storable camera vertex plus
    emitters hit through the specular chain;
  - indirect light: every photon-walk surface deposit y_k with flux Phi_k
    contributes f_x(cam,dir) cos_x * f_y(in,-dir) cos_y * Phi_k / r^2 *
    V(x,y), r^2 clamped below by (clamping * scene_extent)^2.

The shadow batch of one chunk is N x K rays: at 256^2 and the default
vplChunk of 256, 16,777,216 lanes in one any-hit call, and every
[N, K, 3] f32 intermediate is 201 MB.  The material parameters broadcast
as views, and the per-pixel sum over K is one sum of K terms, as the
reference's jnp.sum(..., axis=1).
"""
from __future__ import annotations

import torch

from ..core import math as m
from ..ops import bsdf as bsdf_ops
from ..ops import common, emitter as em_ops
from .path import _b3
from .sppm import SPPMTracer, broadcast_params

VPL_NEE_DIM = 24576  # rng dim block for the camera-vertex NEE


class VPLTracer(SPPMTracer):
    """integrator_props: vplCount (walk count, default 1024; deposits =
    count x depth), clamping (relative min distance, default 0.1),
    vplChunk (VPLs per shading batch, default 256), maxDepth/rrDepth."""

    def __init__(self, scene, settings):
        # SPPM's photon walk and visible-point chain; its gather goes
        # unused
        settings.integrator_props.setdefault(
            "photonCount", int(settings.integrator_props.get(
                "vplCount", 1024)))
        super().__init__(scene, settings)
        props = settings.integrator_props
        # a deposit at photon bounce k shades as a (k+3)-segment path:
        # cap the walk so maxDepth counts total segments like vpl.cpp
        if settings.max_depth > 0:
            self.photon_depth = max(settings.max_depth - 2, 1)
        self.clamping = float(props.get("clamping", 0.1))
        self.vpl_chunk = int(props.get("vplChunk", 256))
        self.extent = float(scene.ray_eps) / 1e-4

    # -- VPL shading ----------------------------------------------------------
    def _shade_chunk(self, scene, vp, vpl, n_walks):
        """Contribution of one VPL chunk to every pixel: [N, 3]."""
        pos, flux, pdir, ok, ns_y, bsdf_y, uv_y = vpl
        N = vp["p"].shape[0]
        K = pos.shape[0]
        eps = scene.ray_eps

        to_k = pos[None, :, :] - vp["p"][:, None, :]      # [N, K, 3]
        r2 = torch.clamp_min(m.squared_length(to_k), 1e-12)
        r = torch.sqrt(r2)
        dirs = to_k / r[..., None]
        r2_clamped = torch.clamp_min(r2, (self.clamping * self.extent) ** 2)

        # camera-side eval: f_x * cos_x
        ssx, tsx = m.build_frame(vp["ns"])
        wi_x = m.to_local(vp["wi"], ssx, tsx, vp["ns"])
        wo_x = m.to_local(dirs, ssx[:, None], tsx[:, None], vp["ns"][:, None])
        par_x = common.material_params(scene, self.has_textures,
                                       vp["bsdf"], vp["uv"])
        f_x = bsdf_ops.eval(broadcast_params(par_x, (N, K), 1),
                            wi_x[:, None].expand(N, K, 3), wo_x, self.kinds)

        # VPL-side eval: f_y * cos_y (incoming photon direction wi)
        ssy, tsy = m.build_frame(ns_y)
        wi_y = m.to_local(-pdir, ssy, tsy, ns_y)          # [K, 3]
        wo_y = m.to_local(-dirs, ssy[None], tsy[None], ns_y[None])
        par_y = common.material_params(scene, self.has_textures, bsdf_y,
                                       uv_y)
        f_y = bsdf_ops.eval(broadcast_params(par_y, (N, K), 0),
                            wi_y[None].expand(N, K, 3), wo_y, self.kinds)

        # one shadow-ray batch for the whole [N, K] block; both endpoints
        # lie on geometry, so the origin offsets along x's geometric
        # normal and tmax stops short of the VPL's surface by the eps/cos
        # rule of the path tracer's NEE rays
        o_sh = common.offset_ray_origin(vp["p"][:, None, :],
                                        vp["ng"][:, None, :], dirs, eps)
        tmax = r - 2.0 * eps / torch.clamp_min(
            torch.abs(torch.sum(dirs * ns_y[None], -1)), 1e-3)
        occ = self.occluded(o_sh.reshape(-1, 3), dirs.reshape(-1, 3),
                            torch.zeros(N * K, device=self.device),
                            tmax.reshape(-1), scene.geom)
        vis = (~occ).reshape(N, K)

        w = ok[None, :] & vp["valid"][:, None] & vis
        contrib = f_x * f_y * (flux[None] / r2_clamped[..., None])
        contrib = torch.where(_b3(w), contrib, 0.0)
        return torch.sum(contrib, dim=1) / n_walks

    def _direct_nee(self, scene, seed, pass_idx, pixel_id, vp):
        """One NEE sample at the visible point."""
        u_sel = self._u1(seed, pixel_id, pass_idx, VPL_NEE_DIM)
        u_pos = self._u2(seed, pixel_id, pass_idx, VPL_NEE_DIM + 1)
        ds = em_ops.sample_direct(scene, self.n_area, self.env_kind,
                                  vp["p"], u_sel, u_pos, n_delta=self.n_delta)
        eps = scene.ray_eps
        ss, ts = m.build_frame(vp["ns"])
        wi = m.to_local(vp["wi"], ss, ts, vp["ns"])
        wo = m.to_local(ds.d, ss, ts, vp["ns"])
        par = common.material_params(scene, self.has_textures, vp["bsdf"],
                                     vp["uv"])
        f = bsdf_ops.eval(par, wi, wo, self.kinds)
        shadow_o = common.offset_ray_origin(vp["p"], vp["ng"], ds.d, eps)
        occ = self.occluded(
            shadow_o, ds.d, torch.zeros(ds.dist.shape, device=self.device),
            ds.dist - 2.0 * eps / torch.clamp_min(
                torch.abs(m.dot(ds.d, ds.n)), 1e-3),
            scene.geom)
        good = vp["valid"] & ds.valid & ~occ & (ds.pdf > 0)
        L = f * ds.radiance / _b3(torch.clamp_min(ds.pdf, 1e-12))
        return torch.where(_b3(good), L, 0.0)

    def _one_pass(self, scene, seed, pass_idx, vpl_table):
        st = self.settings
        pixel_id = torch.arange(st.width * st.height, dtype=torch.int64,
                                device=self.device)
        pos_film, L_chain, vp = self._visible_points(scene, seed, pass_idx,
                                                     pixel_id)
        L = L_chain + self._direct_nee(scene, seed, pass_idx, pixel_id,
                                       vp) * vp["tp"]
        K = self.vpl_chunk
        for c in range(vpl_table[0].shape[0] // K):
            chunk = tuple(a[c * K:(c + 1) * K] for a in vpl_table)
            L = L + vp["tp"] * self._shade_chunk(scene, vp, chunk,
                                                 self.n_photons)
        return self._splat(pos_film, L)

    def _gen_vpls(self, scene, seed):
        """Photon walk deposits + each deposit's surface frame and
        material, recovered by re-intersecting along the incoming
        direction from just before the deposit."""
        ph_pos, ph_pow, ph_dir, ph_ok = self._emit_photons(scene, seed, 0)
        o = ph_pos - ph_dir * scene.ray_eps * 20.0
        Nf = ph_pos.shape[0]
        hit = self.closest(o, ph_dir, torch.zeros(Nf, device=self.device),
                           torch.where(ph_ok, 3e38, -1.0), scene.geom)
        its = common.fill_intersection(scene, o, ph_dir, hit)
        ok = ph_ok & its.valid
        return (its.p, ph_pow, ph_dir, ok, its.ns,
                torch.clamp_min(its.bsdf_id, 0), its.uv)

    def render(self, scene, seed=0, spp=None, progress=None, **_):
        """spp passes, each: one camera sample a pixel, NEE, and every
        VPL.  Returns the image [H, W, 3] on the device."""
        spp = spp or self.settings.spp
        vpl_table = self._vpl_table(scene, seed)
        return self._accumulate(spp, progress, lambda i: self._one_pass(
            scene, seed, i, vpl_table))

    def _vpl_table(self, scene, seed):
        """The render's VPLs, padded with zero rows to whole chunks."""
        vpl_table = self._gen_vpls(scene, seed ^ 0x7f1)
        V = int(vpl_table[0].shape[0])
        K = self.vpl_chunk
        pad = max(1, -(-V // K)) * K - V
        if pad:
            vpl_table = tuple(
                torch.cat([a, torch.zeros((pad,) + a.shape[1:],
                                          dtype=a.dtype, device=a.device)])
                for a in vpl_table)
        return vpl_table


def render(scene, settings, seed=0, spp=None):
    return VPLTracer(scene, settings).render(scene, seed=seed, spp=spp)
