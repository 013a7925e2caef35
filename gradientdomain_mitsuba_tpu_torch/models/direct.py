"""`direct`, `ao` and `field` integrators.

Counterpart of gradientdomain_mitsuba_tpu/models/direct.py:
src/integrators/direct/direct.cpp (direct illumination with light/BSDF
MIS: semantically `path` truncated to maxDepth 2),
src/integrators/misc/ao.cpp (ambient occlusion with cosine-weighted
visibility probes) and src/integrators/misc/field.cpp (a geometric field
of the first visible surface as an RGB image).  AO and field are their
own one-segment wavefronts; their eye images are grid-aligned, so they
accumulate through the dense film adds (ops/film.splat_grid), the same
function as the reference's scatter splat up to summation order.
"""
from __future__ import annotations

import copy

import torch

from ..config import configure
from ..core import math as m
from ..core import warp
from ..core.rng import DimAllocator as DA
from ..core.rng import make_sampler
from ..ops import common, film as film_ops
from ..ops import sensor as sensor_ops
from .path import PathTracer


class DirectIntegrator(PathTracer):
    """Direct illumination: the path tracer with maxDepth forced to 2
    (emitter visibility + one light/BSDF MIS bounce — direct.cpp), on a
    deep copy of the settings."""

    def __init__(self, scene, settings):
        settings = copy.deepcopy(settings)
        settings.max_depth = 2
        super().__init__(scene, settings)


class _FirstHitIntegrator:
    """Shared frame of the AO and field wavefronts: one camera ray per
    pixel sample, its closest hit, a grid-aligned eye image."""

    def __init__(self, scene, settings):
        configure()
        sensor_ops.check_supported(scene.camera)
        self.settings = settings
        self.device = scene.geom.linC.device
        n_tris = int(scene.geom.indices.shape[0])
        self.closest, self.occluded = common.choose_intersector(
            settings, n_tris, int(scene.geom.clusters.offset.shape[0]))
        # the kernels this integrator launches (their .launches count)
        self.kernels = (self.closest.kernel, self.occluded.kernel)
        self.filter_kind = film_ops.FILTERS.get(settings.rfilter, 0)
        self._u1, self._u2 = make_sampler(settings.sampler, settings.spp)

    def _first_hit(self, scene, seed, sample_idx, pixel_id):
        st = self.settings
        W, H = st.width, st.height
        if pixel_id is None:
            pixel_id = torch.arange(W * H, dtype=torch.int64,
                                    device=self.device)
        N = pixel_id.shape[0]
        px = (pixel_id % W).to(torch.float32)
        py = (pixel_id // W).to(torch.float32)
        jitter = self._u2(seed, pixel_id, sample_idx, DA.PIXEL_JITTER)
        pos_film = torch.stack([px, py], -1) + jitter
        u_ap = self._u2(seed, pixel_id, sample_idx, DA.APERTURE)
        o, d = sensor_ops.sample_ray(scene.camera, W, H, pos_film, u_ap)
        hit = self.closest(o, d, torch.zeros(N, device=self.device),
                           torch.full((N,), 3e38, device=self.device),
                           scene.geom)
        its = common.fill_intersection(scene, o, d, hit)
        return pixel_id, pos_film, d, its

    def render_chunk(self, scene, seed, sample_start, n_samples):
        """(film [H,W,3], weights [H,W]) of n_samples samples per pixel
        from sample index sample_start, one sample per pixel a pass."""
        st = self.settings
        fb = torch.zeros((st.height, st.width, 3), device=self.device)
        wb = torch.zeros((st.height, st.width), device=self.device)
        for i in range(n_samples):
            pos, L = self.trace_pass(scene, seed, sample_start + i)
            fb, wb = film_ops.splat_grid(fb, wb, (pos % 1.0)[None], L[None],
                                         self.filter_kind)
        return fb, wb

    def finalize(self, state, spp):
        return film_ops.develop(state["0"], state["1"])

    def render(self, scene, seed=0, spp=None, chunk=64,
               checkpoint_path=None, resume=False, progress=None):
        from ..parallel.checkpoint import render_accumulate
        spp = spp or self.settings.spp
        state, spp = render_accumulate(
            self, scene, seed, spp, chunk,
            checkpoint_path=checkpoint_path, resume=resume,
            progress=progress)
        return self.finalize(state, spp)


class AOIntegrator(_FirstHitIntegrator):
    """Ambient occlusion (ao.cpp): cosine-weighted hemispheric visibility
    within rayLength (default: 1e4 * the scene's ray epsilon, a
    scene-scale probe)."""

    def __init__(self, scene, settings):
        super().__init__(scene, settings)
        self.ray_length = float(
            settings.integrator_props.get("rayLength", -1.0))

    def trace_pass(self, scene, seed, sample_idx, pixel_id=None):
        pixel_id, pos_film, d, its = self._first_hit(scene, seed,
                                                     sample_idx, pixel_id)
        N = pixel_id.shape[0]
        u2 = self._u2(seed, pixel_id, sample_idx,
                      DA.bounce_dim(0, DA.D_BSDF_UV))
        d_local = warp.square_to_cosine_hemisphere(u2)
        ss, ts = m.build_frame(its.ns)
        # probe on the visible side of the surface
        ns = its.ns * torch.sign(m.dot(its.ns, -d, keepdims=True))
        probe = m.to_world(d_local, ss, ts, ns)
        ones = torch.ones(N, device=self.device)
        if self.ray_length > 0:
            length = ones * self.ray_length
        else:
            length = ones * (1e4 * scene.ray_eps)
        sh_o = common.offset_ray_origin(its.p, its.ng, probe, scene.ray_eps)
        occ = self.occluded(sh_o, probe, torch.zeros(N, device=self.device),
                            length, scene.geom)
        vis = torch.where(its.valid & ~occ, 1.0, 0.0)
        return pos_film, vis[:, None].expand(N, 3)


FIELDS = ("position", "relPosition", "distance", "geoNormal", "shNormal",
          "uv", "albedo", "shapeIndex", "primIndex")


class FieldIntegrator(_FirstHitIntegrator):
    """AOV renderer (field.cpp): the `field` property in FIELDS of the
    first visible surface point as an RGB image (scalar fields broadcast,
    index fields 1-based like the reference, 0 on a miss)."""

    def __init__(self, scene, settings):
        super().__init__(scene, settings)
        self.field = str(settings.integrator_props.get("field", "distance"))
        if self.field not in FIELDS:
            raise ValueError(f"field integrator: unknown field "
                             f"'{self.field}'")
        self.has_textures = getattr(settings, "has_textures", 0)

    def trace_pass(self, scene, seed, sample_idx, pixel_id=None):
        pixel_id, pos_film, d, its = self._first_hit(scene, seed,
                                                     sample_idx, pixel_id)
        N = pixel_id.shape[0]
        f = self.field
        ok = its.valid[:, None]

        def v3(x):
            return torch.where(ok, x, 0.0)

        def index3(idx):
            return torch.where(its.valid, idx + 1, 0).to(
                torch.float32)[:, None].expand(N, 3)

        if f == "position":
            return pos_film, v3(its.p)
        if f == "relPosition":
            return pos_film, v3(its.p - scene.camera.to_world[:3, 3][None])
        if f == "distance":
            t = torch.where(its.valid, its.t, 0.0)
            return pos_film, v3(t[:, None].expand(N, 3))
        if f == "geoNormal":
            return pos_film, v3(its.ng)
        if f == "shNormal":
            return pos_film, v3(its.ns)
        if f == "uv":
            return pos_film, v3(torch.cat(
                [its.uv, torch.zeros((N, 1), device=self.device)], -1))
        if f == "albedo":
            par = common.material_params(scene, self.has_textures,
                                         its.bsdf_id, its.uv)
            return pos_film, v3(par.reflectance)
        if f == "shapeIndex":
            return pos_film, index3(its.shape_id)
        # primIndex: the original (pre-BVH) triangle id
        oid = scene.geom.tris.orig_id[
            torch.clamp_min(its.prim_id, 0).long()]
        return pos_film, index3(oid)
