"""The path tracer's shading wavefront as one launch a bounce.

No counterpart in the reference: its bounce (models/path.py _bounce) is
jnp code that XLA fuses, with no Pallas kernel behind it.  The port's
eager bounce runs about a thousand launches, each over whole lane
arrays; csrc/shade.cu does the bounce of the scenes this module admits
(fused_scene, which ops/gpt_shade.py shares: diffuse rows, no textures,
the 29-column tri_shade, no spheres, area lights only, the independent
sampler) in one pass over the lanes (see the note there for the design).

A launch b takes the closest hits of bounce b's rays and the answers of
bounce b-1's shadow rays, adds bounce b-1's NEE where its shadow ray was
clear, shades the hits, and writes bounce b's shadow rays and next rays
into the buffers the tracer's any-hit and closest-hit calls take (the
pending NEE waits in the lane state for its answer).  A last launch
(final=True) adds the last NEE and the emission at the last hit.

A CPU tensor runs the plain version (PathShade.plain: state in, state
out, built from the ops/ functions the eager bounce calls, so it is the
eager bounce's arithmetic); a CUDA tensor launches the kernel or raises.
The kernel is compiled with nvcc at first use (sm_90a, -fmad=false,
plain C interface, bound with ctypes) into the package's git-ignored
_build/ directory.
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
from ..core.rng import DimAllocator as DA
from ..core.rng import uniform_2d, uniform_float
from ..scene.materials import DIFFUSE
from . import bsdf as bsdf_ops
from . import common
from . import emitter as em_ops

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "shade.cu")

SHADE_COLUMNS = 29        # tri_shade without the barycentric payload
KINDS = frozenset({DIFFUSE})
FIRST, FINAL, DIRECT = 1, 2, 4   # the kernel's flags
MASK = 0xFFFFFFFF


class ShadeState(NamedTuple):
    """The lanes between launches: the next rays (o, d, maxt) for the
    closest-hit call, the shadow rays for the any-hit call, and what the
    eager bounce carries from one bounce to the next, with `pending` the
    NEE contribution (zero where NEE was not possible) that waits for its
    shadow ray's answer."""
    o: torch.Tensor            # [N, 3]
    d: torch.Tensor            # [N, 3]
    maxt: torch.Tensor         # [N] 3e38 live, -1 dead
    shadow_o: torch.Tensor     # [N, 3]
    shadow_d: torch.Tensor     # [N, 3]
    shadow_maxt: torch.Tensor  # [N]
    L: torch.Tensor            # [N, 3]
    tp: torch.Tensor           # [N, 3]
    eta: torch.Tensor          # [N]
    last_pdf: torch.Tensor     # [N]
    alive: torch.Tensor        # [N] bool
    last_delta: torch.Tensor   # [N] bool
    pending: torch.Tensor      # [N, 3]


_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float


class _Args(ctypes.Structure):
    """csrc/shade.cu ShadeArgs, field for field."""
    _fields_ = [(n, _P) for n in (
        "hit_t", "hit_u", "hit_v", "hit_prim", "hit_valid", "occl",
        "ray_o_in", "ray_d_in", "seed", "pixel", "sample", "tri_shade",
        "mat", "em_offset", "em_count", "em_cdf", "em_geo", "em_area",
        "em_radiance", "eps", "ray_o", "ray_d", "ray_maxt", "shadow_o",
        "shadow_d", "shadow_maxt", "L", "tp", "eta", "last_pdf", "alive",
        "last_delta", "pending")] + [(n, _I) for n in (
            "n", "n_tri", "shade_cols", "n_mat", "mat_cols", "n_area",
            "cdf_len", "cdf_iters", "bounce", "max_depth", "rr_depth",
            "flags", "seed_stride", "pixel_stride", "sample_stride")] + [
        (n, _U) for n in ("seed_value", "pixel_value", "sample_value")] + [
        (n, _F) for n in ("n_total", "pick_pdf", "inv_n_total")]


def load_library():
    """Build (first call only) and load the shading kernel's library,
    each float operation rounded on its own (-fmad=false) as the eager
    ops round it; raises if its argument struct and _Args disagree in
    size."""
    lib = native.load_cuda("shade", _SRC, {
        "path_bounce": [_P, _P], "path_bounce_args_size": []},
        flags=("-fmad=false",))
    size = lib.path_bounce_args_size()
    if size != ctypes.sizeof(_Args):
        raise RuntimeError(f"csrc/shade.cu ShadeArgs is {size} bytes, "
                           f"ops/shade.py _Args {ctypes.sizeof(_Args)}")
    return lib


def fused_scene(tracer, scene):
    """Whether the fused shading kernels shade this scene as the eager
    bounces do: only diffuse rows (no mask or coating pseudo-kind), no
    textures and no bump / normal map columns, the 29-column tri_shade
    (no barycentric payload) and no analytic spheres, area lights only
    (at least one, no delta light, no environment), and the independent
    sampler's draws (uniform_float / uniform_2d), so not draws passed in
    as samplers (pssmlt's).  `tracer` is a PathTracer or a GPTracer: its
    kinds, has_textures, n_area, n_delta, has_env, _u1 and _u2."""
    g = scene.geom
    return (tracer.kinds == {bsdf_ops.DIFFUSE} and not tracer.has_textures
            and scene.materials.packed.shape[1] < 32
            and g.tri_shade.shape[1] == SHADE_COLUMNS
            and g.sph_center.shape[0] == 0
            and tracer.n_area >= 1 and tracer.n_delta == 0
            and not tracer.has_env
            and (tracer._u1, tracer._u2) == (uniform_float, uniform_2d))


def _counter(x, n, dev):
    """One RNG counter as the kernel reads it: (int64 tensor or None,
    stride, uint32 value).  A Python int is a scalar; a tensor is read
    per lane, or at stride 0 when it holds one value."""
    if not torch.is_tensor(x):
        return None, 0, int(x) & MASK
    if x.device != dev:
        raise ValueError(f"an RNG counter is on {x.device}, not {dev}")
    if x.dtype.is_floating_point or x.dtype == torch.bool:
        raise TypeError(f"an RNG counter must be an integer, got {x.dtype}")
    x = x.to(torch.int64)
    if x.numel() == 1:
        return x.reshape(()), 0, 0
    return x.expand(n).contiguous(), 1, 0


def _check(name, x, shape, dtype, dev):
    if x.device != dev:
        raise ValueError(f"{name} is on {x.device}, not {dev}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


class PathShade:
    """The bounce of PathTracer on the scenes it admits, with its launch
    count: __call__(scene, hit, b, rng, st, occl, ray, direct, final).

    hit: the closest hits of the rays st.o / st.d (of `ray` on the first
    launch, st=None, which also starts the lane state with
    direct_at_first = `direct`); occl: the answers to st's shadow rays;
    rng: the counters (seed, pixel_id, sample_idx).  Returns the lanes'
    ShadeState (the kernel's buffers, updated in place).  `launches`
    counts kernel launches only: a CPU call runs the plain version."""

    def __init__(self, n_area, settings):
        self.n_area = int(n_area)
        self.max_depth = int(settings.max_depth)
        self.rr_depth = int(settings.rr_depth)
        self.launches = 0

    def __call__(self, scene, hit, b, rng, st=None, occl=None, ray=None,
                 direct=True, final=False):
        o = ray[0] if st is None else st.o
        if o.device.type == "cpu":
            return self.plain(scene, hit, b, rng, st, occl, ray, direct,
                              final)
        if o.device.type != "cuda":
            raise ValueError(f"no shading kernel for device {o.device}")
        return self._launch(scene, hit, b, rng, st, occl, ray, direct, final)

    def plain(self, scene, hit, b, rng, st=None, occl=None, ray=None,
              direct=True, final=False):
        """The bounce as models/path.py _bounce computes it, state in,
        state out."""
        seed, pixel_id, sample_idx = rng
        if st is None:
            o, d = ray
            N = o.shape[0]
            dev = o.device
            L = torch.zeros((N, 3), device=dev)
            tp = torch.ones((N, 3), device=dev)
            eta = torch.ones(N, device=dev)
            alive = torch.ones(N, dtype=torch.bool, device=dev)
            last_pdf = torch.zeros(N, device=dev)
            last_delta = torch.full((N,), bool(direct), device=dev)
        else:
            o, d = st.o, st.d
            L = st.L + torch.where((~occl)[..., None], st.pending, 0.0)
            tp, eta, alive = st.tp, st.eta, st.alive
            last_pdf, last_delta = st.last_pdf, st.last_delta
        its = common.fill_intersection(scene, o, d, hit)
        L = L + em_ops.area_emission(scene, self.n_area, False, 0, its, o, d,
                                     alive, tp, last_pdf, last_delta)
        if final:
            keep = st if st is not None else ShadeState(*[None] * 13)
            return keep._replace(L=L)

        depth = b + 1
        eps = scene.ray_eps
        alive = alive & its.valid
        if self.max_depth > 0:
            alive = alive & (depth < self.max_depth)
        ss, ts = m.build_frame(its.ns)
        wi = m.to_local(-d, ss, ts, its.ns)
        params = common.material_params(scene, 0, its.bsdf_id, its.uv)
        dim = functools.partial(DA.bounce_dim, b)

        # NEE toward one area light
        u_sel = uniform_float(seed, pixel_id, sample_idx,
                              dim(DA.D_LIGHT_SELECT))
        u_pos = uniform_2d(seed, pixel_id, sample_idx, dim(DA.D_LIGHT_UV))
        ds = em_ops.sample_direct(scene, self.n_area, em_ops.ENV_NONE, its.p,
                                  u_sel, u_pos)
        nee_possible = alive & ds.valid & (ds.pdf > 0)
        shadow_o = common.offset_ray_origin(its.p, its.ng, ds.d, eps)
        shadow_maxt = ds.dist - 2.0 * eps / torch.clamp_min(
            torch.abs(m.dot(ds.d, ds.n)), 1e-3)
        wo_l = m.to_local(ds.d, ss, ts, its.ns)
        f_l = bsdf_ops.eval(params, wi, wo_l, kinds=KINDS)
        pdf_b = bsdf_ops.pdf(params, wi, wo_l, kinds=KINDS)
        w_nee = torch.where(ds.is_delta, 1.0, em_ops.mis_weight(ds.pdf,
                                                                pdf_b))
        contrib = (tp * f_l * ds.radiance *
                   (w_nee / torch.clamp_min(ds.pdf, 1e-30))[..., None])
        pending = torch.where(nee_possible[..., None], contrib, 0.0)

        # BSDF sampling
        u2 = uniform_2d(seed, pixel_id, sample_idx, dim(DA.D_BSDF_UV))
        uc = uniform_float(seed, pixel_id, sample_idx,
                           dim(DA.D_BSDF_COMPONENT))
        bs = bsdf_ops.sample(params, wi, u2, uc, kinds=KINDS)
        alive = alive & bs.valid
        tp = torch.where(alive[..., None], tp * bs.weight, tp)
        eta = torch.where(alive, eta * bs.eta, eta)
        wo_world = m.to_world(bs.wo, ss, ts, its.ns)
        o_new = common.offset_ray_origin(its.p, its.ng, wo_world, eps)

        # Russian roulette
        u_rr = uniform_float(seed, pixel_id, sample_idx, dim(DA.D_RR))
        q = torch.clamp_max(tp.amax(-1) * eta * eta, 0.95)
        if depth >= self.rr_depth:
            tp = torch.where(alive[..., None],
                             tp / torch.clamp_min(q, 1e-9)[..., None], tp)
            alive = alive & (u_rr < q)
        alive = alive & (tp.amax(-1) > 0)
        return ShadeState(
            o=o_new, d=wo_world, maxt=torch.where(alive, 3e38, -1.0),
            shadow_o=shadow_o, shadow_d=ds.d, shadow_maxt=shadow_maxt,
            L=L, tp=tp, eta=eta, last_pdf=bs.pdf, alive=alive,
            last_delta=bs.is_delta, pending=pending)

    def _launch(self, scene, hit, b, rng, st, occl, ray, direct, final):
        """One kernel launch on CUDA tensors; validates every pointer it
        passes."""
        f32 = torch.float32
        dev = ray[0].device if st is None else st.o.device
        if st is None:
            o_in, d_in = ray
            N = o_in.shape[0]
            o_in, d_in = o_in.contiguous(), d_in.contiguous()

            def empty(*shape, dtype=f32):
                return torch.empty(shape, dtype=dtype, device=dev)
            st = ShadeState(
                o=empty(N, 3), d=empty(N, 3), maxt=empty(N),
                shadow_o=empty(N, 3), shadow_d=empty(N, 3),
                shadow_maxt=empty(N), L=empty(N, 3), tp=empty(N, 3),
                eta=empty(N), last_pdf=empty(N),
                alive=empty(N, dtype=torch.bool),
                last_delta=empty(N, dtype=torch.bool), pending=empty(N, 3))
            occl_ptr = None
        else:
            o_in, d_in = st.o, st.d
            N = o_in.shape[0]
            _check("occl", occl, (N,), torch.bool, dev)
            occl_ptr = occl.data_ptr()
        if N >= 2 ** 31:
            raise ValueError(f"{N} lanes exceed the kernel's int32 index")
        g, em, mat = scene.geom, scene.emitters, scene.materials.packed
        T, E, C = g.tri_shade.shape[0], em.total_area.shape[0], \
            em.tri_cdf.shape[0]
        if g.tri_shade.shape[1] != SHADE_COLUMNS:
            raise ValueError(f"tri_shade has {g.tri_shade.shape[1]} columns, "
                             f"the kernel reads {SHADE_COLUMNS}")
        if not 1 <= self.n_area <= E:
            raise ValueError(f"{self.n_area} area lights of {E} emitters")
        for name, x, shape, dtype in (
                ("o", o_in, (N, 3), f32), ("d", d_in, (N, 3), f32),
                ("hit.t", hit.t, (N,), f32), ("hit.u", hit.u, (N,), f32),
                ("hit.v", hit.v, (N,), f32),
                ("hit.prim", hit.prim, (N,), torch.int32),
                ("hit.valid", hit.valid, (N,), torch.bool),
                ("tri_shade", g.tri_shade, (T, SHADE_COLUMNS), f32),
                ("materials", mat, tuple(mat.shape), f32),
                ("tri_offset", em.tri_offset, (E,), torch.int32),
                ("tri_count", em.tri_count, (E,), torch.int32),
                ("tri_cdf", em.tri_cdf, (C,), f32),
                ("tri_geo", em.tri_geo, (C, 12), f32),
                ("total_area", em.total_area, (E,), f32),
                ("radiance", em.radiance, (E, 3), f32),
                ("ray_eps", scene.ray_eps, (), f32)):
            _check(name, x, shape, dtype, dev)
        counters = [_counter(x, N, dev) for x in rng]
        n_total = np.float32(self.n_area)
        args = _Args(
            *(x.data_ptr() for x in (hit.t, hit.u, hit.v, hit.prim,
                                     hit.valid)),
            occl_ptr, o_in.data_ptr(), d_in.data_ptr(),
            *(None if c[0] is None else c[0].data_ptr() for c in counters),
            *(x.data_ptr() for x in (
                g.tri_shade, mat, em.tri_offset, em.tri_count, em.tri_cdf,
                em.tri_geo, em.total_area, em.radiance, scene.ray_eps)),
            *(x.data_ptr() for x in st),
            N, T, SHADE_COLUMNS, mat.shape[0], mat.shape[1], self.n_area, C,
            em_ops.search_iters(C), b, self.max_depth, self.rr_depth,
            (FIRST if occl_ptr is None else 0) | (FINAL if final else 0) |
            (DIRECT if direct else 0),
            *(c[1] for c in counters), *(c[2] for c in counters),
            float(n_total), float(np.float32(1.0 / self.n_area)),
            float(np.float32(1.0) / n_total))
        lib = load_library()
        with torch.cuda.device(dev):
            err = lib.path_bounce(ctypes.addressof(args),
                                  torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"path_bounce launch failed: CUDA error {err}")
        self.launches += 1
        return st
