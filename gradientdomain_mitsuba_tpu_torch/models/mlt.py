"""Metropolis light transport over the bidirectional path sampler.

Counterpart of gradientdomain_mitsuba_tpu/models/mlt.py (the `mlt`
integrator, src/integrators/mlt/mlt.cpp + libbidir's PathSampler in
bidirectional mode): the target function is the full BDPT strategy
family f(u), every (s,t) connection including the light-traced t=1
splats, MIS-combined with the power heuristic, explored by thousands of
independent lockstep chains in primary sample space with the Kelemen
kernel:

  * a chain's state is a vector u in [0,1)^D that drives both subpath
    walks of models/bdpt.py (the sparse dim ids of the eye and light
    streams are remapped onto a dense [0, D) range), so BDPTracer is the
    contribution function;
  * a mutation perturbs a fixed coordinate subset (small step) or
    redraws u (large step); acceptance uses the scalar importance
    I(u) = lum(L_eye(u)) + sum_s lum(splat_s(u)) over all light-image
    splats, and every component is deposited at its own film position
    with the Kelemen expected-value weights.

Two-stage bootstrap (resampled seeding + luminance normalization b) as
in pssmlt.py.  The reference's fori_loop over mutations is a Python
loop; the state and the acceptance tests stay on the device, b is read
once at the end (last_b).
"""
from __future__ import annotations

import torch

from ..core.rng import DimAllocator as DA
from ..core.rng import mod1, uniform_float
from ..core.spectrum import luminance
from ..ops import film as film_ops
from .bdpt import LIGHT_DIM_BASE, BDPTracer
from .pssmlt import ChainTracer, kelemen_step, kelemen_weights


class _PSSBDPTracer(BDPTracer):
    """BDPTracer whose random streams read an explicit PSS tensor.

    The `seed` slot of trace_pass carries a [C, D] tensor of primary
    samples; `_u1` / `_u2` remap the integrator's sparse dim ids (eye
    stream at 0.., light stream at LIGHT_DIM_BASE..) onto dense columns.
    The pixel-jitter draw is rescaled to span the whole film, so the
    chain's film position is entirely PSS-driven (pixel_id is 0)."""

    def __init__(self, scene, settings):
        super().__init__(scene, settings)
        eye_span = DA.NUM_CAMERA_DIMS * (self.TE + 1)
        light_span = DA.NUM_BOUNCE_DIMS * (self.SM + 1)
        self.n_dims = eye_span + light_span
        self.eye_span = eye_span
        wh = torch.tensor([settings.width, settings.height],
                          dtype=torch.float32, device=self.device)

        def remap(dim):
            d = int(dim)
            if d < LIGHT_DIM_BASE:
                if d >= eye_span:
                    raise ValueError(f"eye dim {d} exceeds span {eye_span}")
                return d
            d = eye_span + (d - LIGHT_DIM_BASE)
            if d >= self.n_dims:
                raise ValueError(
                    f"light dim {dim} exceeds span {self.n_dims}")
            return d

        def u1(pss, pixel_id, sample_idx, dim):
            del pixel_id, sample_idx
            return pss[:, remap(dim)]

        def u2(pss, pixel_id, sample_idx, dim):
            del pixel_id, sample_idx
            i = remap(dim)
            u = pss[:, i:i + 2]
            if int(dim) == DA.PIXEL_JITTER:
                u = u * wh
            return u

        self._u1, self._u2 = u1, u2


class MLTracer(ChainTracer):
    """Parallel-chain path-space MLT.  settings.integrator_props honors
    `pLarge` (default 0.3), `chains` (default 4096), `luminanceSamples`
    (bootstrap size, default 4x chains)."""

    def __init__(self, scene, settings):
        inner = _PSSBDPTracer(scene, settings)
        super().__init__(settings, inner, inner.n_dims, 4096)
        self.eye_span = inner.eye_span

    # -- f(u): one full BDPT evaluation per chain ---------------------------
    def _eval(self, scene, u):
        """(eye film positions [C,2], eye radiance [C,3], light-image
        splat positions [K*C,2] and values [K*C,3], importance I [C])."""
        C = u.shape[0]
        pid = torch.zeros(C, dtype=torch.int64, device=u.device)
        pos, L, spos, sval = self.inner.trace_pass(scene, u, 0,
                                                   pixel_id=pid)
        L = torch.nan_to_num(L, nan=0.0, posinf=0.0, neginf=0.0)
        sval = torch.nan_to_num(sval, nan=0.0, posinf=0.0, neginf=0.0)
        K = sval.shape[0] // C if C else 0
        I = luminance(L)
        if K:
            I = I + luminance(sval).reshape(K, C).sum(0)
        return pos, L, spos, sval, I

    @staticmethod
    def _splat(fb, pos, L, spos, sval, w):
        """Deposit one state's full contribution set, scaled by w [C]."""
        fb = film_ops.splat_unfiltered(fb, pos, L * w[:, None])
        if sval.shape[0]:
            K = sval.shape[0] // w.shape[0]
            fb = film_ops.splat_unfiltered(fb, spos,
                                           sval * w.repeat(K)[:, None])
        return fb

    def _mutate_small(self, seed, it, u):
        """The reference's structured small-step family in primary sample
        space, a Kelemen step of a fixed coordinate subset chosen per
        chain by an independent coin:

          p=1/2  all coordinates (multi-chain perturbation analog);
          p=1/8  the eye subpath only (light subpath frozen);
          p=1/8  the light subpath only (caustic perturbation analog);
          p=1/8  the camera-sample block only (lens manifold);
          p=1/8  the light-origin block only (caustic manifold).

        Each restricted kernel acts on a fixed subset, so it is symmetric
        and the acceptance ratio is unchanged."""
        C = u.shape[0]
        dev = u.device
        ids = torch.arange(C, dtype=torch.int64, device=dev)
        dims = torch.arange(self.n_dims, dtype=torch.int64,
                            device=dev)[None, :]
        delta = kelemen_step(seed, it, u, self.n_dims)
        kind = uniform_float(seed ^ 0x7e45, ids, it, 6144)[:, None]
        is_eye = dims < self.eye_span
        is_lens = dims < DA.NUM_CAMERA_DIMS
        is_light_origin = (~is_eye) & (
            dims < self.eye_span + DA.NUM_BOUNCE_DIMS)
        keep = torch.where(
            kind < 0.5, True,
            torch.where(kind < 0.625, is_eye,
                        torch.where(kind < 0.75, ~is_eye,
                                    torch.where(kind < 0.875, is_lens,
                                                is_light_origin))))
        return mod1(u + torch.where(keep, delta, 0.0))

    def _mstep(self, scene, seed, it, state, b, fb):
        """One mutation of every chain: splat the current state and the
        proposal with their Kelemen weights, then accept.  state: (u,
        pos, L, spos, sval, I)."""
        u, pos, L, spos, sval, I = state
        C = u.shape[0]
        ids = torch.arange(C, dtype=torch.int64, device=u.device)
        uy = self._propose(seed, it, u, ids)
        pos_y, Ly, spos_y, sval_y, Iy = self._eval(scene, uy)

        a, wx, wy = kelemen_weights(I, Iy, b)
        fb = self._splat(fb, pos, L, spos, sval, wx)
        fb = self._splat(fb, pos_y, Ly, spos_y, sval_y, wy)

        take = uniform_float(seed ^ 0xacce97, ids, it, 1) < a
        t1 = take[:, None]
        tk = take.repeat(max(sval.shape[0] // C, 1))[:, None]
        if sval.shape[0]:
            spos = torch.where(tk, spos_y, spos)
            sval = torch.where(tk, sval_y, sval)
        return (torch.where(t1, uy, u), torch.where(t1, pos_y, pos),
                torch.where(t1, Ly, L), spos, sval,
                torch.where(take, Iy, I)), fb


def render(scene, settings, seed=0, spp=None):
    return MLTracer(scene, settings).render(scene, seed=seed, spp=spp)
