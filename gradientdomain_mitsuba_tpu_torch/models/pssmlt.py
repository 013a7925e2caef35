"""Primary-sample-space Metropolis light transport (Kelemen et al. 2002).

Counterpart of gradientdomain_mitsuba_tpu/models/pssmlt.py (the `pssmlt`
integrator, src/integrators/pssmlt/pssmlt.cpp + libbidir's PathSampler
in unidirectional mode): thousands of independent chains run in lockstep
as one wavefront, each chain's state an explicit vector of primary
samples u in [0,1)^D.  The path tracer reads u directly (its sampler
closures index the chain's PSS vector), so models/path.py is the
contribution function f(u).

Estimator (Kelemen): chains equilibrate to pi(u) = I(u)/b with
I = luminance(f) and b = E_uniform[I] (bootstrap estimate); every
mutation splats (1-a) b f(x)/I(x) at x and a b f(y)/I(y) at y through
the deterministic scatter, and the image is the splat sum times
W H / mutations.  Two-stage seeding (the bootstrap's candidates
resampled by I) as in the reference.

The reference's fori_loop over mutations is a Python loop here; the
chain state, the acceptance test and b stay on the device, and b is read
once, at the end of a render (last_b).
"""
from __future__ import annotations

import math

import torch

from ..core.math import exp_f32
from ..core.rng import DimAllocator as DA
from ..core.rng import mod1, uniform_float
from ..core.spectrum import luminance
from ..ops import film as film_ops
from ..ops import sensor as sensor_ops
from .path import PathTracer

# Kelemen small-step kernel bounds (pssmlt.cpp defaults)
S1 = 1.0 / 1024.0
S2 = 1.0 / 64.0
# log(S2 / S1) as the reference forms it (float32)
_LOG_S2_S1 = float(torch.tensor(math.log(S2 / S1), dtype=torch.float32))
def cumsum_f32(x, block=16):
    """Inclusive prefix sum of a 1-D float32 tensor in the association
    order of jnp.cumsum on XLA's CPU backend: sequential float32 sums
    within blocks of 16, the block totals scanned the same way and added
    in front.  The resampling thresholds compare against these sums, so
    the order decides the picked indices (torch.cumsum accumulates
    differently)."""
    n = x.shape[0]
    nb = -(-n // block)
    xb = torch.nn.functional.pad(x, (0, nb * block - n)).reshape(nb, block)
    cols = [xb[:, 0]]
    for j in range(1, block):
        cols.append(cols[-1] + xb[:, j])
    within = torch.stack(cols, 1)
    if nb > 1:
        head = cumsum_f32(within[:, -1], block)[:-1]
        within = torch.cat([within[:1], head[:, None] + within[1:]])
    return within.reshape(-1)[:n]


def _pss_u1(pss, pixel_id, sample_idx, dim):
    del pixel_id, sample_idx
    return pss[:, dim]


def _pss_u2(pss, pixel_id, sample_idx, dim):
    del pixel_id, sample_idx
    return pss[:, dim:dim + 2]


def kelemen_step(seed, it, u, n_dims):
    """The signed Kelemen exponential small step [C, D] of every
    coordinate: uniforms from the counter RNG at (chain, iteration,
    dim), as in the reference."""
    C = u.shape[0]
    dev = u.device
    ids = torch.arange(C, dtype=torch.int64, device=dev)[:, None]
    dims = torch.arange(n_dims, dtype=torch.int64, device=dev)[None, :]
    r = uniform_float(seed ^ 0x5bd1, ids, it, 2048 + dims)
    s = uniform_float(seed ^ 0x9e37, ids, it, 4096 + dims)
    mag = S2 * exp_f32(-_LOG_S2_S1 * r)
    return torch.where(s < 0.5, mag, -mag)


def fresh_states(seed, it, C, n_dims, device):
    """Uniform PSS vectors [C, D] from the counter RNG (chain, iter,
    dim), one broadcast draw."""
    ids = torch.arange(C, dtype=torch.int64, device=device)[:, None]
    dims = torch.arange(n_dims, dtype=torch.int64, device=device)[None, :]
    return uniform_float(seed, ids, it, dims)


def resample_states(seed, jitter_idx, cand_u, cand_I):
    """Systematic resampling of C candidate states by I (two-stage
    seeding): the cdf of I, C stratified thresholds with one jitter from
    the counter RNG, a left-side search."""
    C = cand_u.shape[0]
    dev = cand_u.device
    cdf = cumsum_f32(cand_I)
    cdf = cdf / torch.clamp_min(cdf[-1], 1e-30)
    jitter = uniform_float(seed ^ 0x5eed, torch.zeros(1, dtype=torch.int64,
                                                      device=dev),
                           jitter_idx, 0)[0]
    picks = torch.searchsorted(
        cdf, (torch.arange(C, device=dev) + jitter) / C)
    return torch.clamp(picks, 0, C - 1)


def kelemen_weights(I, Iy, b):
    """Acceptance probability a and the expected-value splat weights of
    the current state x and the proposal y."""
    a = torch.clamp(Iy / torch.clamp_min(I, 1e-30), 0.0, 1.0)
    wx = (1.0 - a) * b / torch.clamp_min(I, 1e-30)
    wy = a * b / torch.clamp_min(Iy, 1e-30)
    return a, wx, wy


class _PSSPathTracer(PathTracer):
    """PathTracer whose random stream is an explicit PSS tensor passed
    through the `seed` slot of trace_rays."""

    def __init__(self, scene, settings):
        super().__init__(scene, settings, samplers=(_pss_u1, _pss_u2))


class ChainTracer:
    """What the parallel-chain tracers share (PSSMLT, ERPT, MLT): the
    chain count and bootstrap size, fresh states, the two-stage
    bootstrap, the large-or-small proposal and the mutation loop.  A
    subclass gives _eval (its last output the importance I [C]),
    _mutate_small and _mstep."""

    def __init__(self, settings, inner, n_dims, default_chains):
        self.settings = settings
        self.inner = inner
        self.device = inner.device
        self.kernels = inner.kernels
        props = settings.integrator_props
        self.p_large = float(props.get("pLarge", 0.3))
        self.n_chains = int(props.get("chains", default_chains))
        self.n_bootstrap = int(props.get("luminanceSamples",
                                         4 * self.n_chains))
        self.n_dims = n_dims
        self.last_b = None

    def _fresh(self, seed, it, C):
        return fresh_states(seed, it, C, self.n_dims, self.device)

    def _propose(self, seed, it, u, ids):
        """A large step (fresh states) with probability pLarge, else a
        small step, per chain."""
        large = uniform_float(seed ^ 0x1a56e, ids, it, 0) < self.p_large
        return torch.where(large[:, None], self._fresh(seed, it, u.shape[0]),
                           self._mutate_small(seed, it, u))

    def _bootstrap(self, scene, seed):
        """Normalization b (mean I over luminanceSamples fresh states) and
        the resampled initial chain states with their evaluations."""
        C = self.n_chains
        rounds = max(1, self.n_bootstrap // C)
        # round 0's candidates seed the chains; later rounds only refine b
        cand_u = self._fresh(seed ^ 0xb00, 0, C)
        cand_I = self._eval(scene, cand_u)[-1]
        acc = torch.sum(cand_I)
        for i in range(rounds - 1):
            acc = acc + torch.sum(
                self._eval(scene, self._fresh(seed ^ 0xb00, i + 1, C))[-1])
        b = acc / (rounds * C)
        u0 = cand_u[resample_states(seed, 0, cand_u, cand_I)]
        return b, (u0,) + self._eval(scene, u0)

    def _run(self, scene, seed, n_iters):
        st = self.settings
        b, state = self._bootstrap(scene, seed)
        fb = torch.zeros((st.height, st.width, 3), device=self.device)
        for it in range(n_iters):
            state, fb = self._mstep(scene, seed, it, state, b, fb)
        scale = (st.width * st.height) / max(float(n_iters * self.n_chains),
                                             1.0)
        return fb * scale, b

    def n_iterations(self, spp):
        st = self.settings
        return max(1, (st.width * st.height * spp) // self.n_chains)

    def render(self, scene, seed=0, spp=None, **_):
        """spp is interpreted as average mutations per pixel (the
        reference's equal-sample accounting).  Returns the image
        [H, W, 3] on the device; last_b holds b (one host read)."""
        spp = spp or self.settings.spp
        img, b = self._run(scene, seed, self.n_iterations(spp))
        self.last_b = float(b)
        return img


class PSSMLTracer(ChainTracer):
    """Parallel-chain PSSMLT.  settings.integrator_props honors `pLarge`
    (large-step probability, default 0.3), `chains` (default 8192),
    `luminanceSamples` (bootstrap size, default 4x chains)."""

    def __init__(self, scene, settings):
        inner = _PSSPathTracer(scene, settings)
        super().__init__(settings, inner, DA.NUM_CAMERA_DIMS +
                         inner.n_bounces * DA.NUM_BOUNCE_DIMS, 8192)

    # -- f(u): trace one path per chain ------------------------------------
    def _eval(self, scene, u):
        """(film positions [C,2], radiance [C,3], luminance [C]) of the
        chains' states."""
        st = self.settings
        C = u.shape[0]
        pos_film = torch.stack([u[:, 0] * st.width, u[:, 1] * st.height],
                               -1)
        o, d = sensor_ops.sample_ray(self.inner.sensor, st.width, st.height,
                                     pos_film, u[:, 2:4])
        ids = torch.arange(C, dtype=torch.int64, device=u.device)
        L = self.inner.trace_rays(scene, u, 0, ids, o, d)
        L = torch.nan_to_num(L, nan=0.0, posinf=0.0, neginf=0.0)
        return pos_film, L, luminance(L)

    def _mutate_small(self, seed, it, u):
        """Kelemen exponential small step, wrapped to [0,1)."""
        return mod1(u + kelemen_step(seed, it, u, self.n_dims))

    def _mstep(self, scene, seed, it, state, b, fb):
        """One mutation of every chain: propose, splat both states,
        accept."""
        ids = torch.arange(state[0].shape[0], dtype=torch.int64,
                           device=self.device)
        uy = self._propose(seed, it, state[0], ids)
        return self._accept(seed, it, ids, state,
                            (uy,) + self._eval(scene, uy), b, fb)

    @staticmethod
    def _accept(seed, it, ids, state, prop, b, fb):
        """Splat the current state x and the proposal y with their
        expected-value weights, then take y where the counter RNG's
        uniform falls below a.  state / prop: (u, pos, L, I).  Returns the
        new state and film; the decision stays on the device."""
        u, pos, L, I = state
        uy, pos_y, Ly, Iy = prop
        a, wx, wy = kelemen_weights(I, Iy, b)
        fb = film_ops.splat_unfiltered(fb, pos, L * wx[:, None])
        fb = film_ops.splat_unfiltered(fb, pos_y, Ly * wy[:, None])
        take = uniform_float(seed ^ 0xacce97, ids, it, 1) < a
        t1 = take[:, None]
        return (torch.where(t1, uy, u), torch.where(t1, pos_y, pos),
                torch.where(t1, Ly, L), torch.where(take, Iy, I)), fb


def render(scene, settings, seed=0, spp=None):
    return PSSMLTracer(scene, settings).render(scene, seed=seed, spp=spp)
