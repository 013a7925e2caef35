"""Adaptive sampling wrapper (src/integrators/adaptive/adaptive.cpp).

Counterpart of gradientdomain_mitsuba_tpu/models/adaptive.py.  The
reference keeps sampling each pixel until a t-test bounds its error
below `maxError` relative to the scene's average luminance (or
`maxSampleFactor` is hit), by WAVEFRONT REFINEMENT: every round gathers
the K worst still-unconverged pixels into one fixed-size batch and
traces one more sample for each; per-lane sample indices keep the
counter RNG stream exactly where each pixel left off, so the result is
identical to having rendered each pixel with its final sample count.

The selection stays on the device: a stable sort by (-error, pixel id)
(torch.sort, stable), the first K, each pixel's count as its lane's
sample index.  The only host read per round is the "all converged" test.
Deviation: the reference's np.argsort(-err) is not stable, so where
errors tie at the K cut the two may refine different pixels in a round;
where K covers the film (films up to 256 pixels at the default
refineFraction) the order cannot change the result.

Child integrator: the wrapped <integrator> child (path/direct/ao); its
depth knobs are inherited at scene compile (scene.py), and the sampling
itself runs the path tracer, as in the reference.
"""
from __future__ import annotations

import torch

from .path import PathTracer

LUM_W = (0.2126, 0.7152, 0.0722)


class AdaptiveTracer:
    """integrator_props: maxError (default 0.05), pValue quantile z
    (default 1.96 ~ 95%), maxSampleFactor (default 32: cap =
    factor * base spp), refineFraction (lanes per refine round as a
    fraction of the film, default 0.25)."""

    def __init__(self, scene, settings):
        self.settings = settings
        props = settings.integrator_props
        child = settings.integrator_children[0] if \
            settings.integrator_children else ("path", {})
        if child[0] not in ("path", "direct", "ao"):
            raise ValueError(
                f"adaptive: unsupported child integrator '{child[0]}'")
        self.inner = PathTracer(scene, settings)
        self.device = self.inner.device
        self.kernels = self.inner.kernels
        self.max_error = float(props.get("maxError", 0.05))
        self.quantile = float(props.get("pValue", 1.96))
        self.max_factor = int(props.get("maxSampleFactor", 32))
        self.refine_frac = float(props.get("refineFraction", 0.25))
        self.last_sample_map = None

    def _sample(self, scene, seed, sample_idx, pixel_id=None):
        """One sample per lane: (radiance [N,3] with non-finite values
        zeroed, its luminance [N])."""
        _, L = self.inner.trace_pass(scene, seed, sample_idx,
                                     pixel_id=pixel_id)
        L = torch.nan_to_num(L, nan=0.0, posinf=0.0, neginf=0.0)
        lum_w = torch.tensor(LUM_W, device=L.device)
        return L, L @ lum_w

    def _error(self, acc, acc2, cnt, avg_floor=1e-3):
        lum_w = torch.tensor(LUM_W, device=acc.device)
        mean_l = (acc @ lum_w) / cnt
        var = torch.clamp_min(acc2 / cnt - mean_l ** 2, 0.0) * (
            cnt / torch.clamp_min(cnt - 1.0, 1.0))
        std_err = torch.sqrt(var / cnt)
        avg = torch.clamp_min(torch.mean(mean_l), avg_floor)
        return self.quantile * std_err / avg

    def render(self, scene, seed=0, spp=None, progress=None, **_):
        """The image [H, W, 3] on the device; last_sample_map holds each
        pixel's final sample count [H, W]."""
        st = self.settings
        spp = spp or st.spp
        N = st.width * st.height
        dev = self.device
        acc = torch.zeros((N, 3), device=dev)
        acc2 = torch.zeros(N, device=dev)
        cnt = torch.zeros(N, device=dev)
        for s in range(spp):
            L, lum = self._sample(scene, seed, s)
            acc, acc2, cnt = acc + L, acc2 + lum * lum, cnt + 1.0
        K = max(256, int(N * self.refine_frac) // 256 * 256)
        K = min(K, N)
        max_rounds = (self.max_factor - 1) * spp * max(N // K, 1)
        for r in range(max_rounds):
            err = self._error(acc, acc2, cnt)
            unconv = err > self.max_error
            if not bool(unconv.any()):
                break
            _, order = torch.sort(-err, stable=True)
            ids = order[:K]
            live = unconv[ids]
            # per-lane stream position = that pixel's sample count
            L, lum = self._sample(scene, seed, cnt[ids].to(torch.int64),
                                  pixel_id=ids)
            L = torch.where(live[:, None], L, 0.0)
            lum = torch.where(live, lum, 0.0)
            # ids are distinct: plain indexed adds, no accumulation order
            acc[ids] += L
            acc2[ids] += lum * lum
            cnt[ids] += live.to(cnt.dtype)
            if progress:
                progress(r + 1, max_rounds)
        self.last_sample_map = cnt.reshape(st.height, st.width)
        return (acc / cnt[:, None]).reshape(st.height, st.width, 3)


def render(scene, settings, seed=0, spp=None):
    return AdaptiveTracer(scene, settings).render(scene, seed=seed,
                                                  spp=spp)
