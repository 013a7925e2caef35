"""Energy redistribution path tracing (Cline, Talbot, Egbert 2005).

Counterpart of gradientdomain_mitsuba_tpu/models/erpt.py (src/integrators/
erpt/erpt.{h,cpp}): the estimator runs in primary sample space over a
lockstep wavefront of chains (the PSS machinery of models/pssmlt.py):

  - every redistribution round draws a fresh uniform candidate per chain
    (an ordinary path-tracer sample: the deposition-energy bootstrap and
    the chain seed in one),
  - chains are resampled from the candidate pool by luminance,
  - each chain runs `chainLength` small Kelemen steps, splatting the
    Kelemen-weighted expected-value estimate at x and y,
  - rounds repeat until the mutation budget (spp x W x H) is spent.

The per-round normalization b_r comes from the round's own candidates.
As in the reference, Veach's path-space mutations (lens / caustic /
multi-chain) are replaced by the symmetric Kelemen small step on the
replayed random stream.  The reference's fori_loop over steps is a
Python loop; the state and the acceptance tests stay on the device.
"""
from __future__ import annotations

import torch

from .pssmlt import PSSMLTracer, resample_states


class ERPTracer(PSSMLTracer):
    """integrator_props: `chains` (parallel chains, default 8192),
    `chainLength` (small steps per redistribution round, default 100),
    maxDepth / rrDepth as usual."""

    def __init__(self, scene, settings):
        super().__init__(scene, settings)
        props = settings.integrator_props
        self.chain_len = int(props.get("chainLength", 100))

    def _seed_round(self, scene, seed, round_idx):
        """A round's fresh candidates: b_r (their mean luminance) and the
        chain states resampled from them, with their evaluations."""
        C = self.n_chains
        cand_u = self._fresh(seed ^ (0xe271 + round_idx), 0, C)
        _, _, cand_I = self._eval(scene, cand_u)
        b = torch.mean(cand_I)
        u0 = cand_u[resample_states(seed, round_idx, cand_u, cand_I)]
        return b, (u0,) + self._eval(scene, u0)

    def _mstep(self, scene, seed, it, state, b, fb):
        """One small step of every chain at counter `it` (the round's
        first step index plus the step), splat both states, accept."""
        u, pos, L, I = state
        C = u.shape[0]
        ids = torch.arange(C, dtype=torch.int64, device=u.device)
        uy = self._mutate_small(seed, it, u)
        pos_y, Ly, Iy = self._eval(scene, uy)
        return self._accept(seed, it, ids, state, (uy, pos_y, Ly, Iy), b,
                            fb)

    def _run_round(self, scene, seed, round_idx, n_steps):
        """One redistribution round: fresh candidates -> b_r + seeds ->
        n_steps small mutations with Kelemen splatting."""
        st = self.settings
        b, state = self._seed_round(scene, seed, round_idx)
        fb = torch.zeros((st.height, st.width, 3), device=self.device)
        for it in range(n_steps):
            state, fb = self._mstep(scene, seed, round_idx * n_steps + it,
                                    state, b, fb)
        return fb

    def n_rounds(self, spp):
        st = self.settings
        per_round = self.n_chains * self.chain_len
        return max(1, (st.width * st.height * spp) // per_round)

    def render(self, scene, seed=0, spp=None, **_):
        """Returns the image [H, W, 3] on the device."""
        st = self.settings
        n_rounds = self.n_rounds(spp or st.spp)
        fb = None
        for r in range(n_rounds):
            fbr = self._run_round(scene, seed, r, self.chain_len)
            fb = fbr if fb is None else fb + fbr
        scale = (st.width * st.height) / float(
            n_rounds * self.n_chains * self.chain_len)
        return fb * scale


def render(scene, settings, seed=0, spp=None):
    return ERPTracer(scene, settings).render(scene, seed=seed, spp=spp)
