"""The port's primary-sample-space chains (models/pssmlt.py PSSMLT,
models/erpt.py ERPT) against the reference on the CPU, on
data/scenes/caustics/caustics.xml at 16^2, maxDepth 8, 64 chains.

A Markov chain flips its path when an acceptance test u < a has a within
an ulp of u, so the pieces that decide the chains are held bit for bit:
the fresh states, the Kelemen small steps (the port computes exp as
XLA's CPU backend does), the bootstrap's resampling indices (the prefix
sum in XLA's association order).  The contribution function _eval is
held on the same PSS vectors at rtol 1e-4 / atol 1e-6, the renders at
rtol 1e-3 / atol 1e-4 on >= 99% of pixels, and the share of acceptance
decisions that agree (recorded as the test property
`acceptance_agreement`) at >= 0.99."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gradientdomain_mitsuba_tpu.core import rng as ref_rng
from gradientdomain_mitsuba_tpu_torch.models import pssmlt
from gradientdomain_mitsuba_tpu_torch.models.erpt import ERPTracer
from gradientdomain_mitsuba_tpu_torch.models.pssmlt import PSSMLTracer
from torch_parity import (assert_image_close, load, make_both,
                          render_chains)
from torch_parity import one_thread  # noqa: F401

# torch on one thread: the suite runs six workers, and a multi-threaded
# CPU torch among them spends the renders' time contending for cores
pytestmark = pytest.mark.usefixtures("one_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAUS = os.path.join(ROOT, "data/scenes/caustics/caustics.xml")
SEED, SPP, CHAINS = 0, 2, 64


def _pair(integrator, **props):
    scene, st = load(CAUS, integrator, size=16, spp=SPP, depth=8,
                     props=dict(chains=CHAINS, luminanceSamples=4 * CHAINS,
                                **props))
    return make_both(scene, st)


@pytest.fixture(scope="module")
def pss():
    """(reference tracer, its scene, port tracer, its scene) and both
    renders with their acceptance decisions."""
    rt, rs, pt, ts = _pair("pssmlt")
    return (rt, rs, pt, ts), render_chains(rt, rs, pt, ts, SEED, SPP)


def _bits(a):
    return np.asarray(a).view(np.uint32)


@pytest.mark.parametrize("seed,it", [(0, 0), (0xb00, 3), (2 ** 32 - 1, 7)])
def test_fresh_states_and_small_steps_bitwise(pss, seed, it):
    (rt, _, pt, _), _ = pss
    ref_u = rt._fresh(seed, it, CHAINS)
    got_u = pt._fresh(seed, it, CHAINS)
    assert got_u.shape == (CHAINS, pt.n_dims) == ref_u.shape
    np.testing.assert_array_equal(got_u.numpy().view(np.uint32),
                                  _bits(ref_u))
    ref_m = rt._mutate_small(seed, it + 1, ref_u)
    got_m = pt._mutate_small(seed, it + 1, got_u)
    np.testing.assert_array_equal(got_m.numpy().view(np.uint32),
                                  _bits(ref_m))
    assert ((got_m.numpy() >= 0) & (got_m.numpy() < 1)).all()


@jax.jit
def _ref_resample(cand_I, jitter):
    """The reference's resampling lines (models/pssmlt.py _run)."""
    C = cand_I.shape[0]
    cdf = jnp.cumsum(cand_I)
    cdf = cdf / jnp.maximum(cdf[-1], 1e-30)
    picks = jnp.searchsorted(cdf, (jnp.arange(C) + jitter) / C)
    return jnp.clip(picks, 0, C - 1)


@pytest.mark.parametrize("C", [64, 1000, 8192])
def test_resampling_indices_bitwise(C):
    """Systematic resampling by I: the reference's prefix sums are
    XLA's blocked association, which pssmlt.cumsum_f32 follows; zeros
    (dead chains) and repeated values included."""
    rs = np.random.RandomState(C)
    I = np.float32(rs.exponential(size=C) * (rs.uniform(size=C) < 0.7))
    I[: C // 8] = I[C // 8: C // 4]
    np.testing.assert_array_equal(
        pssmlt.cumsum_f32(torch.from_numpy(I)).numpy().view(np.uint32),
        _bits(jnp.cumsum(I)))
    for seed, idx in ((0, 0), (9, 3)):
        jit = ref_rng.uniform_float(seed ^ 0x5eed, jnp.zeros(1, jnp.uint32),
                                    idx, 0)[0]
        ref = np.asarray(_ref_resample(jnp.asarray(I), jit))
        got = pssmlt.resample_states(seed, idx, torch.zeros(C, 1),
                                     torch.from_numpy(I)).numpy()
        np.testing.assert_array_equal(got, ref)


def test_eval_matches_reference(pss):
    """f(u) of fresh and mutated PSS vectors: the path tracer through
    the glass and Ag spheres driven by the chains' coordinates."""
    (rt, rs, pt, ts), _ = pss
    u = pt._fresh(5, 1, CHAINS)
    u = torch.cat([u, pt._mutate_small(5, 2, u)])[:CHAINS]
    rpos, rL, rI = rt._eval(rs, jnp.asarray(u.numpy()))
    ppos, pL, pI = pt._eval(ts, u)
    np.testing.assert_array_equal(ppos.numpy(), np.asarray(rpos))
    np.testing.assert_allclose(pL.numpy(), np.asarray(rL), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(pI.numpy(), np.asarray(rI), rtol=1e-4,
                               atol=1e-6)
    assert (np.asarray(rI) > 0).mean() > 0.3


def _check_chains(render, record_property, b=None):
    ref, got, ref_takes, port_takes = render
    assert_image_close(got, ref)
    assert ref.mean() > 1e-3
    assert ref_takes.shape == port_takes.shape
    share = float((ref_takes == port_takes).mean())
    record_property("acceptance_agreement", share)
    assert share >= 0.99, share
    assert 0.05 < port_takes.mean() < 1.0


def test_pssmlt_matches_reference(pss, record_property):
    (rt, _, pt, _), render = pss
    assert type(pt) is PSSMLTracer
    assert pt.n_iterations(SPP) == 8
    _check_chains(render, record_property)
    assert pt.last_b == pytest.approx(rt.last_b, rel=1e-5)


def test_erpt_matches_reference(record_property):
    """Two redistribution rounds of 4 small steps (chainLength 4): each
    round's fresh candidates, b_r and resampled seeds."""
    rt, rs, pt, ts = _pair("erpt", chainLength=4)
    assert type(pt) is ERPTracer and pt.n_rounds(SPP) == 2
    _check_chains(render_chains(rt, rs, pt, ts, SEED, SPP), record_property)
