"""The port's BDPT through delta vertices and its path-space MLT
(models/mlt.py, the full BDPT strategy family as the chains' target)
against the reference on the CPU, on data/scenes/caustics/caustics.xml
at 16^2.

BDPT: the glass and Ag sphere vertices store delta, pass a forward pdf of
0 and are never connection endpoints; image at rtol 1e-3 / atol 1e-4 on
>= 99% of pixels, equal ray counts (maxDepth 5, the zoo's depth).  MLT
(maxDepth 4, 64 chains): the dim remaps onto the eye and light spans,
the fresh states and the fixed-coordinate-subset small steps bit for
bit; _eval (eye radiance, the t=1 light-image splats, I) on the same PSS
vectors at rtol 1e-4 / atol 1e-6; the render at rtol 1e-3 / atol 1e-4 on
>= 99% of pixels and the share of acceptance decisions that agree
(test property `acceptance_agreement`) at >= 0.99."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gradientdomain_mitsuba_tpu_torch.core.rng import DimAllocator as DA
from gradientdomain_mitsuba_tpu_torch.models import bdpt
from gradientdomain_mitsuba_tpu_torch.models.mlt import MLTracer
from torch_parity import (assert_image_close, load, make_both,
                          render_both, render_chains)
from torch_parity import one_thread  # noqa: F401

# torch on one thread: the suite runs six workers, and a multi-threaded
# CPU torch among them spends the renders' time contending for cores
pytestmark = pytest.mark.usefixtures("one_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAUS = os.path.join(ROOT, "data/scenes/caustics/caustics.xml")
SEED, SPP, CHAINS = 0, 2, 64


def test_bdpt_matches_reference_on_caustics():
    scene, st = load(CAUS, "bdpt", size=16, spp=SPP, depth=5)
    (ref,), (got,), rt, pt = render_both(scene, st, [SEED], SPP,
                                         count_rays=True)
    assert type(pt) is bdpt.BDPTracer
    assert pt.last_ray_count == int(rt.last_ray_count)
    assert_image_close(got, ref)
    assert ref.mean() > 1e-3


@pytest.fixture(scope="module")
def mlt():
    """(reference tracer, its scene, port tracer, its scene) and both
    renders with their acceptance decisions."""
    scene, st = load(CAUS, "mlt", size=16, spp=SPP, depth=4,
                     props=dict(chains=CHAINS, luminanceSamples=4 * CHAINS))
    rt, rs, pt, ts = make_both(scene, st)
    return (rt, rs, pt, ts), render_chains(rt, rs, pt, ts, SEED, SPP)


def test_mlt_remaps_bitwise(mlt):
    """Every eye and light dim lands on the reference's dense column (the
    pixel jitter scaled to the film); dims past a span raise."""
    (rt, _, pt, _), _ = mlt
    assert (pt.n_dims, pt.eye_span) == (rt.n_dims, rt.eye_span)
    pss = np.float32(np.random.RandomState(1).uniform(size=(8, pt.n_dims)))
    dims = (list(range(pt.eye_span - 1)) +
            [bdpt.LIGHT_DIM_BASE + k
             for k in range(pt.n_dims - pt.eye_span - 1)])
    for dim in dims:
        for name in ("_u1", "_u2"):
            ref = getattr(rt.inner, name)(jnp.asarray(pss), None, None, dim)
            got = getattr(pt.inner, name)(torch.from_numpy(pss), None, None,
                                          dim)
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    jit = pt.inner._u2(torch.from_numpy(pss), None, None, DA.PIXEL_JITTER)
    assert (jit.numpy()[:, 0] > 1).any()
    for dim in (pt.eye_span, bdpt.LIGHT_DIM_BASE + pt.n_dims):
        for tracer, arr in ((rt.inner, jnp.asarray(pss)),
                            (pt.inner, torch.from_numpy(pss))):
            with pytest.raises(ValueError, match="exceeds span"):
                tracer._u1(arr, None, None, dim)


@pytest.mark.parametrize("seed,it", [(0, 0), (2 ** 32 - 1, 9)])
def test_mlt_fresh_states_and_small_steps_bitwise(mlt, seed, it):
    """The five coordinate-subset kernels pick their subsets from one
    coin a chain: the same coins, subsets and steps."""
    (rt, _, pt, _), _ = mlt
    ref_u = rt._fresh(seed, it, 512)
    got_u = pt._fresh(seed, it, 512)
    np.testing.assert_array_equal(got_u.numpy().view(np.uint32),
                                  np.asarray(ref_u).view(np.uint32))
    ref_m = np.asarray(rt._mutate_small(seed, it, ref_u))
    got_m = pt._mutate_small(seed, it, got_u).numpy()
    np.testing.assert_array_equal(got_m.view(np.uint32),
                                  ref_m.view(np.uint32))
    moved = got_m != got_u.numpy()
    # all-coordinate steps and frozen subsets both occur
    assert moved.any(1).all() and moved.all(1).any()
    assert not moved.all(1).all()


def test_mlt_eval_matches_reference(mlt):
    (rt, rs, pt, ts), _ = mlt
    u = pt._fresh(7, 2, CHAINS)
    ref = rt._eval(rs, jnp.asarray(u.numpy()))
    got = pt._eval(ts, u)
    for name, r, g in zip(("pos", "L", "spos", "sval", "I"), ref, got):
        assert g.shape == r.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-6, err_msg=name)
    assert (np.asarray(ref[-1]) > 0).mean() > 0.3


def test_mlt_matches_reference(mlt, record_property):
    (rt, _, pt, _), (ref, got, ref_takes, port_takes) = mlt
    assert type(pt) is MLTracer and pt.n_iterations(SPP) == 8
    assert_image_close(got, ref)
    assert ref.mean() > 1e-3
    share = float((ref_takes == port_takes).mean())
    record_property("acceptance_agreement", share)
    assert share >= 0.99, share
    assert pt.last_b == pytest.approx(rt.last_b, rel=1e-5)
