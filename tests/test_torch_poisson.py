"""Port screened-Poisson solvers against the reference on the same 32^2
primal/dx/dy (made from a seed with numpy).

Tolerances: rtol 1e-4 / atol 1e-5 wherever the solve is well conditioned
(CG dot products are summed in a different order in the two frameworks).
The full L1 IRLS (8 outer x 40 inner) is not: its later outer sweeps
reweight by 1/max(|r|, 1e-4), and in float32 the reference itself moves
by up to ~0.17 per pixel when ONE input value changes by one ulp
(test_l1_reference_is_chaotic).  Elementwise agreement is therefore not
a property either package has; the 8x40 solves are compared by what the
solver minimizes (the L1 objective) and by the image mean."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gradientdomain_mitsuba_tpu.models import poisson as ref_poisson
from gradientdomain_mitsuba_tpu_torch.models import poisson

TOL = dict(rtol=1e-4, atol=1e-5)


def _inputs(seed=0, n=32):
    """Smooth image + noise, gradients = its finite differences + noise."""
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:n, 0:n] / n
    base = np.stack([np.sin(3 * xx + c) * np.cos(2 * yy) + 1.5
                     for c in range(3)], -1)
    true_dx = np.pad(base[:, 1:] - base[:, :-1], ((0, 0), (0, 1), (0, 0)))
    true_dy = np.pad(base[1:] - base[:-1], ((0, 1), (0, 0), (0, 0)))
    P = np.float32(base + rs.normal(0, 0.1, base.shape))
    gx = np.float32(true_dx + rs.normal(0, 0.02, base.shape))
    gy = np.float32(true_dy + rs.normal(0, 0.02, base.shape))
    return P, gx, gy


def _l1_energy(x, P, gx, gy, alpha=0.2):
    gx = gx.copy()
    gy = gy.copy()
    gx[:, -1] = 0.0
    gy[-1] = 0.0
    dx = np.pad(x[:, 1:] - x[:, :-1], ((0, 0), (0, 1), (0, 0)))
    dy = np.pad(x[1:] - x[:-1], ((0, 1), (0, 0), (0, 0)))
    return (np.abs(dx - gx).sum() + np.abs(dy - gy).sum() +
            alpha * np.abs(x - P).sum())


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("seed", [0, 1])
def test_solve_l2(seed):
    P, gx, gy = _inputs(seed)
    ref, ref_res = ref_poisson.solve_l2(P, gx, gy, alpha=0.2, iters=100,
                                        return_residuals=True)
    got, res = poisson.solve_l2(*_t(P, gx, gy), alpha=0.2, iters=100,
                                return_residuals=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    # the residual curve: same decay over the well-conditioned first half
    np.testing.assert_allclose(res.numpy()[:50], np.asarray(ref_res)[:50],
                               rtol=1e-2, atol=1e-4)


@pytest.mark.parametrize("outer,inner", [(1, 40), (2, 5)])
def test_solve_l1_well_conditioned_sweeps(outer, inner):
    """The first IRLS sweeps agree elementwise."""
    P, gx, gy = _inputs(2)
    ref = ref_poisson.solve_l1(P, gx, gy, alpha=0.2, outer_iters=outer,
                               inner_iters=inner)
    got = poisson.solve_l1(*_t(P, gx, gy), alpha=0.2, outer_iters=outer,
                           inner_iters=inner)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("seed", [0, 3])
def test_solve_l1_full(seed):
    """8 x 40 IRLS: same L1 objective (within 1%) and image mean (within
    1e-3), both well inside the reference's own 1-ulp spread."""
    P, gx, gy = _inputs(seed)
    ref = np.asarray(ref_poisson.solve_l1(P, gx, gy, alpha=0.2,
                                          outer_iters=8, inner_iters=40))
    got = poisson.solve_l1(*_t(P, gx, gy), alpha=0.2, outer_iters=8,
                           inner_iters=40).numpy()
    assert np.isfinite(got).all()
    e_ref = _l1_energy(ref, P, gx, gy)
    e_got = _l1_energy(got, P, gx, gy)
    assert abs(e_got - e_ref) <= 0.01 * e_ref, (e_got, e_ref)
    assert e_got < 0.5 * _l1_energy(P, P, gx, gy)   # it did minimize
    assert abs(got.mean() - ref.mean()) <= 1e-3 * abs(ref.mean())


def test_l1_reference_is_chaotic():
    """Documents why the 8x40 L1 solve is not compared elementwise: the
    reference differs from ITSELF by far more than 1e-4 when one input
    value moves by one ulp, while its objective barely moves."""
    P, gx, gy = _inputs(0)
    P2 = P.copy()
    P2[5, 7, 1] = np.nextafter(P2[5, 7, 1], np.float32(9))
    a = np.asarray(ref_poisson.solve_l1(P, gx, gy))
    b = np.asarray(ref_poisson.solve_l1(P2, gx, gy))
    assert np.abs(a - b).max() > 1e-3
    assert abs(_l1_energy(a, P, gx, gy) - _l1_energy(b, P, gx, gy)) <= \
        0.01 * _l1_energy(a, P, gx, gy)


@pytest.mark.parametrize("mode", ["L2", "L1"])
def test_reconstruct_adds_very_direct(mode):
    P, gx, gy = _inputs(4)
    vd = np.float32(np.random.RandomState(4).uniform(size=P.shape))
    bufs = dict(zip(("primal", "dx", "dy", "very_direct"),
                    _t(P, gx, gy, vd)))
    out, stats = poisson.reconstruct(bufs, mode=mode, l1_outer=1,
                                     return_stats=True)
    ref = ref_poisson.reconstruct(
        {k: jnp.asarray(v.numpy()) for k, v in bufs.items()}, mode=mode,
        l1_outer=1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    n_iter = 100 if mode == "L2" else 40
    assert stats["cg_residuals"].shape == (n_iter,)
