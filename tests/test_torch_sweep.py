"""Port sweeps: the plain PyTorch linear-MT sweeps (the CPU path and the
oracle of the CUDA kernels) against the reference's Pallas sweep kernels
run in interpret mode, as tests/test_pallas.py runs them.  The CUDA
kernels themselves are tested in test_torch_sweep_cuda.py."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from gradientdomain_mitsuba_tpu.ops import intersect as ref_isec
from gradientdomain_mitsuba_tpu.ops import pallas_sweep as ps
from gradientdomain_mitsuba_tpu_torch.ops import intersect as isec
from gradientdomain_mitsuba_tpu_torch.ops import sweep

N = 300


def _soup_and_rays(T, seed):
    """Random soup [T] and N rays from a seed; every 5th lane is dead
    (maxt = -1), as the wavefront masks finished lanes."""
    rs = np.random.RandomState(seed)
    v0, e1, e2 = (np.float32(rs.normal(size=(T, 3))) for _ in range(3))
    linC = isec.build_linear_mt(v0, e1, e2)
    o = np.float32(rs.normal(size=(N, 3)) * 3)
    d = np.float32(rs.normal(size=(N, 3)))
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    mint = np.full(N, 1e-4, np.float32)
    maxt = np.full(N, 3e38, np.float32)
    maxt[::5] = -1.0
    return linC, o, d, mint, maxt


@pytest.fixture()
def interpret_sweep(monkeypatch):
    monkeypatch.setattr(ps.pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


@pytest.mark.parametrize("T", [3, 36, 130])
def test_plain_sweep_matches_pallas_reference(interpret_sweep, T):
    linC, o, d, mint, maxt = _soup_and_rays(T, seed=T)
    ref = ps.make_sweep_intersector(T)(*map(jnp.asarray,
                                            (o, d, mint, maxt, linC)))
    got = sweep.make_sweep_intersector(T)(
        *map(torch.from_numpy, (o, d, mint, maxt, linC)))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(got.prim.numpy(), np.asarray(ref.prim))
    mk = np.asarray(ref.valid)
    assert not mk[::5].any()  # dead lanes come back unhit
    np.testing.assert_allclose(got.t.numpy()[mk], np.asarray(ref.t)[mk],
                               rtol=1e-5)
    np.testing.assert_array_equal(got.t.numpy()[~mk],
                                  np.float32(3.0e38))

    ref_o = ps.make_sweep_occluder(T)(*map(jnp.asarray,
                                           (o, d, mint, maxt, linC)))
    got_o = sweep.make_sweep_occluder(T)(
        *map(torch.from_numpy, (o, d, mint, maxt, linC)))
    np.testing.assert_array_equal(got_o.numpy(), np.asarray(ref_o))


@pytest.mark.parametrize("T", [3, 36, 130])
def test_plain_sweep_matches_reference_matmul(T):
    """Same contract as the reference's jnp intersect_matmul /
    occluded_matmul, including padding triangles (zero columns)."""
    linC, o, d, mint, maxt = _soup_and_rays(T, seed=100 + T)
    pad = np.zeros((10, 4 * (T + 5)), np.float32)   # 5 zero columns each
    for g in range(4):
        pad[:, g * (T + 5):g * (T + 5) + T] = linC[:, g * T:(g + 1) * T]
    ref = ref_isec.intersect_matmul(*map(jnp.asarray,
                                         (o, d, mint, maxt, pad)))
    got = isec.intersect_matmul(*map(torch.from_numpy,
                                     (o, d, mint, maxt, pad)))
    np.testing.assert_array_equal(got.prim.numpy(), np.asarray(ref.prim))
    mk = np.asarray(ref.valid)
    np.testing.assert_allclose(got.u.numpy()[mk], np.asarray(ref.u)[mk],
                               rtol=1e-5, atol=1e-6)
    ref_o = ref_isec.occluded_matmul(*map(jnp.asarray,
                                          (o, d, mint, maxt, pad)))
    got_o = isec.occluded_matmul(*map(torch.from_numpy,
                                      (o, d, mint, maxt, pad)))
    np.testing.assert_array_equal(got_o.numpy(), np.asarray(ref_o))


def test_cpu_call_counts_no_launch():
    linC, o, d, mint, maxt = _soup_and_rays(36, seed=1)
    k = sweep.make_sweep_intersector(36)
    k(*map(torch.from_numpy, (o, d, mint, maxt, linC)))
    assert k.launches == 0


def _cluster_padded(linC, window=128, per=100):
    """Re-lay a [10, 4T] table cluster-major, as the scene loader does for
    64 < T <= 2048: clusters of `per` triangles, each padded with zero
    columns to `window` slots, so real triangles sit past round_up(T, 64)."""
    T = linC.shape[1] // 4
    K = -(-T // per)
    out = np.zeros((10, 4 * K * window), np.float32)
    for g in range(4):
        for k in range(K):
            n = min(per, T - k * per)
            dst = g * K * window + k * window
            out[:, dst:dst + n] = linC[:, g * T + k * per:g * T + k * per + n]
    return out


def test_plain_sweep_sees_every_cluster():
    """Triangles in later cluster windows are hit: the port sweeps every
    column of linC (the reference's Pallas wrapper trims to
    round_up(n_tris, 64) columns, which drops them — ROADMAP Queue 3)."""
    linC, o, d, mint, maxt = _soup_and_rays(300, seed=5)
    padded = _cluster_padded(linC)
    ref = ref_isec.intersect_matmul(*map(jnp.asarray,
                                         (o, d, mint, maxt, padded)))
    got = sweep.make_sweep_intersector(300)(
        *map(torch.from_numpy, (o, d, mint, maxt, padded)))
    np.testing.assert_array_equal(got.prim.numpy(), np.asarray(ref.prim))
    assert (got.prim.numpy() >= 256).any()   # hits in the third window
    ref_o = ref_isec.occluded_matmul(*map(jnp.asarray,
                                          (o, d, mint, maxt, padded)))
    got_o = sweep.make_sweep_occluder(300)(
        *map(torch.from_numpy, (o, d, mint, maxt, padded)))
    np.testing.assert_array_equal(got_o.numpy(), np.asarray(ref_o))
