"""Port sweeps: the plain PyTorch linear-MT sweeps (the CPU path and the
oracle of the CUDA kernels) against the reference's Pallas sweep kernels
run in interpret mode, as tests/test_pallas.py runs them.  The CUDA
kernels themselves are tested in test_torch_sweep_cuda.py."""
import functools
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from gradientdomain_mitsuba_tpu.ops import intersect as ref_isec
from gradientdomain_mitsuba_tpu.ops import pallas_sweep as ps
from gradientdomain_mitsuba_tpu_torch.ops import intersect as isec
from gradientdomain_mitsuba_tpu_torch.ops import sweep

_spec = importlib.util.spec_from_file_location(
    "sweep_soups", os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "sweep_soups.py"))
sweep_soups = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(sweep_soups)

N = 300


def _soup_and_rays(T, seed, kind="random"):
    """Random soup [T] and N rays from a seed; every 5th lane is dead
    (maxt = -1), as the wavefront masks finished lanes."""
    o, d, mint, maxt, linC = sweep_soups.random_soup(T, N, seed, kind)
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


def test_plain_sweep_sees_every_cluster():
    """Triangles in later cluster windows are hit: the port sweeps every
    column of linC (the reference's Pallas wrapper trims to
    round_up(n_tris, 64) columns, which drops them — ROADMAP Queue 3)."""
    # cluster-major, as the scene loader lays out 64 < T <= 2048: windows
    # of 128 columns holding 100 triangles, so triangles sit past
    # round_up(T, 64)
    padded, o, d, mint, maxt = _soup_and_rays(300, seed=5, kind="windowed")
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


def _dense_from_records(recs):
    """A dense [10, 4n] linC rebuilt from packed records [n, 20] (the
    structural rows filled, every other coefficient zero) and the column
    ids the records carry."""
    n = recs.shape[0]
    dense = torch.zeros((10, 4, n))
    at = 0
    for g, rows in sweep.STRUCTURE:
        dense[list(rows), g] = recs[:, at:at + len(rows)].t()
        at += len(rows)
    return dense.reshape(10, 4 * n), recs[:, 19].view(torch.int32)


def test_pack_keeps_the_columns_that_can_hit():
    """Exactly the non-degenerate columns, in order, with their ids:
    cbox's 32 of 128, the windowed soup's 300 of 384, no zero-area one."""
    from gradientdomain_mitsuba_tpu_torch.scene import bridge
    from gradientdomain_mitsuba_tpu_torch.scene import scene as port_scene
    import os
    cbox = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "data/scenes/cbox/cbox.xml")
    scene, _ = port_scene.load_scene(cbox, {"width": "8", "height": "8"})
    linC = bridge.to_torch(scene, "cpu").geom.linC
    assert linC.shape == (10, 512)
    ids = sweep.pack_linear_mt(linC)[:, 19].view(torch.int32)
    assert ids.tolist() == list(range(32))

    linC = torch.from_numpy(sweep_soups.random_soup(300, 1, 0, "windowed")[4])
    ids = sweep.pack_linear_mt(linC)[:, 19].view(torch.int32)
    assert linC.shape[1] == 4 * 384
    assert ids.tolist() == [k * 128 + j for k in range(3)
                            for j in range(100)]

    linC = torch.from_numpy(sweep_soups.random_soup(96, 1, 0, "zero_area")[4])
    ids = sweep.pack_linear_mt(linC)[:, 19].view(torch.int32)
    assert ids.tolist() == [j for j in range(96) if j % 3]


@pytest.mark.parametrize("row,group", [(0, 0), (9, 0), (7, 1), (6, 2),
                                       (2, 3), (5, 3)])
def test_pack_raises_outside_the_structure(row, group):
    linC = torch.from_numpy(sweep_soups.random_soup(36, 1, 1)[4])
    sweep.pack_linear_mt(linC)
    bad = linC.clone()
    bad[row, group * 36 + 5] = 0.5
    with pytest.raises(ValueError, match=f"row {row} of column group "
                                         f"{group}"):
        sweep.pack_linear_mt(bad)


def test_pack_built_once_per_table():
    k = sweep.make_sweep_intersector(36)
    linC = torch.from_numpy(sweep_soups.random_soup(36, 1, 2)[4])
    first = k.packed(linC)
    assert k.packed(linC) is first
    other = linC.clone()
    assert k.packed(other) is not first
    assert torch.equal(k.packed(other), first)


@pytest.mark.parametrize("kind,T", [("random", 36), ("windowed", 300),
                                    ("zero_area", 96), ("ties", 64)])
def test_dense_from_records_matches_original(kind, T):
    """The records hold the whole table: intersect_matmul on a dense
    table rebuilt from them, with prims mapped back to column ids, equals
    intersect_matmul on the original bit for bit (occluded_matmul too)."""
    o, d, mint, maxt, linC = map(torch.from_numpy,
                                 sweep_soups.random_soup(T, 4000, 9, kind))
    dense, ids = _dense_from_records(sweep.pack_linear_mt(linC))
    ref = isec.intersect_matmul(o, d, mint, maxt, linC)
    got = isec.intersect_matmul(o, d, mint, maxt, dense)
    prim = torch.where(got.valid, ids[got.prim.clamp_min(0).long()], -1)
    assert torch.equal(prim, ref.prim)
    for a, b in ((got.t, ref.t), (got.u, ref.u), (got.v, ref.v)):
        assert torch.equal(a, b)
    assert torch.equal(isec.occluded_matmul(o, d, mint, maxt, dense),
                       isec.occluded_matmul(o, d, mint, maxt, linC))
    assert bool(ref.valid.any())
