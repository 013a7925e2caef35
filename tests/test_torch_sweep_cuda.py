"""CUDA sweep kernels (csrc/sweep.cu) against their plain PyTorch
versions, on the card.  Imports no jax, so the card's machine (which has
none) runs it without the repo's conftest:

    python -m pytest --noconftest tests/test_torch_sweep_cuda.py -m cuda -q

Without a card every case skips."""
import importlib.util
import os

import numpy as np
import pytest
import torch

from gradientdomain_mitsuba_tpu_torch.ops import intersect as isec
from gradientdomain_mitsuba_tpu_torch.ops import sweep

_spec = importlib.util.spec_from_file_location(
    "sweep_soups", os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "sweep_soups.py"))
sweep_soups = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(sweep_soups)


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the sweep kernels run only on "
                    "the card)")
    return torch.device("cuda")


def _soup(kind, T, n, seed, dev):
    """sweep_soups.random_soup on the card: (o, d, mint, maxt, linC),
    every 5th lane dead."""
    return [torch.from_numpy(a).to(dev)
            for a in sweep_soups.random_soup(T, n, seed, kind)]


@pytest.mark.cuda
@pytest.mark.parametrize("T", [3, 36, 130, 2048])
def test_cuda_kernels_match_plain(cuda_device, T):
    args = _soup("random", T, 10_007, T, cuda_device)
    k = sweep.make_sweep_intersector(T)
    got = k(*args)
    ref = isec.intersect_matmul(*args)
    torch.cuda.synchronize()
    assert k.launches == 1
    assert torch.equal(got.valid, ref.valid)
    assert not got.valid[::5].any()
    assert bool((got.prim[~got.valid] == -1).all())
    mk = ref.valid & (got.prim == ref.prim)
    assert mk.sum() >= 0.998 * ref.valid.sum()
    torch.testing.assert_close(got.t[mk], ref.t[mk], rtol=1e-5, atol=0)
    o = sweep.make_sweep_occluder(T)
    occ = o(*args)
    assert o.launches == 1
    assert (occ == isec.occluded_matmul(*args)).float().mean() >= 0.999


@pytest.mark.cuda
def test_cuda_kernels_sweep_every_cluster(cuda_device):
    """Cluster-major layout: 3 windows of 128 columns with 100 real
    triangles each; the kernels must test the triangles past column 256."""
    args = _soup("windowed", 300, 10_007, 5, cuda_device)
    assert args[4].shape == (10, 4 * 384)
    got = sweep.make_sweep_intersector(300)(*args)
    ref = isec.intersect_matmul(*args)
    torch.cuda.synchronize()
    assert torch.equal(got.valid, ref.valid)
    assert bool((got.prim >= 256).any())
    assert (got.prim == ref.prim).float().mean() >= 0.998
    occ = sweep.make_sweep_occluder(300)(*args)
    assert (occ == isec.occluded_matmul(*args)).float().mean() >= 0.999


@pytest.mark.cuda
def test_cuda_wrapper_rejects_bad_inputs(cuda_device):
    o, d, mint, maxt, linC = _soup("random", 8, 64, 0, cuda_device)
    k = sweep.make_sweep_intersector(8)
    with pytest.raises(TypeError):
        k(o.double(), d, mint, maxt, linC)
    with pytest.raises(ValueError):
        k(o[:, :2], d, mint, maxt, linC)
    with pytest.raises(ValueError):
        k(o.t().contiguous().t(), d, mint, maxt, linC)
    with pytest.raises(ValueError):
        k(o, d, mint.cpu(), maxt, linC)
    assert k.launches == 0


def _check_against_plain(args, n_tris):
    """Both kernels against their plain versions on one batch, at the
    smoke run's tolerances; returns the kernels' (Hit, occluded)."""
    k = sweep.make_sweep_intersector(n_tris)
    got = k(*args)
    ref = isec.intersect_matmul(*args)
    ko = sweep.make_sweep_occluder(n_tris)
    occ = ko(*args)
    ref_occ = isec.occluded_matmul(*args)
    torch.cuda.synchronize()
    assert k.launches == 1 and ko.launches == 1
    assert torch.equal(got.valid, ref.valid)
    assert not got.valid[args[3] <= args[2]].any()
    assert not occ[args[3] <= args[2]].any()
    assert bool((got.prim[~got.valid] == -1).all())
    assert bool((got.t[~got.valid] == np.float32(3.0e38)).all())
    mk = ref.valid & (got.prim == ref.prim)
    assert mk.sum() >= 0.998 * ref.valid.sum()
    torch.testing.assert_close(got.t[mk], ref.t[mk], rtol=1e-5, atol=0)
    assert (occ == ref_occ).float().mean() >= 0.999
    return got, occ


@pytest.mark.cuda
@pytest.mark.parametrize("kind,T", [("windowed", 300), ("zero_area", 96),
                                    ("ties", 64)])
def test_cuda_kernels_match_plain_on_soups(cuda_device, kind, T):
    """The windowed layout (triangles past column 256), zero-area
    triangles (left out of the packed table) and duplicated triangles
    (equal t: the lowest column must win)."""
    args = _soup(kind, T, 20_011, 11, cuda_device)
    got, _ = _check_against_plain(args, T)
    n_rec = sweep.make_sweep_intersector(T).packed(args[4]).shape[0]
    if kind == "windowed":
        assert n_rec == T and bool((got.prim >= 256).any())
    elif kind == "zero_area":
        assert n_rec == T - len(range(0, T, 3))
        assert not bool((got.prim[got.valid] % 3 == 0).any())
    else:
        assert n_rec == T and bool(got.valid.any())
        assert bool((got.prim[got.valid] < (T + 1) // 2).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 255, 257])
def test_cuda_kernels_any_batch_size(cuda_device, n):
    args = _soup("random", 36, max(n, 1), 3, cuda_device)
    args = [a[:n] for a in args[:4]] + [args[4]]
    k = sweep.make_sweep_intersector(36)
    ko = sweep.make_sweep_occluder(36)
    got, occ = k(*args), ko(*args)
    ref = isec.intersect_matmul(*args)
    torch.cuda.synchronize()
    assert got.t.shape == (n,) and occ.shape == (n,)
    assert torch.equal(got.prim, ref.prim)
    assert torch.equal(occ, isec.occluded_matmul(*args))
    assert k.launches == 1 and ko.launches == 1


@pytest.mark.cuda
def test_cuda_kernels_dead_lanes_stay_unhit(cuda_device):
    """Every lane dead (maxt <= mint, as finished wavefront lanes carry)."""
    o, d, mint, maxt, linC = _soup("random", 130, 4_099, 4, cuda_device)
    for dead_maxt in (torch.full_like(maxt, -1.0), mint.clone()):
        got = sweep.make_sweep_intersector(130)(o, d, mint, dead_maxt, linC)
        occ = sweep.make_sweep_occluder(130)(o, d, mint, dead_maxt, linC)
        torch.cuda.synchronize()
        assert not got.valid.any() and not occ.any()
        assert bool((got.t == np.float32(3.0e38)).all())
        assert bool((got.prim == -1).all())


@pytest.mark.cuda
def test_cuda_kernels_negative_mint(cuda_device):
    """Hits behind the origin down to mint < 0 (t may be negative)."""
    o, d, mint, maxt, linC = _soup("random", 130, 20_011, 6, cuda_device)
    mint = torch.full_like(mint, -5.0)
    got, _ = _check_against_plain((o, d, mint, maxt, linC), 130)
    assert bool((got.t[got.valid] < 0).any())


@pytest.mark.cuda
def test_cuda_largest_table_staged_whole(cuda_device):
    """T = 2048: 160 KB of records in one block's shared memory (the
    launch opts in above 48 KB); one more record raises."""
    args = _soup("random", 2048, 20_011, 8, cuda_device)
    assert sweep.pack_linear_mt(args[4]).shape == (2048, 20)
    _check_against_plain(args, 2048)
    big = _soup("random", sweep.MAX_RECORDS + 1, 64, 8, cuda_device)
    k = sweep.make_sweep_intersector(sweep.MAX_RECORDS + 1)
    with pytest.raises(ValueError):
        k(*big)
    assert k.launches == 0


@pytest.mark.cuda
def test_pack_on_card_equals_pack_on_cpu(cuda_device):
    linC = _soup("windowed", 300, 1, 2, cuda_device)[4]
    assert torch.equal(sweep.pack_linear_mt(linC).cpu(),
                       sweep.pack_linear_mt(linC.cpu()))
