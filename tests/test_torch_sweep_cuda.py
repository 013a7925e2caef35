"""CUDA sweep kernels (csrc/sweep.cu) against their plain PyTorch
versions, on the card.  Imports no jax, so the card's machine (which has
none) runs it without the repo's conftest:

    python -m pytest --noconftest tests/test_torch_sweep_cuda.py -m cuda -q

Without a card every case skips."""
import numpy as np
import pytest
import torch

from gradientdomain_mitsuba_tpu_torch.ops import intersect as isec
from gradientdomain_mitsuba_tpu_torch.ops import sweep


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the sweep kernels run only on "
                    "the card)")
    return torch.device("cuda")


def _soup_and_rays(T, seed, n, dev):
    """Random soup [T] and n rays from a seed; every 5th lane is dead."""
    rs = np.random.RandomState(seed)
    v0, e1, e2 = (np.float32(rs.normal(size=(T, 3))) for _ in range(3))
    linC = isec.build_linear_mt(v0, e1, e2)
    o = np.float32(rs.normal(size=(n, 3)) * 3)
    d = np.float32(rs.normal(size=(n, 3)))
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    mint = np.full(n, 1e-4, np.float32)
    maxt = np.full(n, 3e38, np.float32)
    maxt[::5] = -1.0
    return [torch.from_numpy(a).to(dev) for a in (o, d, mint, maxt, linC)]


@pytest.mark.cuda
@pytest.mark.parametrize("T", [3, 36, 130, 2048])
def test_cuda_kernels_match_plain(cuda_device, T):
    args = _soup_and_rays(T, T, 10_007, cuda_device)
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
    o, d, mint, maxt, linC = _soup_and_rays(300, 5, 10_007, cuda_device)
    lin = linC.cpu().numpy()
    padded = np.zeros((10, 4 * 384), np.float32)
    for g in range(4):
        for k in range(3):
            src = lin[:, g * 300 + k * 100:g * 300 + (k + 1) * 100]
            padded[:, g * 384 + k * 128:g * 384 + k * 128 + 100] = src
    padded = torch.from_numpy(padded).to(cuda_device)
    args = (o, d, mint, maxt, padded)
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
    o, d, mint, maxt, linC = _soup_and_rays(8, 0, 64, cuda_device)
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
