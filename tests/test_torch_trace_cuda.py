"""CUDA pair kernels (csrc/trace.cu) against their plain PyTorch version
(ops/trace.pair_plain), on the card.  Imports no jax, so the card's
machine (which has none) runs it without the repo's conftest:

    python -m pytest --noconftest tests/test_torch_trace_cuda.py -m cuda -q

Without a card every case skips.  The soups come from
ops/trace.random_cluster_soup, as in the CPU tests and chip_smoke.py."""
import numpy as np
import pytest
import torch

from gradientdomain_mitsuba_tpu_torch.ops import intersect as isec
from gradientdomain_mitsuba_tpu_torch.ops import trace


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the pair kernels run only on "
                    "the card)")
    return torch.device("cuda")


def _on(dev, arrays):
    return [torch.from_numpy(a).to(dev) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("window", [128, 256])
def test_pair_kernels_match_plain(cuda_device, window):
    o, d, mint, maxt, slabs, cb, linC = _on(
        cuda_device, trace.random_cluster_soup(300, window, window, 10_007))
    K = cb.shape[0]
    ck = trace.make_pair_intersector(window, K)
    got = ck(o, d, mint, maxt, slabs, cb)
    ref = ck.plain(o, d, mint, maxt, slabs, cb)
    torch.cuda.synchronize()
    assert ck.launches == 1
    assert (got.valid == ref.valid).float().mean() >= 0.998
    both = got.valid & ref.valid
    same = both & (got.prim == ref.prim)
    assert same.sum() >= 0.995 * both.sum()
    assert both.sum() > 1000
    torch.testing.assert_close(got.t[same], ref.t[same], rtol=1e-5, atol=0)
    # the whole-soup sweep agrees on which rays hit
    full = isec.intersect_matmul(o, d, mint, maxt, linC)
    assert (got.valid == full.valid).float().mean() >= 0.998
    ok = trace.make_pair_occluder(window, K)
    occ = ok(o, d, mint, maxt, slabs, cb)
    assert ok.launches == 1
    assert (occ == ok.plain(o, d, mint, maxt, slabs, cb)).float().mean() \
        >= 0.998


@pytest.mark.cuda
def test_pair_kernels_dead_lanes_and_miss_encoding(cuda_device):
    o, d, mint, maxt, slabs, cb, _ = _on(
        cuda_device, trace.random_cluster_soup(200, 128, 3, 4_099))
    K = cb.shape[0]
    hit = trace.make_pair_intersector(128, K)(o, d, mint, maxt, slabs, cb)
    occ = trace.make_pair_occluder(128, K)(o, d, mint, maxt, slabs, cb)
    torch.cuda.synchronize()
    assert not hit.valid[::5].any() and not occ[::5].any()
    miss = ~hit.valid
    assert bool(miss.any())
    assert bool((hit.t[miss] == np.float32(3.0e38)).all())
    assert bool((hit.prim[miss] == -1).all())
    assert bool((hit.u[miss] == 0).all() and (hit.v[miss] == 0).all())
    assert bool((hit.prim[hit.valid] < K * 128).all())


@pytest.mark.cuda
def test_pair_wrapper_rejects_bad_inputs(cuda_device):
    o, d, mint, maxt, slabs, cb, _ = _on(
        cuda_device, trace.random_cluster_soup(20, 128, 0, 64))
    k = trace.make_pair_intersector(128, 20)
    with pytest.raises(TypeError):
        k(o.double(), d, mint, maxt, slabs, cb)
    with pytest.raises(ValueError):
        k(o, d, mint, maxt, slabs, cb[:10])
    with pytest.raises(ValueError):
        k(o, d, mint.cpu(), maxt, slabs, cb)
    with pytest.raises(ValueError):
        trace.make_pair_intersector(256, 20)(o, d, mint, maxt, slabs, cb)
    assert k.launches == 0
