"""CUDA traversal kernels against their plain PyTorch versions, on the
card: the pair kernels (csrc/trace.cu) and the v4 / v2 block kernels
(csrc/trace_block.cu) against ops/trace.pair_plain and tri9_plain.
Imports no jax, so the card's machine (which has none) runs it without
the repo's conftest:

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
    o, d, mint, maxt, slabs, cb, linC, _ = _on(
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
    o, d, mint, maxt, slabs, cb, _, _ = _on(
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
    o, d, mint, maxt, slabs, cb, _, _ = _on(
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


BLOCK = [("mt", trace.make_mt_intersector, trace.make_mt_occluder),
         ("tri9", trace.make_tri9_intersector, trace.make_tri9_occluder)]


def _table(variant, soup):
    return soup[4] if variant == "mt" else soup[7]


def _assert_block_matches_plain(ck, ok, rays, table, cb):
    got = ck(*rays, table, cb)
    occ = ok(*rays, table, cb)
    ref = ck.plain(*rays, table, cb)
    ref_occ = ok.plain(*rays, table, cb)
    torch.cuda.synchronize()
    assert ck.launches >= 1 and ok.launches >= 1
    # same arithmetic, lowest prim among equal minimal t: bit for bit
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert torch.equal(occ, ref_occ)
    return got, occ


@pytest.mark.cuda
@pytest.mark.parametrize("window", [128, 256])
@pytest.mark.parametrize("variant, make_c, make_o", BLOCK)
def test_block_kernels_match_plain(cuda_device, variant, make_c, make_o,
                                   window):
    soup = _on(cuda_device,
               trace.random_cluster_soup(300, window, window + 1, 10_007))
    o, d, mint, maxt, _, cb, linC, _ = soup
    ck, ok = make_c(window, 300), make_o(window, 300)
    got, occ = _assert_block_matches_plain(ck, ok, (o, d, mint, maxt),
                                           _table(variant, soup), cb)
    assert got.valid.sum() > 1000
    full = isec.intersect_matmul(o, d, mint, maxt, linC)
    assert (got.valid == full.valid).float().mean() >= 0.998
    assert (occ == full.valid).float().mean() >= 0.998


@pytest.mark.cuda
@pytest.mark.parametrize("variant, make_c, make_o", BLOCK)
def test_block_kernels_dead_lanes_and_miss_encoding(cuda_device, variant,
                                                    make_c, make_o):
    soup = _on(cuda_device, trace.random_cluster_soup(200, 128, 3, 4_099))
    o, d, mint, maxt, _, cb, _, _ = soup
    table = _table(variant, soup)
    hit = make_c(128, 200)(o, d, mint, maxt, table, cb)
    occ = make_o(128, 200)(o, d, mint, maxt, table, cb)
    torch.cuda.synchronize()
    assert not hit.valid[::5].any() and not occ[::5].any()
    miss = ~hit.valid
    assert bool(miss.any())
    assert bool((hit.t[miss] == np.float32(3.0e38)).all())
    assert bool((hit.prim[miss] == -1).all())
    assert bool((hit.u[miss] == 0).all() and (hit.v[miss] == 0).all())
    assert bool((hit.prim[hit.valid] < 200 * 128).all())


@pytest.mark.cuda
def test_mt_kernels_ray_sort_changes_nothing(cuda_device):
    soup = _on(cuda_device, trace.random_cluster_soup(300, 128, 11, 20_001))
    o, d, mint, maxt, slabs, cb, _, _ = soup
    for make in (trace.make_mt_intersector, trace.make_mt_occluder):
        plain_order = make(128, 300, ray_sort=False)(o, d, mint, maxt, slabs,
                                                     cb)
        k = make(128, 300, ray_sort=True)
        sorted_order = k(o, d, mint, maxt, slabs, cb)
        assert k.launches == 1
        for a, b in zip(*((x,) if isinstance(x, torch.Tensor) else x
                          for x in (plain_order, sorted_order))):
            assert torch.equal(a, b)


def _with_empty_clusters(soup, K_total, seed):
    """The soup with clusters appended up to K_total: all-zero slabs and
    tri9 rows (padding triangles that never hit) inside random unit boxes
    among the real clusters, so rays walk many superclusters."""
    o, d, mint, maxt, slabs, cb, linC, tri9 = soup
    K, W = cb.shape[0], tri9.shape[2]
    g = torch.Generator(device=o.device).manual_seed(seed)
    centre = torch.rand((K_total - K, 3), generator=g, device=o.device) * 20 - 10
    cb = torch.cat([cb, torch.cat([centre - 0.5, centre + 0.5], 1)])
    big_slabs = slabs.new_zeros((K_total + 3, 8, 4 * W))
    big_slabs[:K] = slabs[:K]
    big_tri9 = tri9.new_zeros((K_total, 16, W))
    big_tri9[:K] = tri9
    return o, d, mint, maxt, big_slabs, cb.contiguous(), linC, big_tri9


@pytest.mark.cuda
@pytest.mark.parametrize("variant, make_c, make_o", BLOCK)
def test_block_kernels_many_superclusters_and_wide_windows(
        cuda_device, variant, make_c, make_o):
    """S = 513 superclusters (above a 512-entry sort) at W = 128, and
    W = MAX_WINDOW (32 tiles a cluster): kernels equal their plain
    versions."""
    many = _with_empty_clusters(
        _on(cuda_device, trace.random_cluster_soup(300, 128, 5, 3_001)),
        513 * trace.SUPER_FACTOR, 5)
    wide = _on(cuda_device,
               trace.random_cluster_soup(40, trace.MAX_WINDOW, 6, 2_003))
    for soup in (many, wide):
        o, d, mint, maxt, _, cb, _, tri9 = soup
        K, W = cb.shape[0], tri9.shape[2]
        got, _ = _assert_block_matches_plain(
            make_c(W, K), make_o(W, K), (o, d, mint, maxt),
            _table(variant, soup), cb)
        assert got.valid.float().mean() > 0.3


@pytest.mark.cuda
@pytest.mark.parametrize("variant, make_c, make_o", BLOCK)
def test_block_wrappers_reject_bad_inputs(cuda_device, variant, make_c,
                                          make_o):
    soup = _on(cuda_device, trace.random_cluster_soup(20, 128, 0, 64))
    o, d, mint, maxt, _, cb, _, _ = soup
    table = _table(variant, soup)
    k = make_c(128, 20)
    with pytest.raises(TypeError):
        k(o.double(), d, mint, maxt, table, cb)
    with pytest.raises(ValueError):
        k(o, d, mint, maxt, table, cb[:10])
    with pytest.raises(ValueError):
        k(o, d, mint.cpu(), maxt, table, cb)
    with pytest.raises(ValueError):
        make_o(256, 20)(o, d, mint, maxt, table, cb)
    shifted = table.new_empty(table.numel() + 1)[1:].view(table.shape)
    shifted.copy_(table)                     # contiguous, 4-byte aligned
    with pytest.raises(ValueError, match="aligned"):
        k(o, d, mint, maxt, shifted, cb)
    assert k.launches == 0
