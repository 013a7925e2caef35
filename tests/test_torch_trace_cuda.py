"""CUDA traversal kernels against their plain PyTorch versions, on the
card: the pair kernels (csrc/trace.cu) and the v4 / v2 block kernels
(csrc/trace_block.cu, one block walk with two slab tests) against
ops/trace.pair_plain and tri9_plain, v4 also against the pair kernels.
Imports no jax, so the card's machine (which has none) runs it without
the repo's conftest:

    python -m pytest --noconftest tests/test_torch_trace_cuda.py -m cuda -q

Without a card every case skips.  The soups come from
ops/trace.random_cluster_soup, as in the CPU tests and chip_smoke.py, and
from tie_soup here (which test_torch_trace.py also runs through the plain
version)."""
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


# the tie soup's duplicated triangle: its prim in supercluster 0 (far
# key) and in supercluster 1 (near key)
TIE_LOW, TIE_HIGH = 7 * 128 + 3, 140 * 128 + 3


def tie_soup(n_rays=3001, seed=0):
    """Numpy (o, d, mint, maxt, mt_slabs, cbounds, tri9) of K = 256
    clusters of
    W = 128 (two superclusters) in which visit order would decide ties:
    one triangle T in the plane z = 20 sits in slot 3 of cluster 7 (prim
    TIE_LOW) and of cluster 140 (prim TIE_HIGH), so one lane sweeps both
    copies; each cluster also holds a small triangle at z = 15 off the
    rays' path, so its box is entered before T.  Supercluster 1 also
    holds cluster 150, a sliver along x = y at z = 5, so it is entered
    first.  Every other cluster holds one small
    triangle far off.  Rays start in the plane z = 0 below T, aim along
    +z with a small jitter, and every 5th is dead: a walk near to far
    meets TIE_HIGH first, and among equal minimal t the lowest prim
    (TIE_LOW) must win."""
    K, W = 256, 128
    v0 = np.zeros((K * W, 3), np.float32)
    e1 = np.zeros_like(v0)
    e2 = np.zeros_like(v0)
    far = np.arange(K, dtype=np.float32)[:, None] * 3 + 1000
    v0[::W] = far
    e1[::W] = (1, 0, 0)
    e2[::W] = (0, 1, 0)
    for k in (7, 140):
        p = k * W
        v0[p + 3], e1[p + 3], e2[p + 3] = (-50, -50, 20), (100, 0, 0), \
            (0, 100, 0)
        v0[p], e1[p], e2[p] = (40, 40, 15), (1, 0, 0), (0, 1, 0)
    p = 150 * W
    v0[p], e1[p], e2[p] = (-60, -60, 5), (120, 120, 0.1), (120, 120.1, 0)
    pts = np.stack([v0, v0 + e1, v0 + e2]).reshape(3, K, W, 3)
    used = np.zeros((K, W), bool)
    used[:, 0] = True
    used[7, 3] = used[140, 3] = True
    lo = np.where(used[None, ..., None], pts, np.inf).min((0, 2))
    hi = np.where(used[None, ..., None], pts, -np.inf).max((0, 2))
    cb = np.float32(np.concatenate([lo, hi], 1))
    slabs = isec.build_mt_slabs(isec.build_linear_mt(v0, e1, e2), W)
    tri9 = trace.tri9_from_soup(isec.TriSoup(*map(torch.from_numpy,
                                                  (v0, e1, e2)),
                                             orig_id=None), W).numpy()
    rs = np.random.RandomState(seed)
    o = np.zeros((n_rays, 3), np.float32)
    o[:, :2] = rs.uniform(-40, -5, (n_rays, 2))
    d = np.ones((n_rays, 3), np.float32)
    d[:, :2] = rs.uniform(-0.05, 0.05, (n_rays, 2))
    d = np.float32(d / np.linalg.norm(d, axis=-1, keepdims=True))
    mint = np.zeros(n_rays, np.float32)
    maxt = np.full(n_rays, 3e38, np.float32)
    maxt[::5] = -1.0
    return o, d, mint, maxt, slabs, cb, tri9


def _assert_pair_matches_plain(rays, slabs, cb, window):
    """Both pair kernels equal pair_plain bit for bit; returns (Hit,
    occluded)."""
    K = cb.shape[0]
    ck = trace.make_pair_intersector(window, K)
    ok = trace.make_pair_occluder(window, K)
    got = ck(*rays, slabs, cb)
    occ = ok(*rays, slabs, cb)
    ref = ck.plain(*rays, slabs, cb)
    ref_occ = ok.plain(*rays, slabs, cb)
    torch.cuda.synchronize()
    assert ck.launches == ok.launches == 1
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert torch.equal(occ, ref_occ)
    dead = rays[3] <= rays[2]
    assert not got.valid[dead].any() and not occ[dead].any()
    return got, occ


@pytest.mark.cuda
@pytest.mark.parametrize("K, window, n", [(300, 128, 10_007),
                                          (300, 256, 10_007),
                                          (40, trace.MAX_WINDOW, 2_003)])
def test_pair_kernels_match_plain(cuda_device, K, window, n):
    """Random soups at W = 128, 256 and MAX_WINDOW (32 chunks of 128 a
    cluster), N not a multiple of a block's 8 rays, dead lanes: both
    kernels equal pair_plain bit for bit."""
    o, d, mint, maxt, slabs, cb, linC, _ = _on(
        cuda_device, trace.random_cluster_soup(K, window, window, n))
    got, occ = _assert_pair_matches_plain((o, d, mint, maxt), slabs, cb,
                                          window)
    assert got.valid.float().mean() > 0.3
    # the whole-soup sweep agrees on which rays hit
    full = isec.intersect_matmul(o, d, mint, maxt, linC)
    assert (got.valid == full.valid).float().mean() >= 0.998
    assert (occ == full.valid).float().mean() >= 0.998


@pytest.mark.cuda
def test_pair_kernels_break_ties_by_lowest_prim(cuda_device):
    """On the tie soup the near-to-far walk meets the higher prim first;
    both kernels still equal pair_plain, which takes the lowest prim."""
    o, d, mint, maxt, slabs, cb, _ = _on(cuda_device, tie_soup())
    got, occ = _assert_pair_matches_plain((o, d, mint, maxt), slabs, cb, 128)
    tie = got.prim == TIE_LOW
    assert tie.float().mean() > 0.5
    assert not bool((got.prim == TIE_HIGH).any())
    assert bool(occ[tie].all())


@pytest.mark.cuda
def test_pair_visit_counts(cuda_device):
    """count_visits launches the same kernel and counts its walk: the same
    hits, and no more swept clusters than the plain version's (ray,
    cluster) pairs against maxt."""
    o, d, mint, maxt, slabs, cb, _, _ = _on(
        cuda_device, trace.random_cluster_soup(300, 128, 2, 5_001))
    ck = trace.make_pair_intersector(128, 300)
    got, swept, supers = ck.count_visits(o, d, mint, maxt, slabs, cb)
    ref = ck(o, d, mint, maxt, slabs, cb)
    torch.cuda.synchronize()
    assert ck.launches == 2
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    ray, _ = trace._candidates(o, d, mint, maxt, trace._super_bounds(cb),
                               trace._member_slabs(cb))
    assert 0 < swept <= ray.shape[0]
    assert 0 < supers <= 3 * int((maxt > mint).sum())


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
def test_pair_kernels_many_superclusters(cuda_device):
    """S = 45 (not a multiple of 32) with empty clusters among the real
    ones, and S = MAX_SUPERS: both kernels equal pair_plain; one more
    supercluster and the wrapper raises."""
    soup = _on(cuda_device, trace.random_cluster_soup(300, 128, 5, 3_001))
    # at the cap the empty boxes spread over [-300, 300]^3: every
    # supercluster box spans the rays' region, few member boxes are entered
    for K_total, spread in ((45 * trace.SUPER_FACTOR, 10),
                            (trace.MAX_SUPERS * trace.SUPER_FACTOR, 300)):
        o, d, mint, maxt, slabs, cb, _, _ = _with_empty_clusters(
            soup, K_total, 5, spread)
        got, _ = _assert_pair_matches_plain((o, d, mint, maxt), slabs, cb,
                                            128)
        assert got.valid.float().mean() > 0.3
    k = trace.make_pair_occluder(128, K_total + 1)
    with pytest.raises(ValueError, match="superclusters"):
        k.box_tables(torch.cat([cb, cb[:1]]))


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


def _block_pair(variant, window, K):
    if variant == "mt":
        return (trace.make_mt_intersector(window, K, ray_sort=False),
                trace.make_mt_occluder(window, K, ray_sort=False))
    return (trace.make_tri9_intersector(window, K),
            trace.make_tri9_occluder(window, K))


VARIANTS = pytest.mark.parametrize("variant", ["mt", "tri9"])


@pytest.mark.cuda
@VARIANTS
def test_mt_kernels_break_ties_by_lowest_prim(cuda_device, variant):
    """The tie soup through v4 and v2, several times: whichever warp
    merges first, the lowest prim among equal minimal t wins, and the
    results equal the plain version bit for bit (v4: also the v7
    kernels)."""
    o, d, mint, maxt, slabs, cb, tri9 = _on(cuda_device, tie_soup())
    rays = (o, d, mint, maxt)
    v7, v7_occ = _assert_pair_matches_plain(rays, slabs, cb, 128)
    table = slabs if variant == "mt" else tri9
    for _ in range(5):
        got, occ = _assert_block_matches_plain(
            *_block_pair(variant, 128, 256), rays, table, cb)
        if variant == "mt":
            for a, b in zip(got, v7):
                assert torch.equal(a, b)
            assert torch.equal(occ, v7_occ)
        assert (got.prim == TIE_LOW).float().mean() > 0.5
        assert not bool((got.prim == TIE_HIGH).any())


@pytest.mark.cuda
@VARIANTS
@pytest.mark.parametrize("K, window", [(100, 128), (300, 128), (129, 256),
                                       (40, trace.MAX_WINDOW)])
@pytest.mark.parametrize("n", [1, 63, 64, 65, 257, 0, 4_099])
def test_mt_kernels_block_edges(cuda_device, variant, K, window, n):
    """S = 1, a short last supercluster (K = 129, 300), W = 128, 256 and
    MAX_WINDOW, and batches of 1, 63, 64, 65, 257 and 0 rays (a partial
    block, a block, a block and one ray, four blocks and one ray, none):
    v4 and v2 equal their plain versions bit for bit."""
    soup = _on(cuda_device,
               trace.random_cluster_soup(K, window, K + n, max(n, 2)))
    o, d, mint, maxt, _, cb, _, _ = soup
    table = _table(variant, soup)
    if n < 2:
        o, d, mint, maxt = o[1:1 + n], d[1:1 + n], mint[1:1 + n], \
            maxt[1:1 + n]      # ray 1 is live
    ck, ok = _block_pair(variant, window, K)
    if n == 0:
        hit, occ = ck(o, d, mint, maxt, table, cb), ok(o, d, mint, maxt,
                                                      table, cb)
        torch.cuda.synchronize()
        assert hit.t.shape == hit.prim.shape == occ.shape == (0,)
        assert ck.launches == ok.launches == 1
        return
    got, occ = _assert_block_matches_plain(ck, ok, (o, d, mint, maxt),
                                           table, cb)
    dead = maxt <= mint
    assert not got.valid[dead].any() and not occ[dead].any()


@pytest.mark.cuda
@VARIANTS
def test_mt_kernels_at_the_supercluster_cap(cuda_device, variant):
    """S = MAX_SUPERS with empty clusters spread wide (every block's
    worklist holds thousands of entries): v4 and v2 equal their plain
    versions; one more supercluster and the wrapper raises."""
    soup = _on(cuda_device, trace.random_cluster_soup(300, 128, 5, 1_001))
    K_total = trace.MAX_SUPERS * trace.SUPER_FACTOR
    big = _with_empty_clusters(soup, K_total, 5, 300)
    o, d, mint, maxt, _, cb, _, _ = big
    got, _ = _assert_block_matches_plain(*_block_pair(variant, 128, K_total),
                                         (o, d, mint, maxt),
                                         _table(variant, big), cb)
    assert got.valid.float().mean() > 0.3
    with pytest.raises(ValueError, match="superclusters"):
        _block_pair(variant, 128, K_total + 1)[1].box_tables(
            torch.cat([cb, cb[:1]]))


@pytest.mark.cuda
@VARIANTS
def test_mt_kernels_dead_and_missing_blocks(cuda_device, variant):
    """Whole blocks of dead rays, whole blocks of rays that miss every
    supercluster, and both mixed with live blocks: unhit with the miss
    encoding, and the live rays unchanged."""
    soup = _on(cuda_device, trace.random_cluster_soup(200, 128, 3, 64 * 6))
    o, d, mint, maxt, _, cb, _, _ = soup
    slabs = _table(variant, soup)
    maxt = maxt.clone()
    maxt[64:128] = -1.0                       # a dead block
    o, d = o.clone(), d.clone()
    o[192:256] += 1000.0                      # a block that misses all
    d[192:256] = torch.tensor([1.0, 0.0, 0.0], device=o.device)
    rays = (o, d, mint, maxt)
    got, occ = _assert_block_matches_plain(*_block_pair(variant, 128, 200),
                                           rays, slabs, cb)
    gone = torch.zeros_like(occ)
    gone[64:128] = gone[192:256] = True
    assert not got.valid[gone].any() and not occ[gone].any()
    assert bool((got.t[gone] == np.float32(3.0e38)).all())
    assert bool((got.prim[gone] == -1).all())
    assert bool((got.u[gone] == 0).all() and (got.v[gone] == 0).all())
    assert got.valid[~gone].float().mean() > 0.3
    for sl in (slice(64, 128), slice(192, 256)):      # such a block alone
        part = tuple(x[sl].contiguous() for x in rays)
        alone, alone_occ = _assert_block_matches_plain(
            *_block_pair(variant, 128, 200), part, slabs, cb)
        assert not alone.valid.any() and not alone_occ.any()


@pytest.mark.cuda
@VARIANTS
def test_mt_kernels_negative_mint(cuda_device, variant):
    """Hits at negative t (mint = -5 from inside the cloud): the merged
    (t, prim) words still order as the floats do."""
    soup = _on(cuda_device, trace.random_cluster_soup(200, 128, 8, 3_001))
    o, d, mint, maxt, _, cb, _, _ = soup
    mint = torch.full_like(mint, -5.0)
    got, _ = _assert_block_matches_plain(*_block_pair(variant, 128, 200),
                                         (o, d, mint, maxt),
                                         _table(variant, soup), cb)
    assert bool((got.t[got.valid] < 0).any())


@pytest.mark.cuda
@VARIANTS
def test_mt_visit_counts(cuda_device, variant):
    """count_visits launches the counting instantiation of v4 and of v2:
    the same hits; every (ray, cluster) pair the final t needs is swept
    and no more than the pairs against maxt; a slab is read at most once
    per (block, cluster) pair and at least once per cluster holding a
    hit."""
    soup = _on(cuda_device, trace.random_cluster_soup(300, 128, 2, 5_001))
    o, d, mint, maxt, _, cb, _, _ = soup
    slabs = _table(variant, soup)
    ck, ok = _block_pair(variant, 128, 300)
    ref = ck(o, d, mint, maxt, slabs, cb)
    got, sweeps, reads, entered = ck.count_visits(o, d, mint, maxt, slabs,
                                                  cb)
    occ, o_sweeps, o_reads, _ = ok.count_visits(o, d, mint, maxt, slabs, cb)
    torch.cuda.synchronize()
    assert ck.launches == 2 and ok.launches == 1
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert torch.equal(occ, ref.valid)
    scb, mb = trace._super_bounds(cb), trace._member_slabs(cb)
    ray, k = trace._candidates(o, d, mint, maxt, scb, mb)
    block_pairs = torch.unique(ray // 64 * 300 + k).shape[0]
    need, _ = trace._candidates(o, d, mint,
                                torch.where(ref.valid, ref.t, maxt), scb, mb)
    assert need.shape[0] <= sweeps <= ray.shape[0]
    assert torch.unique(ref.prim[ref.valid] // 128).shape[0] <= reads
    assert reads <= block_pairs and reads <= sweeps
    assert int(ref.valid.sum()) <= o_sweeps <= ray.shape[0]
    assert 0 < o_reads <= block_pairs
    n_blocks = -(-o.shape[0] // 64)
    assert 0 < entered <= 3 * n_blocks


def _with_empty_clusters(soup, K_total, seed, spread=10):
    """The soup with clusters appended up to K_total: all-zero slabs and
    tri9 rows (padding triangles that never hit) inside random unit boxes
    centred in [-spread, spread]^3 (by default among the real clusters, so
    rays walk many superclusters)."""
    o, d, mint, maxt, slabs, cb, linC, tri9 = soup
    K, W = cb.shape[0], tri9.shape[2]
    g = torch.Generator(device=o.device).manual_seed(seed)
    centre = torch.rand((K_total - K, 3), generator=g,
                        device=o.device) * (2 * spread) - spread
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
