"""Port traversal (ops/trace.py, ops/intersect.py): the plain PyTorch
versions (the CPU path and the oracles of the CUDA kernels) against the
reference's v7 pair kernels (make_pair_intersector / make_pair_occluder),
v4 kernels (make_pallas_mt_intersector / _occluder) and v2 kernels
(make_pallas_intersector / _occluder), run in Pallas interpret mode as
tests/test_pallas.py runs them, and against the reference's
intersect_brute.  The CUDA kernels themselves are tested on the card in
test_torch_trace_cuda.py.

Thresholds (as tests/test_pallas.py holds v7): valid equal on >= 0.998
of lanes, prim equal on >= 0.995 of lanes both hit, t within rtol 1e-5
where the prims agree, occluded equal on >= 0.998 of lanes."""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from gradientdomain_mitsuba_tpu.ops import common as ref_common
from gradientdomain_mitsuba_tpu.ops import intersect as ref_isec
from gradientdomain_mitsuba_tpu.ops import pallas_trace as ptr
from gradientdomain_mitsuba_tpu.scene import scene as ref_scene
from gradientdomain_mitsuba_tpu_torch.ops import common
from gradientdomain_mitsuba_tpu_torch.ops import intersect as isec
from gradientdomain_mitsuba_tpu_torch.ops import trace
from gradientdomain_mitsuba_tpu_torch.scene import bridge
from gradientdomain_mitsuba_tpu_torch.scene import scene as port_scene
from test_torch_path import write_small_forest
from test_torch_trace_cuda import TIE_HIGH, TIE_LOW, tie_soup
from torch_parity import one_thread  # noqa: F401

# torch on one thread: the suite runs six workers, and a multi-threaded
# CPU torch among them spends the renders' time contending for cores
pytestmark = pytest.mark.usefixtures("one_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARS = {"width": "16", "height": "16", "spp": "1", "maxDepth": "2"}


@pytest.fixture(scope="module")
def interpret_pallas():
    mp = pytest.MonkeyPatch()
    mp.setattr(ptr.pl, "pallas_call",
               functools.partial(pl.pallas_call, interpret=True))
    yield
    mp.undo()


def _mats_scene_with_slabs():
    """tests/test_pallas.py's recipe: cbox-mats with slabs built the way
    the loader builds them for large scenes."""
    scene, st = ref_scene.load_scene(
        os.path.join(ROOT, "data/scenes/cbox-mats/cbox-mats.xml"), VARS)
    g = scene.geom
    linC_full = ref_isec.build_linear_mt(g.tris.v0, g.tris.e1, g.tris.e2)
    return scene, st, ptr.build_mt_slabs(np.asarray(linC_full),
                                         st.cluster_window)


@pytest.fixture(scope="module")
def small_forest(tmp_path_factory):
    path = write_small_forest(tmp_path_factory.mktemp("forest") /
                              "forest.xml")
    scene, st = ref_scene.load_scene(path, VARS)
    return path, scene, st


def _rays(seed, n, lo, hi, maxt_val):
    """Random rays from a box; every 7th lane dead (maxt = -1)."""
    rs = np.random.RandomState(seed)
    o = np.float32(rs.uniform(lo, hi, (n, 3)))
    d = np.float32(rs.normal(size=(n, 3)))
    d = np.float32(d / np.linalg.norm(d, axis=-1, keepdims=True))
    mint = np.zeros(n, np.float32)
    maxt = np.full(n, maxt_val, np.float32)
    maxt[::7] = -1.0
    return o, d, mint, maxt


def _cases(small_forest):
    """(name, reference scene, settings, slabs, rays): cbox-mats and the
    small forest, N not a multiple of 1024."""
    mats, mst, mslabs = _mats_scene_with_slabs()
    _, forest, fst = small_forest
    return {
        "cbox-mats": (mats, mst, mslabs,
                      _rays(0, 2500, [50] * 3, [500] * 3, 3e38),
                      _rays(3, 1500, [50] * 3, [500] * 3, 400.0)),
        "forest": (forest, fst, np.asarray(forest.geom.mt_slabs),
                   _rays(1, 3001, [-300, 0, -300], [450, 300, 450], 3e38),
                   _rays(4, 2001, [-300, 0, -300], [450, 300, 450], 200.0)),
    }


@pytest.fixture(scope="module")
def hits(interpret_pallas, small_forest):
    """Reference v7 (interpret mode) and port plain results per case."""
    out = {}
    for name, (scene, st, slabs, cam, sh) in _cases(small_forest).items():
        cb = np.asarray(scene.geom.cbounds)
        K, W = cb.shape[0], st.cluster_window
        ref_h = ptr.make_pair_intersector(W, K)(
            *map(jnp.asarray, cam), jnp.asarray(slabs), jnp.asarray(cb))
        ref_o = ptr.make_pair_occluder(W, K)(
            *map(jnp.asarray, sh), jnp.asarray(slabs), jnp.asarray(cb))
        ck = trace.make_pair_intersector(W, K)
        ok = trace.make_pair_occluder(W, K)
        got_h = ck(*map(torch.from_numpy, cam), torch.from_numpy(slabs),
                   torch.from_numpy(cb))
        got_o = ok(*map(torch.from_numpy, sh), torch.from_numpy(slabs),
                   torch.from_numpy(cb))
        assert ck.launches == ok.launches == 0   # CPU: plain version
        out[name] = dict(scene=scene, cam=cam, ref_h=ref_h, got_h=got_h,
                         ref_o=np.asarray(ref_o), got_o=got_o.numpy())
    return out


CASES = ["cbox-mats", "forest"]


@pytest.mark.parametrize("case", CASES)
def test_plain_closest_matches_v7(hits, case):
    h = hits[case]
    rv, gv = np.asarray(h["ref_h"].valid), h["got_h"].valid.numpy()
    assert (rv == gv).mean() >= 0.998
    assert rv.mean() > 0.2
    both = rv & gv
    same = np.asarray(h["ref_h"].prim)[both] == h["got_h"].prim.numpy()[both]
    assert same.mean() >= 0.995
    mk = both.copy()
    mk[both] &= same
    np.testing.assert_allclose(h["got_h"].t.numpy()[mk],
                               np.asarray(h["ref_h"].t)[mk], rtol=1e-5)


@pytest.mark.parametrize("case", CASES)
def test_plain_dead_lanes_and_miss_encoding(hits, case):
    h = hits[case]["got_h"]
    assert not h.valid.numpy()[::7].any()
    assert not hits[case]["got_o"][::7].any()
    miss = ~h.valid.numpy()
    np.testing.assert_array_equal(h.t.numpy()[miss], np.float32(3.0e38))
    np.testing.assert_array_equal(h.prim.numpy()[miss], -1)
    np.testing.assert_array_equal(h.u.numpy()[miss], 0.0)


@pytest.mark.parametrize("case", CASES)
def test_plain_occluder_matches_v7(hits, case):
    h = hits[case]
    assert (h["got_o"] == h["ref_o"]).mean() >= 0.998
    assert 0.05 < h["got_o"].mean() < 0.95


def test_fill_intersection_on_pair_hits(hits):
    """Shading records of the forest hits, field by field: prims index
    tri_shade in the same slot space in both packages."""
    h = hits["forest"]
    scene = h["scene"]
    o, d = (jnp.asarray(a) for a in h["cam"][:2])
    ref = ref_common.fill_intersection(scene, o, d, h["ref_h"])
    port = common.fill_intersection(bridge.to_torch(scene, "cpu"),
                                    *map(torch.from_numpy, h["cam"][:2]),
                                    h["got_h"])
    valid = np.asarray(ref.valid)
    np.testing.assert_array_equal(port.valid.numpy(), valid)
    for f in ("prim_id", "shape_id", "bsdf_id", "emitter_id"):
        np.testing.assert_array_equal(getattr(port, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    np.testing.assert_array_equal(port.t.numpy(), np.asarray(ref.t))
    np.testing.assert_allclose(port.p.numpy()[valid],
                               np.asarray(ref.p)[valid], rtol=1e-6, atol=0)
    np.testing.assert_array_equal(port.ng.numpy()[valid],
                                  np.asarray(ref.ng)[valid])
    # u and v differ from the reference by float rounding (up to ~4e-4
    # on grazing hits: its CPU matmul fuses the ray features into FMAs,
    # the port rounds each product), so the interpolated shading normal
    # and uv agree to ~2e-5
    for f in ("ns", "uv"):
        np.testing.assert_allclose(getattr(port, f).numpy()[valid],
                                   np.asarray(getattr(ref, f))[valid],
                                   rtol=0, atol=1e-4, err_msg=f)


def test_loader_cluster_tables_match_reference(small_forest):
    """The port's loader lays the forest out exactly as the reference's:
    slabs, cluster bounds and shading rows are bit-identical."""
    path, ref, rst = small_forest
    port, pst = port_scene.load_scene(path, VARS)
    assert pst.cluster_window == rst.cluster_window == 128
    assert ref.geom.cbounds.shape[0] > trace.SUPER_FACTOR   # S >= 2
    for f in ("mt_slabs", "cbounds", "tri_shade"):
        np.testing.assert_array_equal(getattr(port.geom, f),
                                      np.asarray(getattr(ref.geom, f)),
                                      err_msg=f)


def test_super_and_member_bounds_match_reference(small_forest):
    cb = np.asarray(small_forest[1].geom.cbounds)
    np.testing.assert_array_equal(
        trace._super_bounds(torch.from_numpy(cb)).numpy(),
        np.asarray(ptr._super_bounds(jnp.asarray(cb))))
    np.testing.assert_array_equal(
        trace._member_slabs(torch.from_numpy(cb)).numpy(),
        np.asarray(ptr._member_slabs(jnp.asarray(cb))))


@pytest.mark.parametrize("window", [128, 256])
def test_plain_matches_whole_soup_sweep(window):
    """Multi-cluster random soups at W = 128 and 256: the pair traversal
    finds the whole-soup sweep's hits (same prim slots)."""
    o, d, mint, maxt, slabs, cb, linC, _ = map(
        torch.from_numpy,
        trace.random_cluster_soup(150, window, window, 1501))
    got = trace.make_pair_intersector(window, 150)(o, d, mint, maxt,
                                                   slabs, cb)
    ref = isec.intersect_matmul(o, d, mint, maxt, linC)
    assert (got.valid == ref.valid).float().mean() >= 0.998
    assert ref.valid.float().mean() > 0.3
    both = got.valid & ref.valid
    assert (got.prim[both] == ref.prim[both]).float().mean() >= 0.995
    torch.testing.assert_close(got.t[both], ref.t[both], rtol=1e-5, atol=0)
    occ = trace.make_pair_occluder(window, 150)(o, d, mint, maxt, slabs,
                                                cb)
    assert (occ == ref.valid).float().mean() >= 0.998


@pytest.mark.parametrize("make", [trace.make_pair_occluder,
                                  trace.make_pair_intersector,
                                  trace.make_mt_occluder,
                                  trace.make_mt_intersector,
                                  trace.make_tri9_occluder,
                                  trace.make_tri9_intersector])
def test_box_tables_shared_by_both_kernel_classes(make):
    """The v7, v4 and v2 kernels read the same SoA box tables, from one
    method of their common base: equal to _super_bounds (as rows) and
    _member_slabs, built once per cbounds, and what _kernel_tables hands
    the launch (with S)."""
    cb = torch.from_numpy(trace.random_cluster_soup(300, 128, 5, 8)[5])
    k = make(128, 300)
    assert type(k).box_tables is trace.TraversalKernel.box_tables
    sb, members = k.box_tables(cb)
    assert k.box_tables(cb)[0] is sb and k.box_tables(cb)[1] is members
    torch.testing.assert_close(sb, trace._super_bounds(cb).T.contiguous(),
                               rtol=0, atol=0)
    torch.testing.assert_close(members, trace._member_slabs(cb), rtol=0,
                               atol=0)
    tables, S = k._kernel_tables(cb)
    assert S == 3 and tables[0] is sb and tables[1] is members
    assert k._kernel_tables(cb)[0][0] is sb
    assert k.box_tables(cb.clone())[0] is not sb


def test_block_kernel_tables_by_variant():
    """Both block variants read the SoA box tables through the base
    class's _kernel_tables and count their walk (three counters, which
    come from the card); neither has the pair kernels' ray counter."""
    cb = torch.from_numpy(trace.random_cluster_soup(300, 128, 5, 8)[5])
    rays = [torch.zeros((4, 3)), torch.ones((4, 3)), torch.zeros(4),
            torch.ones(4)]
    for k, table in ((trace.make_mt_intersector(128, 300),
                      torch.zeros((303, 8, 512))),
                     (trace.make_tri9_occluder(128, 300),
                      torch.zeros((300, 16, 128)))):
        assert type(k)._kernel_tables is trace.TraversalKernel._kernel_tables
        (sb, members), S = k._kernel_tables(cb)
        assert S == 3 and sb.shape == (6, 3)
        assert members.shape == (3, 8, trace.SUPER_FACTOR)
        assert k.n_stats == 3 and k._extra(cb.device, None) == [None]
        with pytest.raises(ValueError, match="CUDA kernel"):
            k.count_visits(*rays, table, cb)
    assert not trace.make_tri9_intersector(128, 300).ray_sort


def test_pair_box_tables_built_once_per_table():
    """The pair kernels' SoA box tables equal _super_bounds (as rows) and
    _member_slabs, are built once per cbounds table, and are refused
    above MAX_SUPERS superclusters."""
    cb = torch.from_numpy(trace.random_cluster_soup(300, 128, 5, 8)[5])
    k = trace.make_pair_occluder(128, 300)
    sb, members = k.box_tables(cb)
    assert k.box_tables(cb)[0] is sb and k.box_tables(cb)[1] is members
    assert sb.shape == (6, 3) and sb.is_contiguous()
    assert members.shape == (3, 8, trace.SUPER_FACTOR)
    assert members.is_contiguous()
    torch.testing.assert_close(sb, trace._super_bounds(cb).T, rtol=0,
                               atol=0)
    torch.testing.assert_close(members, trace._member_slabs(cb), rtol=0,
                               atol=0)
    assert k.box_tables(cb.clone())[0] is not sb
    many = torch.zeros((trace.SUPER_FACTOR * trace.MAX_SUPERS + 1, 6))
    with pytest.raises(ValueError, match="superclusters"):
        trace.make_pair_intersector(128, many.shape[0]).box_tables(many)
    trace.make_pair_intersector(128, many.shape[0] - 1).box_tables(many[1:])


def test_plain_breaks_ties_by_lowest_prim():
    """The tie soup (one triangle in two superclusters, the higher prim
    in the nearer one): the pair wrappers on the CPU take the lowest prim
    among equal minimal t, as the kernels must; so do the v2 wrappers
    over the soup's tri9 rows."""
    o, d, mint, maxt, slabs, cb, tri9 = map(torch.from_numpy, tie_soup(601))
    for make_c, make_o, table in (
            (trace.make_pair_intersector, trace.make_pair_occluder, slabs),
            (trace.make_tri9_intersector, trace.make_tri9_occluder, tri9)):
        hit = make_c(128, 256)(o, d, mint, maxt, table, cb)
        occ = make_o(128, 256)(o, d, mint, maxt, table, cb)
        tie = hit.prim == TIE_LOW
        assert tie.float().mean() > 0.5
        assert not bool((hit.prim == TIE_HIGH).any())
        assert bool(occ[tie].all()) and not bool(occ[::5].any())
        torch.testing.assert_close(hit.t[tie], 20.0 / d[tie, 2], rtol=1e-5,
                                   atol=0)


def test_window_and_super_factor_checks(monkeypatch):
    for bad in (64, 200, trace.MAX_WINDOW + 128):
        with pytest.raises(ValueError):
            trace.make_pair_intersector(bad, 10)
    trace.make_pair_occluder(trace.MAX_WINDOW, 10)
    monkeypatch.setattr(trace, "SUPER_FACTOR", 64)
    with pytest.raises(ValueError):
        trace.make_pair_occluder(128, 10)


def test_choose_intersector_large_scene(small_forest):
    _, _, st = small_forest
    closest, occl = common.choose_intersector(st, 25476, 558)
    assert isinstance(closest.kernel, trace.PairKernel)
    assert (closest.kernel.name, occl.kernel.name) == ("pair_closest",
                                                       "pair_occluded")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        common.choose_intersector(st, 25476, 0)


# --- v4 and v2 (the block kernels' plain versions), brute force, ray sort


@pytest.fixture(scope="module")
def block_hits(interpret_pallas, small_forest):
    """Per case: the reference's v4 and v2 (interpret mode) and the port's
    v4 / v2 wrappers on the CPU (pair_plain / tri9_plain), closest hit on
    the camera rays and any hit on the shadow rays, and the reference's
    intersect_brute / occluded_brute on the same rays."""
    out = {}
    for name, (scene, st, slabs, cam, sh) in _cases(small_forest).items():
        cb = np.asarray(scene.geom.cbounds)
        tri9 = np.asarray(scene.geom.tri9)
        K, W = cb.shape[0], st.cluster_window
        ref, port = {}, {}
        for kernel, table, make in (
                ("v4", slabs, (ptr.make_pallas_mt_intersector,
                               ptr.make_pallas_mt_occluder,
                               trace.make_mt_intersector,
                               trace.make_mt_occluder)),
                ("v2", tri9, (ptr.make_pallas_intersector,
                              ptr.make_pallas_occluder,
                              trace.make_tri9_intersector,
                              trace.make_tri9_occluder))):
            jt, jc = jnp.asarray(table), jnp.asarray(cb)
            ref[kernel] = (make[0](W, K)(*map(jnp.asarray, cam), jt, jc),
                           np.asarray(make[1](W, K)(*map(jnp.asarray, sh),
                                                    jt, jc)))
            tt, tc = torch.from_numpy(table), torch.from_numpy(cb)
            ck, ok = make[2](W, K), make[3](W, K)
            port[kernel] = (ck(*map(torch.from_numpy, cam), tt, tc),
                            ok(*map(torch.from_numpy, sh), tt, tc).numpy())
            assert ck.launches == ok.launches == 0   # CPU: plain version
        tris = scene.geom.tris
        brute = (ref_isec.intersect_brute(*map(jnp.asarray, cam), tris,
                                          chunk=1024),
                 np.asarray(ref_isec.occluded_brute(
                     *map(jnp.asarray, sh), tris, chunk=1024)))
        out[name] = dict(ref=ref, port=port, brute=brute)
    return out


def _assert_hits_agree(ref, got):
    """Reference Hit (jax) vs port Hit (torch) at the round's thresholds."""
    rv, gv = np.asarray(ref.valid), got.valid.numpy()
    assert (rv == gv).mean() >= 0.998
    assert rv.mean() > 0.2
    both = rv & gv
    same = np.asarray(ref.prim)[both] == got.prim.numpy()[both]
    assert same.mean() >= 0.995
    mk = both.copy()
    mk[both] &= same
    np.testing.assert_allclose(got.t.numpy()[mk], np.asarray(ref.t)[mk],
                               rtol=1e-5)
    miss = ~gv
    np.testing.assert_array_equal(got.t.numpy()[miss], np.float32(3.0e38))
    np.testing.assert_array_equal(got.prim.numpy()[miss], -1)
    assert not gv[::7].any()                 # dead lanes


BLOCK_KERNELS = ["v4", "v2"]


@pytest.mark.parametrize("kernel", BLOCK_KERNELS)
@pytest.mark.parametrize("case", CASES)
def test_block_plain_closest_matches_reference(block_hits, case, kernel):
    h = block_hits[case]
    _assert_hits_agree(h["ref"][kernel][0], h["port"][kernel][0])


@pytest.mark.parametrize("kernel", BLOCK_KERNELS)
@pytest.mark.parametrize("case", CASES)
def test_block_plain_occluder_matches_reference(block_hits, case, kernel):
    ref, got = block_hits[case]["ref"][kernel][1], \
        block_hits[case]["port"][kernel][1]
    assert (got == ref).mean() >= 0.998
    assert 0.05 < got.mean() < 0.95
    assert not got[::7].any()


@pytest.mark.parametrize("case", CASES)
def test_tri9_plain_matches_brute(block_hits, case):
    h = block_hits[case]
    _assert_hits_agree(h["brute"][0], h["port"]["v2"][0])
    assert (h["port"]["v2"][1] == h["brute"][1]).mean() >= 0.998


def _random_soup_tris(seed, T):
    rs = np.random.RandomState(seed)
    v0, e1, e2 = (np.float32(rs.normal(size=(T, 3)) * s)
                  for s in (4.0, 1.0, 1.0))
    return v0, e1, e2


@pytest.mark.parametrize("case", ["cbox-mats", "random"])
def test_intersect_brute_matches_reference(case):
    if case == "cbox-mats":
        scene, _, _ = _mats_scene_with_slabs()
        v0, e1, e2 = (np.asarray(getattr(scene.geom.tris, f))
                      for f in ("v0", "e1", "e2"))
        cam = _rays(0, 1500, [50] * 3, [500] * 3, 3e38)
    else:
        v0, e1, e2 = _random_soup_tris(2, 700)
        cam = _rays(5, 1200, [-6] * 3, [6] * 3, 3e38)
    ref_tris = ref_isec.TriSoup(*map(jnp.asarray, (v0, e1, e2)),
                                orig_id=jnp.zeros(len(v0), jnp.int32))
    ref = ref_isec.intersect_brute(*map(jnp.asarray, cam), ref_tris,
                                   chunk=512)
    tris = isec.TriSoup(*map(torch.from_numpy, (v0, e1, e2)), orig_id=None)
    got = isec.intersect_brute(*map(torch.from_numpy, cam), tris, chunk=512,
                               ray_chunk=500)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    assert got.valid.numpy().mean() > 0.2
    m = np.asarray(ref.valid)
    np.testing.assert_array_equal(got.prim.numpy()[m], np.asarray(ref.prim)[m])
    np.testing.assert_array_equal(got.prim.numpy()[~m], -1)
    np.testing.assert_allclose(got.t.numpy()[m], np.asarray(ref.t)[m],
                               rtol=1e-5)
    sh = list(cam)
    sh[3] = np.where(cam[3] > 0, np.float32(8.0), cam[3])
    np.testing.assert_array_equal(
        isec.occluded_brute(*map(torch.from_numpy, sh), tris).numpy(),
        np.asarray(ref_isec.occluded_brute(*map(jnp.asarray, sh), ref_tris)))


def test_sort_rays_matches_reference():
    """Same keys, the same order where keys are distinct, and an exact
    round trip (sort, then put back)."""
    rs = np.random.RandomState(7)
    N = 3000
    o = np.float32(rs.uniform(-5, 5, (N, 3)))
    d = np.float32(rs.normal(size=(N, 3)))
    mint = np.float32(rs.uniform(0, 1, N))
    maxt = np.float32(rs.uniform(10, 20, N))
    bmin = np.float32([-4.0, -5.0, -3.0])     # clips some origins
    bmax = np.float32([5.0, 2.0, 5.0])
    np.testing.assert_array_equal(
        trace._part1by2(torch.arange(1024, dtype=torch.int32)).numpy(),
        np.asarray(ptr._part1by2(jnp.arange(1024, dtype=jnp.int32))))
    rso, rsd, rmi, rma, rinv = ptr.sort_rays(
        *map(jnp.asarray, (o, d, mint, maxt, bmin, bmax)))
    so, sd, smi, sma, inv = trace.sort_rays(
        *map(torch.from_numpy, (o, d, mint, maxt, bmin, bmax)))
    tb = (torch.from_numpy(bmin), torch.from_numpy(bmax))
    keys = trace.ray_sort_keys(so, sd, *tb)
    ref_keys = trace.ray_sort_keys(torch.from_numpy(np.array(rso)),
                                   torch.from_numpy(np.array(rsd)), *tb)
    np.testing.assert_array_equal(keys.numpy(), ref_keys.numpy())
    assert bool((keys[1:] >= keys[:-1]).all())
    assert len(np.unique(keys.numpy())) > N // 2
    _, first, counts = np.unique(keys.numpy(), return_index=True,
                                 return_counts=True)
    lone = first[counts == 1]
    np.testing.assert_array_equal(inv.numpy()[lone], np.asarray(rinv)[lone])
    for x, y in ((so, o), (sd, d), (smi, mint), (sma, maxt)):
        back = torch.empty_like(x).index_put_((inv,), x)
        np.testing.assert_array_equal(back.numpy(), y)


@pytest.mark.parametrize("any_hit", [False, True])
def test_sorted_call_returns_the_unsorted_results(any_hit):
    o, d, mint, maxt, slabs, cb, _, _ = map(
        torch.from_numpy, trace.random_cluster_soup(150, 128, 9, 1001))
    k = (trace.make_mt_occluder if any_hit else trace.make_mt_intersector)(
        128, 150)
    plain = k(o, d, mint, maxt, slabs, cb)
    got = trace.sorted_call(lambda *r: k(*r, slabs, cb), any_hit, o, d, mint,
                            maxt, cb[:, :3].amin(0), cb[:, 3:].amax(0))
    for a, b in zip(*((x,) if any_hit else x for x in (got, plain))):
        assert torch.equal(a, b)


def test_tri9_from_soup_matches_loader(small_forest):
    path, ref, rst = small_forest
    port, pst = port_scene.load_scene(path, VARS)
    tris = isec.TriSoup(*(torch.from_numpy(np.asarray(getattr(port.geom.tris,
                                                              f)))
                          for f in ("v0", "e1", "e2")), orig_id=None)
    got = trace.tri9_from_soup(tris, pst.cluster_window)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref.geom.tri9))


def test_block_wrappers_on_the_cpu_run_the_plain_versions():
    o, d, mint, maxt, slabs, cb, _, tri9 = map(
        torch.from_numpy, trace.random_cluster_soup(300, 256, 4, 777))
    for make, table, plain in (
            (trace.make_mt_intersector, slabs, trace.pair_plain),
            (trace.make_tri9_intersector, tri9, trace.tri9_plain)):
        k = make(256, 300)
        got = k(o, d, mint, maxt, table, cb)
        ref = plain(o, d, mint, maxt, table, cb, 256)
        assert k.launches == 0
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
        assert ref.valid.float().mean() > 0.3
    names = [f(128, 10).name for f in (
        trace.make_mt_intersector, trace.make_mt_occluder,
        trace.make_tri9_intersector, trace.make_tri9_occluder)]
    assert names == ["mt_closest", "mt_occluded", "tri9_closest",
                     "tri9_occluded"]
    with pytest.raises(ValueError):
        trace.BlockKernel("v3", False, 128, 10)
    with pytest.raises(ValueError):
        trace.make_tri9_intersector(200, 10)
    many = torch.zeros((trace.SUPER_FACTOR * trace.MAX_SUPERS + 1, 6))
    with pytest.raises(ValueError, match="superclusters"):
        trace.make_tri9_occluder(128, many.shape[0]).box_tables(many)
    with pytest.raises(ValueError, match="superclusters"):
        trace.make_mt_occluder(128, many.shape[0]).box_tables(many)


@pytest.mark.parametrize("setting", [None, "pairs", "v4"])
def test_choose_intersector_reads_gdmt_kernel(small_forest, monkeypatch,
                                              setting):
    if setting is None:
        monkeypatch.delenv("GDMT_KERNEL", raising=False)
    else:
        monkeypatch.setenv("GDMT_KERNEL", setting)
    _, _, st = small_forest
    closest, occl = common.choose_intersector(st, 25476, 558)
    prefix = "mt" if setting == "v4" else "pair"
    assert (closest.kernel.name, occl.kernel.name) == (f"{prefix}_closest",
                                                       f"{prefix}_occluded")
    assert isinstance(closest.kernel, trace.BlockKernel) == (setting == "v4")


def test_bvh_builder_source_is_the_reference_copy():
    """The port compiles its own copy of the BVH builder, byte-identical
    to the reference's, so both packages lay prims out alike."""
    from gradientdomain_mitsuba_tpu_torch import native
    port_pkg = os.path.join(ROOT, "gradientdomain_mitsuba_tpu_torch")
    assert os.path.commonpath([native.BVH_SOURCE, port_pkg]) == port_pkg
    ref = os.path.join(ROOT, "gradientdomain_mitsuba_tpu", "native",
                       "bvh_builder.cpp")
    with open(native.BVH_SOURCE, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()
