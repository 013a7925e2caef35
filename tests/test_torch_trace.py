"""Port pair traversal (ops/trace.py): the plain PyTorch version (the CPU
path and the oracle of the CUDA kernels) against the reference's v7
pair kernels, make_pair_intersector / make_pair_occluder, run in Pallas
interpret mode as tests/test_pallas.py runs them.  The CUDA kernels
themselves are tested on the card in test_torch_trace_cuda.py.

Thresholds (as tests/test_pallas.py holds v7): valid equal on >= 0.998
of lanes, prim equal on >= 0.995 of lanes both hit, t within rtol 1e-5
where the prims agree, occluded equal on >= 0.998 of lanes."""
import functools
import os

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
    o, d, mint, maxt, slabs, cb, linC = map(
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


def test_super_bounds_built_once_per_table():
    """The kernels' supercluster bounds are built once per cbounds table
    and equal _super_bounds of it (K = 300 pads the last supercluster)."""
    cb = torch.from_numpy(trace.random_cluster_soup(300, 128, 5, 8)[5])
    k = trace.make_pair_intersector(128, 300)
    sb = k.super_bounds(cb)
    assert k.super_bounds(cb) is sb
    assert sb.shape == (3, 6) and sb.is_contiguous()
    torch.testing.assert_close(sb, trace._super_bounds(cb), rtol=0, atol=0)
    torch.testing.assert_close(sb[2], torch.cat([cb[256:, :3].amin(0),
                                                 cb[256:, 3:].amax(0)]),
                               rtol=0, atol=0)
    other = cb.clone()
    assert k.super_bounds(other) is not sb


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
