"""Port geometry disk cache (scene/prep_cache.py): load_or_build /
load_or_build_array against the port's and the reference's
build_geometry, bit for bit, on a soup above CACHE_MIN_TRIS; the cache's
off states, torn entries, keys; and load_scene twice on a generated
forest (~159k triangles) against the reference's uncached load.

Every test points GDMT_GEOM_CACHE (read by both packages at each call)
at its tmp_path or sets it to "0": no test writes into the repo."""
import os
import warnings

import numpy as np
import pytest

from gradientdomain_mitsuba_tpu.scene import prep_cache as ref_pc
from gradientdomain_mitsuba_tpu.scene import scene as ref_scene
from gradientdomain_mitsuba_tpu_torch.scene import bridge
from gradientdomain_mitsuba_tpu_torch.scene import prep_cache as pc
from gradientdomain_mitsuba_tpu_torch.scene import scene as port_scene
from test_torch_scene import _assert_same_tree
from torch_parity import load_tool
from torch_parity import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

N_BIG = 120_000      # above CACHE_MIN_TRIS (100,000)


def _soup(n, seed=0):
    rs = np.random.RandomState(seed)
    p0 = np.float32(rs.uniform(-40, 40, (n, 3)))
    return (p0, np.float32(p0 + rs.normal(0, 0.5, (n, 3))),
            np.float32(p0 + rs.normal(0, 0.5, (n, 3))))


def _target(n):
    """The loader's cluster target (scene.load_scene)."""
    return int(np.clip(-(-n // 1024), 64, 128))


@pytest.fixture(scope="module")
def big():
    """(soup, target, port build_geometry, reference build_geometry)."""
    soup = _soup(N_BIG)
    tgt = _target(N_BIG)
    return (soup, tgt, pc.build_geometry(*soup, tgt),
            ref_pc.build_geometry(*soup, tgt))


def _assert_same_geometry(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def test_miss_then_hit_equals_both_builds(big, tmp_path, monkeypatch):
    soup, tgt, port_geo, ref_geo = big
    monkeypatch.setenv("GDMT_GEOM_CACHE", str(tmp_path))
    t_miss, t_hit = {}, {}
    miss = pc.load_or_build(*soup, tgt, t_miss)
    assert t_miss["cache"] == "miss"
    key = t_miss["geom_key"]
    assert key == pc.geometry_key(*soup, tgt)
    assert os.path.exists(tmp_path / key / ".complete")
    assert sorted(os.listdir(tmp_path)) == [key]     # no temp dir left
    hit = pc.load_or_build(*soup, tgt, t_hit)
    assert t_hit["cache"] == "hit" and t_hit["geom_key"] == key
    assert "bvh_build" not in t_hit                  # nothing rebuilt
    assert all(isinstance(v, np.memmap) and not v.flags.writeable
               for v in hit.values())
    for got in (miss, hit):
        _assert_same_geometry(got, port_geo)
        _assert_same_geometry(got, ref_geo)


@pytest.mark.parametrize("case", ["below_threshold", "disabled"])
def test_cache_off_writes_nothing(case, tmp_path, monkeypatch):
    if case == "below_threshold":
        monkeypatch.setenv("GDMT_GEOM_CACHE", str(tmp_path))
        n = 3000
        soup = _soup(n, seed=1)
    else:
        monkeypatch.setenv("GDMT_GEOM_CACHE", "0")
        assert pc._cache_dir() is None
        n = pc.CACHE_MIN_TRIS
        soup = _soup(n, seed=1)
    times = {}
    geo = pc.load_or_build(*soup, _target(n), times)
    assert times["cache"] == "off" and "geom_key" not in times
    assert os.listdir(tmp_path) == []
    _assert_same_geometry(geo, pc.build_geometry(*soup, _target(n)))


@pytest.mark.parametrize("damage", ["no_marker", "truncated_npy"])
def test_torn_entry_is_rebuilt(damage, big, tmp_path, monkeypatch):
    soup, tgt, port_geo, _ = big
    monkeypatch.setenv("GDMT_GEOM_CACHE", str(tmp_path))
    times = {}
    pc.load_or_build(*soup, tgt, times)
    entry = tmp_path / times["geom_key"]
    if damage == "no_marker":
        os.remove(entry / ".complete")
    else:
        data = (entry / "mt_slabs.npy").read_bytes()
        (entry / "mt_slabs.npy").write_bytes(data[:len(data) // 2])
    again = {}
    geo = pc.load_or_build(*soup, tgt, again)
    assert again["cache"] == "miss"
    _assert_same_geometry(geo, port_geo)
    third = {}
    geo = pc.load_or_build(*soup, tgt, third)   # the entry was replaced
    assert third["cache"] == "hit"
    _assert_same_geometry(geo, port_geo)
    assert sorted(os.listdir(tmp_path)) == [times["geom_key"]]


def test_geometry_key(monkeypatch):
    soup = _soup(500, seed=2)
    key = pc.geometry_key(*soup, 64)
    assert key == pc.geometry_key(*(a.copy() for a in soup), 64)
    assert pc.geometry_key(*soup, 128) != key              # target
    moved = soup[1].copy()
    moved[17, 2] += np.float32(1e-3)                       # one vertex
    assert pc.geometry_key(soup[0], moved, soup[2], 64) != key
    # the port's own tag: never the reference's key, and a new tag
    # makes new keys
    assert pc.GEOM_CACHE_VERSION != ref_pc.GEOM_CACHE_VERSION
    assert ref_pc.geometry_key(*soup, 64) != key
    assert pc.hash_arrays(*soup) != ref_pc.hash_arrays(*soup)
    monkeypatch.setattr(pc, "GEOM_CACHE_VERSION", "torch-test")
    assert pc.geometry_key(*soup, 64) != key


@pytest.mark.parametrize("case", ["miss_then_hit", "below_threshold",
                                  "disabled"])
def test_load_or_build_array(case, tmp_path, monkeypatch):
    arr = np.arange(60, dtype=np.float32).reshape(12, 5)
    calls = []

    def build():
        calls.append(1)
        return arr.copy()

    monkeypatch.setenv("GDMT_GEOM_CACHE",
                       "0" if case == "disabled" else str(tmp_path))
    n = pc.CACHE_MIN_TRIS - (case == "below_threshold")
    key = pc.hash_arrays(arr, None, extra="k")
    outs, times = [], [{}, {}]
    for t in times:
        outs.append(pc.load_or_build_array(key, build, n, t, tag="shade"))
    for out in outs:
        np.testing.assert_array_equal(out, arr)
        assert out.dtype == arr.dtype
    if case == "miss_then_hit":
        assert [t["shade_cache"] for t in times] == ["miss", "hit"]
        assert len(calls) == 1
        assert os.listdir(tmp_path) == [f"shade-{key}.npy"]
        assert isinstance(outs[1], np.memmap)
        (tmp_path / f"shade-{key}.npy").write_bytes(b"")   # torn file
        t = {}
        np.testing.assert_array_equal(
            pc.load_or_build_array(key, build, n, t, tag="shade"), arr)
        assert t["shade_cache"] == "miss" and len(calls) == 2
    else:
        assert times == [{}, {}] and len(calls) == 2
        assert os.listdir(tmp_path) == []


def test_load_scene_twice_on_a_generated_forest(tmp_path, monkeypatch):
    """tools/gen_forest.py at grid 5 (~159k triangles): the port's load
    writes the geometry and shading entries, the second load hits both,
    and both SceneData equal the reference's uncached load."""
    path = tmp_path / "forest5.xml"
    path.write_text(load_tool("gen_forest").generate(grid=5))
    variables = {"width": "16", "height": "16", "spp": "1"}
    cache = tmp_path / "cache"
    monkeypatch.setenv("GDMT_GEOM_CACHE", str(cache))
    miss, miss_st = port_scene.load_scene(str(path), variables)
    hit, hit_st = port_scene.load_scene(str(path), variables)
    n = miss.geom.indices.shape[0]
    assert n > pc.CACHE_MIN_TRIS
    t_miss, t_hit = miss_st.prep_times, hit_st.prep_times
    assert (t_miss["cache"], t_miss["shade_cache"]) == ("miss", "miss")
    assert (t_hit["cache"], t_hit["shade_cache"]) == ("hit", "hit")
    assert t_hit["geom_key"] == t_miss["geom_key"]
    assert len(os.listdir(cache)) == 2       # geometry dir + shade file
    _assert_same_tree(miss, hit)
    monkeypatch.setenv("GDMT_GEOM_CACHE", "0")
    ref, ref_st = ref_scene.load_scene(str(path), variables)
    assert ref_st.prep_times["cache"] == "off"
    _assert_same_tree(ref, hit)
    assert hit_st.stack_depth == ref_st.stack_depth
    assert hit_st.cluster_window == ref_st.cluster_window
    # read-only mmaps cross to tensors as writable copies, silently
    assert not hit.geom.tri_shade.flags.writeable
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ts = bridge.to_torch(hit, "cpu")
    ts.geom.tri_shade[0, 0] += 1.0
    assert ts.geom.tri_shade[0, 0] == hit.geom.tri_shade[0, 0] + 1.0
