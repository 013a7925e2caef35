"""Port plain traversals (ops/intersect.py): the lockstep BVH stack walks
(make_bvh_intersector / _occluder and their _soa names) and the
two-level cluster walk (make_cluster_intersector / _occluder) against
the reference's jitted functions on the same soups, rays and maxt, as
tests/test_intersect.py holds the reference against intersect_brute;
and choose_intersector's route for a large scene without clusters.

Expectation: prim and valid (or occluded) equal on every ray, dead
lanes (maxt = -1) unhit, t within rtol 1e-5, u and v within rtol 1e-5
or 1e-6 absolute (barycentrics in [0, 1]).  The port's walks compute
the Moeller-Trumbore test in the order XLA's CPU backend compiles the
reference's (ops/intersect._mt_fma), so on this CPU the values agree
bit for bit."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gradientdomain_mitsuba_tpu.ops import common as ref_common
from gradientdomain_mitsuba_tpu.ops import intersect as ref_isec
from gradientdomain_mitsuba_tpu.scene import scene as ref_scene
from gradientdomain_mitsuba_tpu_torch.ops import common
from gradientdomain_mitsuba_tpu_torch.ops import intersect as isec
from gradientdomain_mitsuba_tpu_torch.scene import bvh as bvh_mod
from gradientdomain_mitsuba_tpu_torch.scene import prep_cache as pc
from gradientdomain_mitsuba_tpu_torch.scene import scene as port_scene
from test_torch_scene import SCENES
from torch_parity import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


def _random_soup(n_tris, seed=0, spread=10.0):
    rs = np.random.RandomState(seed)
    v0 = rs.uniform(-spread, spread, (n_tris, 3)).astype(np.float32)
    v1 = v0 + rs.normal(0, 1.0, (n_tris, 3)).astype(np.float32)
    v2 = v0 + rs.normal(0, 1.0, (n_tris, 3)).astype(np.float32)
    return v0, v1, v2


def _random_rays(n, seed=1, spread=12.0, maxt=1e30):
    """Rays from a box in random directions; every 7th lane dead."""
    rs = np.random.RandomState(seed)
    o = rs.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    mint = np.zeros(n, np.float32)
    mx = np.full(n, maxt, np.float32)
    mx[::7] = -1.0
    return o, d, mint, mx


def _bvh_tables(v0, v1, v2):
    """(TriSoup, BVHArrays) numpy fields in BVH leaf order, stack depth
    (tests/test_intersect.py's _build)."""
    tree = bvh_mod.build(v0, v1, v2)
    o = tree.prim_order
    tris = (v0[o], (v1 - v0)[o], (v2 - v0)[o], o.astype(np.int32))
    arr = (tree.child0_min, tree.child0_max, tree.child1_min,
           tree.child1_max, tree.child0, tree.child1)
    return tris, arr, 2 * tree.depth + 4


def _cluster_tables(v0, v1, v2, target):
    """(TriSoup, ClusterArrays) numpy fields of the loader's padded
    cluster-major layout (prep_cache.build_geometry), and the window."""
    g = pc.build_geometry(v0, v1, v2, target)
    W = int(g["window"])
    K = len(g["c_off"])
    tris = (g["v0"], g["e1"], g["e2"], g["orig_id"])
    clusters = (g["c_min"], g["c_max"], np.arange(K, dtype=np.int32) * W)
    return tris, clusters, W


def _run(kind, any_hit, table_args, rays, param):
    """(reference result, port result) of one traversal on numpy tables
    (tris fields, bvh or cluster fields) and numpy rays."""
    tris, acc = table_args
    if kind == "cluster":
        ref_mk = (ref_isec.make_cluster_occluder if any_hit else
                  ref_isec.make_cluster_intersector)
        port_mk = (isec.make_cluster_occluder if any_hit else
                   isec.make_cluster_intersector)
        ref_acc, port_acc = ref_isec.ClusterArrays, isec.ClusterArrays
    else:
        name = "make_bvh_" + ("occluder" if any_hit else "intersector") + (
            "_soa" if kind == "bvh_soa" else "")
        ref_mk, port_mk = getattr(ref_isec, name), getattr(isec, name)
        ref_acc, port_acc = ref_isec.BVHArrays, isec.BVHArrays
    ref = jax.jit(ref_mk(param))(
        *map(jnp.asarray, rays), ref_isec.TriSoup(*map(jnp.asarray, tris)),
        ref_acc(*map(jnp.asarray, acc)))
    got = port_mk(param)(
        *map(torch.from_numpy, rays),
        isec.TriSoup(*(torch.from_numpy(np.asarray(a)) for a in tris)),
        port_acc(*(torch.from_numpy(np.asarray(a)) for a in acc)))
    return ref, got


def _check(ref, got, rays, any_hit, min_hits=1):
    dead = rays[3] <= rays[2]
    if any_hit:
        got = got.numpy()
        np.testing.assert_array_equal(got, np.asarray(ref))
        assert not got[dead].any()
        assert got.sum() >= min_hits
        return
    valid = got.valid.numpy()
    np.testing.assert_array_equal(valid, np.asarray(ref.valid))
    np.testing.assert_array_equal(got.prim.numpy(), np.asarray(ref.prim))
    assert not valid[dead].any() and valid.sum() >= min_hits
    assert (got.t.numpy()[~valid] == np.float32(3.0e38)).all()
    m = valid
    np.testing.assert_allclose(got.t.numpy()[m], np.asarray(ref.t)[m],
                               rtol=1e-5)
    for f in ("u", "v"):
        np.testing.assert_allclose(getattr(got, f).numpy()[m],
                                   np.asarray(getattr(ref, f))[m],
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("form", ["bvh", "bvh_soa"])
@pytest.mark.parametrize("n_tris", [7, 200, 3000])
def test_bvh_closest_matches_reference(n_tris, form):
    tris, arr, depth = _bvh_tables(*_random_soup(n_tris))
    rays = _random_rays(512)
    ref, got = _run(form, False, (tris, arr), rays, depth)
    _check(ref, got, rays, False)


@pytest.mark.parametrize("form", ["bvh", "bvh_soa"])
def test_bvh_occluder_matches_reference(form):
    tris, arr, depth = _bvh_tables(*_random_soup(500, seed=3))
    rays = _random_rays(512, seed=4, maxt=8.0)  # finite shadow rays
    ref, got = _run(form, True, (tris, arr), rays, depth)
    _check(ref, got, rays, True)


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("n_tris,target", [(300, 16), (3000, 64)])
def test_cluster_walk_matches_reference(n_tris, target, any_hit):
    """Windows of 128 slots holding 16-64 triangles: the padding slots
    (zero triangles) are tested and never hit."""
    tris, clusters, W = _cluster_tables(*_random_soup(n_tris, seed=5),
                                        target)
    assert W == 128 and (tris[3] < 0).mean() > 0.3       # padded
    rays = _random_rays(700, seed=6, maxt=8.0 if any_hit else 1e30)
    ref, got = _run("cluster", any_hit, (tris, clusters), rays, W)
    _check(ref, got, rays, any_hit)


@pytest.mark.parametrize("kind", ["bvh", "bvh_soa", "cluster"])
def test_maxt_respected(kind):
    v0 = np.array([[0, -1, -1]], np.float32)
    v1 = np.array([[0, 3, -1]], np.float32)
    v2 = np.array([[0, -1, 3]], np.float32)
    if kind == "cluster":
        tris, acc, param = _cluster_tables(v0, v1, v2, 1)
    else:
        tris, acc, _ = _bvh_tables(v0, v1, v2)
        param = 8
    o = np.float32([[-2, 0, 0]] * 3)
    d = np.float32([[1, 0, 0]] * 3)
    rays = (o, d, np.zeros(3, np.float32), np.float32([1.0, 5.0, -1.0]))
    ref, got = _run(kind, False, (tris, acc), rays, param)
    _check(ref, got, rays, False)
    # the triangle at t = 2 lies beyond maxt = 1; lane 2 is dead
    assert got.valid.tolist() == [False, True, False]
    assert abs(float(got.t[1]) - 2.0) < 1e-5
    ref, occ = _run(kind, True, (tris, acc), rays, param)
    _check(ref, occ, rays, True)
    assert occ.tolist() == [False, True, False]


@pytest.mark.parametrize("kind", ["bvh", "cluster"])
def test_loaded_scene_through_the_walks(kind):
    """cbox from both loaders (bit-identical tables), forced through the
    walks directly: camera-like rays from inside the box."""
    variables = {"width": "16", "height": "16", "spp": "1"}
    ref_s, ref_st = ref_scene.load_scene(SCENES["cbox"], variables)
    scene, st = port_scene.load_scene(SCENES["cbox"], variables)
    g = scene.geom
    tris = tuple(g.tris)
    if kind == "bvh":
        acc, param = tuple(g.bvh), st.stack_depth
    else:
        acc, param = tuple(g.clusters), st.cluster_window
    assert param == (ref_st.stack_depth if kind == "bvh" else
                     ref_st.cluster_window)
    rays = _random_rays(1000, seed=7, spread=200.0)
    rays = (rays[0] + np.float32(278.0),) + rays[1:]     # inside cbox
    for any_hit in (False, True):
        ref, got = _run(kind, any_hit, (tris, acc), rays, param)
        _check(ref, got, rays, any_hit, min_hits=700)


def test_choose_intersector_without_clusters():
    """A scene above BRUTE_FORCE_MAX_TRIS with no clusters: the port
    routes it to the cluster walk on tris and clusters, as the
    reference's CPU fallthrough does; no kernel."""
    n = 3000
    tris, clusters, W = _cluster_tables(*_random_soup(n, seed=8), 64)
    st = types.SimpleNamespace(cluster_window=W)
    closest, occl = common.choose_intersector(st, n, 0)
    assert closest.kernel is None and occl.kernel is None
    ref_closest, ref_occl = ref_common.choose_intersector(st, n, 0)
    rays = _random_rays(600, seed=9)
    shadow = rays[:3] + (np.where(rays[3] > 0, np.float32(8.0),
                                  rays[3]),)
    geom = types.SimpleNamespace(
        tris=isec.TriSoup(*map(torch.from_numpy, tris)),
        clusters=isec.ClusterArrays(*map(torch.from_numpy, clusters)),
        sph_center=torch.zeros((0, 3)))
    ref_geom = types.SimpleNamespace(
        tris=ref_isec.TriSoup(*map(jnp.asarray, tris)),
        clusters=ref_isec.ClusterArrays(*map(jnp.asarray, clusters)),
        sph_center=jnp.zeros((0, 3)))
    _check(jax.jit(lambda *r: ref_closest(*r, ref_geom))(
               *map(jnp.asarray, rays)),
           closest(*map(torch.from_numpy, rays), geom), rays, False)
    _check(jax.jit(lambda *r: ref_occl(*r, ref_geom))(
               *map(jnp.asarray, shadow)),
           occl(*map(torch.from_numpy, shadow), geom), shadow, True)
