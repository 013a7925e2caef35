"""The port's parallel/ package on the CPU: the row-sharded tile renderers
(parallel/tiles.py), the distributed Poisson solve (dist_poisson.py), the
elastic tile queue (tile_queue.py) and the multi-process entry points
(multihost.py) over torch.distributed.

A world of one runs in process, on a gloo group of one rank.  Two and
three ranks run as gloo worker processes (tests/torch_parallel_worker.py,
which imports no jax): every rank must hold the same film bit for bit,
and the film must match the reference's render of it, with the
reference's intersectors pinned to the linear-MT matmul sweeps, at the
reference's own tolerance (tests/test_parallel.py: rtol 1e-4, atol
1e-5); with -m slow also its row-sharded tiles over an in-process mesh
of as many of tests/conftest.py's 8 CPU devices, and the MULTICHIP dry
run's pipeline at its full 64^2 (by default the same pipeline is held
against the reference at 12^2).  The tile queue is held against the
reference's G-PT render, and the sharded Poisson solve against the
reference's solve_l2_sharded at atol 2e-3, rtol 1e-3."""
import copy
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from gradientdomain_mitsuba_tpu.models.gbdpt import GBDPTracer as RefGBDPT
from gradientdomain_mitsuba_tpu.models.gpt import GPTracer as RefGPT
from gradientdomain_mitsuba_tpu.models.path import PathTracer as RefPath
from gradientdomain_mitsuba_tpu.ops import common as ref_common
from gradientdomain_mitsuba_tpu.parallel import dist_poisson as ref_dp
from gradientdomain_mitsuba_tpu.parallel import tiles as ref_tiles
from gradientdomain_mitsuba_tpu.scene import scene as ref_scene
from gradientdomain_mitsuba_tpu_torch.models import poisson
from gradientdomain_mitsuba_tpu_torch.models.gbdpt import GBDPTracer
from gradientdomain_mitsuba_tpu_torch.models.gpt import GPTracer
from gradientdomain_mitsuba_tpu_torch.models.path import PathTracer
from gradientdomain_mitsuba_tpu_torch.parallel import (dist_poisson,
                                                       multihost,
                                                       tile_queue, tiles)
from gradientdomain_mitsuba_tpu_torch.scene import bridge
from gradientdomain_mitsuba_tpu_torch.scene import scene as port_scene

import torch_parity
import torch_parallel_worker as worker
from torch_parity import one_thread  # noqa: F401

# torch on one thread: the suite runs six workers, and a multi-threaded
# CPU torch among them spends the renders' time contending for cores
pytestmark = pytest.mark.usefixtures("one_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CBOX = os.path.join(ROOT, "data/scenes/cbox/cbox.xml")
WORKER = os.path.join(ROOT, "tests", "torch_parallel_worker.py")
BUFS = ("primal", "very_direct", "dx", "dy")
# the multi-rank renders: 12 rows split 6/6 and 4/4/4 (no padding); the
# three ranks also render 16 rows (6/6/4: the last rank's padding masked)
SIZE, DEPTH = 12, 2


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _load(size, depth, integrator, spp=2):
    scene, st = port_scene.load_scene(CBOX, {
        "width": str(size), "height": str(size), "spp": str(spp),
        "maxDepth": str(depth), "integrator": integrator})
    st.integrator = integrator
    return bridge.to_torch(scene, "cpu"), st


def _close(got, ref, name):
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5, err_msg=name)


# ---------------------------------------------------------------------------
# a world of one, in process


def test_make_mesh_without_group(monkeypatch):
    """No group: a world of one on the caller's device; the default
    "cuda" raises without a card, as config.get_device does."""
    assert not dist.is_initialized()
    assert tiles.make_mesh(device="cpu") == (1, 0, torch.device("cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tiles.make_mesh()


def test_multihost_rejects_virtual_devices():
    with pytest.raises(ValueError, match="one rank per device"):
        multihost.init("127.0.0.1:1", 1, 0, local_device_count=2,
                       device="cpu")
    assert not dist.is_initialized()


@pytest.fixture(scope="module")
def world_of_one():
    """A gloo group of one rank for this module's in-process tests,
    destroyed at the end so that no group leaks into other tests."""
    assert not dist.is_initialized()
    assert multihost.init(f"127.0.0.1:{_free_port()}", 1, 0,
                          device="cpu") == torch.device("cpu")
    try:
        yield tiles.make_mesh()
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def cbox():
    return _load(24, 3, "gpt", spp=4)


def test_make_mesh_world(world_of_one):
    assert world_of_one == (1, 0, torch.device("cpu"))
    assert multihost.global_mesh() == world_of_one
    with pytest.raises(ValueError, match="one rank per device"):
        tiles.make_mesh(2)


def test_path_tiles_match_single(world_of_one, cbox):
    scene, st = cbox
    pt = PathTracer(scene, st)
    single = pt.render(scene, seed=2, spp=4).numpy()
    _close(tiles.render_tiles_path(pt, scene, world_of_one, 2, 4), single,
           "path")


def test_gpt_tiles_match_single(world_of_one, cbox):
    scene, st = cbox
    g = GPTracer(scene, st)
    single = g.render(scene, seed=2, spp=2, chunk=2)
    multi = tiles.render_tiles_gpt(g, scene, world_of_one, 2, 2)
    for k in BUFS:
        _close(multi[k], single[k].numpy(), k)


def test_gbdpt_tiles_match_single(world_of_one, cbox):
    scene, st = cbox
    st2 = copy.deepcopy(st)
    st2.integrator = "gbdpt"
    g = GBDPTracer(scene, st2)
    single = g.render(scene, seed=2, spp=2, chunk=2)
    multi = tiles.render_tiles_gbdpt(g, scene, world_of_one, 2, 2)
    for k in BUFS:
        _close(multi[k], single[k].numpy(), k)


def test_dist_poisson_matches_local(world_of_one):
    P, gx, gy = worker.poisson_inputs()
    local = poisson.solve_l2(torch.from_numpy(P), torch.from_numpy(gx),
                             torch.from_numpy(gy), alpha=0.25,
                             iters=150).numpy()
    got = dist_poisson.solve_l2_sharded(world_of_one, P, gx, gy, alpha=0.25,
                                        iters=150)
    np.testing.assert_allclose(got, local, atol=2e-3, rtol=1e-3)
    bufs = dict(primal=P, dx=gx, dy=gy, very_direct=P)
    rec = dist_poisson.reconstruct_sharded(world_of_one, bufs, alpha=0.25,
                                           iters=150)
    np.testing.assert_allclose(rec, local + P, atol=2e-3, rtol=1e-3)


def test_tile_queue_fault_injection_bit_identical(cbox):
    scene, st = cbox
    g = GPTracer(scene, st)
    clean = tile_queue.render_tiles_queued(g, scene, seed=3, n_samples=2,
                                           tile_rows=8)
    faults = []

    def hook(idx, attempt):
        if idx == 1 and attempt == 0:
            faults.append(idx)
            raise RuntimeError("injected: device lost tile 1")

    faulty = tile_queue.render_tiles_queued(g, scene, seed=3, n_samples=2,
                                            tile_rows=8, fail_hook=hook)
    assert faults == [1]
    for k in BUFS:
        np.testing.assert_array_equal(clean[k], faulty[k], err_msg=k)


@pytest.mark.parametrize("rfilter", ["box", "gaussian"])
def test_tile_queue_matches_monolithic(cbox, rfilter):
    """24 rows in tiles of 10: the last tile's rows past the film get no
    lanes, so with the Gaussian filter (taps one row out) no weight of a
    padding row reaches the film's last row."""
    scene, st = cbox
    st = copy.deepcopy(st)
    st.rfilter = rfilter
    g = GPTracer(scene, st)
    single = g.render(scene, seed=3, spp=2, chunk=2)
    progress = []
    queued = tile_queue.render_tiles_queued(
        g, scene, seed=3, n_samples=2, tile_rows=10,
        progress=lambda done, n: progress.append((done, n)))
    assert progress == [(1, 3), (2, 3), (3, 3)]
    for k in BUFS:
        _close(queued[k], single[k].numpy(), k)


def test_tile_queue_gives_up_after_max_retries(cbox):
    scene, st = cbox
    g = GPTracer(scene, st)
    attempts = []

    def always_fail(idx, attempt):
        if idx == 0:
            attempts.append(attempt)
            raise RuntimeError("injected: permanently dead tile")

    with pytest.raises(tile_queue.TileRenderError, match="tile 0 failed 3"):
        tile_queue.render_tiles_queued(g, scene, seed=3, n_samples=1,
                                       tile_rows=8, max_retries=2,
                                       fail_hook=always_fail)
    assert attempts == [0, 1, 2]


# ---------------------------------------------------------------------------
# two and three gloo ranks in worker processes


def _spawn(n, jobs, tmp_path, sizes=str(SIZE), depth=DEPTH, timeout=300):
    """Run n worker ranks; returns rank 0's results, after checking that
    every rank's are the same bits."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    addr = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, WORKER, addr, str(n), str(r), str(tmp_path), jobs,
         sizes, str(depth)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-3000:]}"
    res = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(n)]
    for r in range(1, n):
        assert sorted(res[r]) == sorted(res[0])
        for k in res[0]:
            np.testing.assert_array_equal(res[r][k], res[0][k],
                                          err_msg=f"rank {r}: {k}")
    return res[0]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The worker runs: 2 ranks (renders at 12^2 and their G-PT and
    G-BDPT finals by the sharded solve, the sharded solve and the
    MULTICHIP dry run) and 3 ranks (renders at 12^2 and at 16^2,
    where the last rank renders 4 of its 6 rows, and the sharded
    solve)."""
    return {n: _spawn(n, jobs, tmp_path_factory.mktemp(f"ranks{n}"),
                      sizes=sizes)
            for n, jobs, sizes in ((2, "renders,final,poisson,dryrun",
                                    "12"),
                                   (3, "renders,poisson", "12,16"))}


def _ref_load(name, size=SIZE, depth=DEPTH):
    scene, st = ref_scene.load_scene(CBOX, {
        "width": str(size), "height": str(size), "spp": "2",
        "maxDepth": str(depth), "integrator": name})
    st.integrator = name
    return scene, st


def _ref_renders(mesh_devices=None):
    """The reference's G-PT and G-BDPT buffers at 12^2, maxDepth 2, 2 spp,
    seed 2, its intersectors pinned to the matmul sweeps: its
    single-device renders (and its path image, key "path"), or with
    mesh_devices its row-sharded tiles over an in-process mesh of that
    many CPU devices."""
    mp = pytest.MonkeyPatch()
    mp.setattr(ref_common, "choose_intersector", torch_parity.pinned_matmul)
    try:
        out = {}
        if mesh_devices is None:
            scene, st = _ref_load("path")
            out["path"] = np.asarray(
                RefPath(scene, st).render(scene, seed=2, spp=2))
        for name, cls, fn in (("gpt", RefGPT, ref_tiles.render_tiles_gpt),
                              ("gbdpt", RefGBDPT,
                               ref_tiles.render_tiles_gbdpt)):
            scene, st = _ref_load(name)
            tracer = cls(scene, st)
            if mesh_devices is None:
                res = tracer.render(scene, seed=2, spp=2)
            else:
                res = fn(tracer, scene, ref_tiles.make_mesh(mesh_devices),
                         2, 2)
            out[name] = {k: np.asarray(res[k]) for k in BUFS}
    finally:
        mp.undo()
    return out


@pytest.fixture(scope="module")
def ref_renders():
    return _ref_renders()


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("family", ["path", "gpt", "gbdpt"])
def test_ranks_match_reference(ranks, ref_renders, n, family):
    """Every rank's gathered buffers (equal bit for bit across ranks)
    against the reference's render of the same film and seeds (its own
    tests/test_parallel.py holds its tiles to its single-device render
    at this tolerance)."""
    if family == "path":
        got = ranks[n][f"{SIZE}_path"]
        assert np.isfinite(got).all()
        _close(got, ref_renders["path"], "path")
        return
    for k in BUFS:
        got = ranks[n][f"{SIZE}_{family}_{k}"]
        assert np.isfinite(got).all(), k
        _close(got, ref_renders[family][k], f"{family} {k}")


def test_tile_queue_matches_reference(ref_renders):
    """The queue on the ranks' film (12 rows in tiles of 5: the last
    tile has 2 rows on the film) against the reference's G-PT render."""
    scene, st = _load(SIZE, DEPTH, "gpt")
    queued = tile_queue.render_tiles_queued(GPTracer(scene, st), scene,
                                            seed=2, n_samples=2,
                                            tile_rows=5)
    for k in BUFS:
        _close(queued[k], ref_renders["gpt"][k], k)


@pytest.mark.slow
@pytest.mark.parametrize("n", [2, 3])
def test_ranks_match_reference_tiles(ranks, n):
    """The same against the reference's row-sharded tiles over a mesh
    of n devices: ~40 s of reference compiles a mesh, so opt-in
    (-m slow)."""
    ref = _ref_renders(mesh_devices=n)
    for family in ("gpt", "gbdpt"):
        for k in BUFS:
            _close(ranks[n][f"{SIZE}_{family}_{k}"], ref[family][k],
                   f"{family} {k}")


@pytest.mark.parametrize("n,size", [(2, SIZE), (3, SIZE), (3, 16)])
def test_ranks_match_single(ranks, n, size):
    """path, G-PT and G-BDPT over the ranks against the port's
    single-process renders of the same film; at 16^2 over three ranks
    the last rank renders 4 of its 6 rows."""
    got = ranks[n]
    scene, st = _load(size, DEPTH, "path")
    _close(got[f"{size}_path"], PathTracer(scene, st).render(
        scene, seed=2, spp=2).numpy(), "path")
    for family, cls in (("gpt", GPTracer), ("gbdpt", GBDPTracer)):
        scene, st = _load(size, DEPTH, family)
        single = cls(scene, st).render(scene, seed=2, spp=2)
        for k in BUFS:
            _close(got[f"{size}_{family}_{k}"], single[k].numpy(),
                   f"{family} {k}")


@pytest.fixture(scope="module")
def ref_poisson():
    """The reference's solve_l2_sharded over a mesh of two devices on
    test_dist_poisson_matches_local's inputs."""
    P, gx, gy = worker.poisson_inputs()
    return ref_dp.solve_l2_sharded(ref_tiles.make_mesh(2), P, gx, gy,
                                   alpha=0.25, iters=150)


@pytest.mark.parametrize("n", [2, 3])
def test_ranks_poisson_matches_reference(ranks, ref_poisson, n):
    """The sharded CG over 2 and 3 ranks (25 rows: padded to 26 and 27)
    against the reference's sharded solve (the solution does not depend
    on the mesh beyond rounding)."""
    np.testing.assert_allclose(ranks[n]["poisson"], ref_poisson, atol=2e-3,
                               rtol=1e-3)


@pytest.mark.parametrize("family", ["gpt", "gbdpt"])
def test_ranks_pipeline_matches_reference(ranks, ref_renders, family):
    """The dry run's pipeline at the ranks' 12^2 (tiles on 2 ranks, then
    reconstruct_sharded, L2, alpha 0.2, 20 CG iterations) against the
    reference's render followed by its reconstruct_sharded over a mesh
    of two devices, at the dry run's rtol 1e-4 (its full 64^2 against
    the reference: test_multichip_dry_run_matches_reference, -m slow)."""
    ref = ref_dp.reconstruct_sharded(ref_tiles.make_mesh(2),
                                     ref_renders[family], alpha=0.2,
                                     iters=20)
    got = ranks[2][f"{SIZE}_{family}_final"]
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4,
                               err_msg=family)


def test_multichip_dry_run_on_two_ranks(ranks, capsys):
    """The MULTICHIP_r05.json pipeline (64^2, maxDepth 4, 1 spp, CG 20)
    on two ranks against the same pipeline in one process with no
    group: finite, the same on both ranks, and equal at rtol 1e-4.  The
    checksums are printed beside the recorded ones (1.420230e+03,
    1.431852e+03; taken with the reference's intersect_brute on another
    host, so not gated)."""
    got = ranks[2]
    mesh = tiles.make_mesh(device="cpu")
    final, gfinal = worker.dry_run(mesh)
    for name, ref in (("dry_final", final), ("dry_gfinal", gfinal)):
        assert got[name].shape == (64, 64, 3)
        assert np.isfinite(got[name]).all()
        _close(got[name], ref, name)
    with capsys.disabled():
        print(f"\n[dry run, 2 ranks] checksum="
              f"{float(got['dry_final'].astype(np.float64).sum()):.6e} "
              f"gbdpt_checksum="
              f"{float(got['dry_gfinal'].astype(np.float64).sum()):.6e}")


@pytest.mark.slow
def test_multichip_dry_run_matches_reference(ranks):
    """The same dry run against the reference's pipeline in process
    (tiles over a mesh of two devices, reconstruct_sharded), pinned to
    the matmul sweeps: ~70 s of reference compiles, so opt-in
    (-m slow)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(ref_common, "choose_intersector", torch_parity.pinned_matmul)
    try:
        mesh = ref_tiles.make_mesh(2)
        scene, st = ref_scene.load_scene(CBOX, {
            "width": "64", "height": "64", "spp": "2", "maxDepth": "4",
            "integrator": "gpt"})
        bufs = ref_tiles.render_tiles_gpt(RefGPT(scene, st), scene, mesh,
                                          0, 1)
        final = ref_dp.reconstruct_sharded(mesh, bufs, alpha=0.2, iters=20)
        st.integrator = "gbdpt"
        gbufs = ref_tiles.render_tiles_gbdpt(RefGBDPT(scene, st), scene,
                                             mesh, 0, 1)
        gfinal = ref_dp.reconstruct_sharded(mesh, gbufs, alpha=0.2,
                                            iters=20)
    finally:
        mp.undo()
    for name, ref in (("dry_final", final), ("dry_gfinal", gfinal)):
        np.testing.assert_allclose(ranks[2][name], ref, rtol=1e-4,
                                   atol=1e-4, err_msg=name)
