"""One G-PT frame over row-sharded ranks on the CPU: the sharded frame
(parallel/tiles.render_final_sharded: rows rendered a rank, halos added,
the buffers gathered and solved on rank 0), the frame loop
(parallel/multihost.FrameLoop), one build of a cold geometry cache entry
per process group (scene/prep_cache.py) and the CLI's distributed route,
over 2 and 3 gloo ranks of tests/torch_frame_worker.py (which imports no
jax), all started at once by one fixture.

The ranks' buffers differ from one device's in the rounding of the halo
adds, and the L1 solve is chaotic under rounding, so a sharded frame's
final image is held bit for bit to models/poisson's solve of its own
gathered buffers, and to the single device's final image in L2."""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from gradientdomain_mitsuba_tpu_torch.models import poisson
from gradientdomain_mitsuba_tpu_torch.models.gpt import GPTracer
from gradientdomain_mitsuba_tpu_torch.parallel import tiles
from gradientdomain_mitsuba_tpu_torch.utils import exr

import torch_frame_worker as worker
from torch_parity import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_frame_worker.py")
BUFS = ("primal", "very_direct", "dx", "dy")
CLI = ["-m", "gradientdomain_mitsuba_tpu_torch.utils.cli", worker.CBOX,
       "-D", "integrator=gpt", "-D", f"width={worker.SIZE}", "-D",
       f"height={worker.SIZE}", "-D", "maxDepth=2", "-s", "2", "-z", "3",
       "--device", "cpu", "-q"]


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "WORLD_SIZE", "RANK", "LOCAL_RANK")}
    env.update(OMP_NUM_THREADS="1", **extra)
    return env


def _start(n, jobs, outdir):
    addr = f"127.0.0.1:{_free_port()}"
    return [subprocess.Popen(
        [sys.executable, WORKER, addr, str(n), str(r), str(outdir), jobs],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(n)]


def _start_cli(outdir):
    """The CLI on 2 gloo ranks (a torchrun-like environment) and in one
    process."""
    port = str(_free_port())
    ranks = [subprocess.Popen(
        [sys.executable] + CLI + ["-o", str(outdir / "ranks.exr")],
        env=_env(WORLD_SIZE="2", RANK=str(r), LOCAL_RANK=str(r),
                 MASTER_ADDR="127.0.0.1", MASTER_PORT=port), cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    one = subprocess.Popen(
        [sys.executable] + CLI + ["-o", str(outdir / "one.exr")],
        env=_env(), cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    return ranks + [one]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every multi-process run at once: {name: (outdir, [(returncode,
    output) a process])}."""
    dirs = {k: tmp_path_factory.mktemp(k)
            for k in ("ranks2", "ranks3", "die", "cli")}
    procs = {"ranks2": _start(2, "cache,frame,loop", dirs["ranks2"]),
             "ranks3": _start(3, "frame", dirs["ranks3"]),
             "die": _start(2, "die", dirs["die"]),
             "cli": _start_cli(dirs["cli"])}
    out = {}
    try:
        for k, ps in procs.items():
            out[k] = (dirs[k], [(p.wait(timeout=240), p.stdout.read())
                                for p in ps])
    finally:
        for ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return out


def _results(runs, name):
    d, done = runs[name]
    for r, (rc, text) in enumerate(done):
        assert rc == 0, f"{name} rank {r} failed:\n{text[-3000:]}"
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(len(done))]


@pytest.mark.parametrize("mode", ["L1", "L2"])
def test_one_rank_frame(mode):
    """A world of one: render_final_sharded's buffers are
    render_tiles_gpt's and its final image models/poisson's solve of them
    plus very_direct, bit for bit."""
    scene, st = worker.load()
    tracer = GPTracer(scene, st)
    mesh = tiles.Mesh(1, 0, torch.device("cpu"))
    final, bufs = tiles.render_final_sharded(tracer, scene, mesh, 2, 2,
                                             mode=mode)
    tiled = tiles.render_tiles_gpt(tracer, scene, mesh, 2, 2)
    for k in BUFS:
        np.testing.assert_array_equal(bufs[k].numpy(), tiled[k], err_msg=k)
    assert torch.equal(final, poisson.reconstruct(bufs, mode=mode))


@pytest.fixture(scope="module")
def single():
    scene, st = worker.load()
    tracer = GPTracer(scene, st)
    final, bufs = tracer.render_final(scene, 2, 2)
    final_l2, _ = tracer.render_final(scene, 2, 2, mode="L2")
    return ({"L1": final.numpy(), "L2": final_l2.numpy()},
            {k: v.numpy() for k, v in bufs.items()})


@pytest.mark.parametrize("mode", ["L1", "L2"])
@pytest.mark.parametrize("n", [2, 3])
def test_final_sharded_matches_render_final(runs, single, n, mode):
    """render_final_sharded over 2 and 3 ranks (16 rows: 8/8 and 6/6/4)
    against GPTracer.render_final: the buffers at the tile renderers'
    tolerance (tests/test_torch_parallel.py), the final image as
    models/poisson's solve of the gathered buffers plus very_direct, bit
    for bit, and within 1e-3 of the single device's in L2 (the chaos
    above)."""
    res = _results(runs, f"ranks{n}")
    got = res[0]
    assert all("frame_final" not in r for r in res[1:])
    finals, bufs = single
    for k in BUFS:
        np.testing.assert_allclose(got[f"frame_{k}"], bufs[k], rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    mine = got["frame_final" if mode == "L1" else "frame_final_l2"]
    gathered = {k: torch.from_numpy(got[f"frame_{k}"]) for k in BUFS}
    np.testing.assert_array_equal(
        mine, poisson.reconstruct(gathered, mode=mode).numpy())
    final = finals[mode]
    assert np.linalg.norm(mine - final) <= 1e-3 * np.linalg.norm(final)


@pytest.mark.parametrize("n", [2, 3])
def test_collectives_a_frame(runs, n):
    """Every rank makes three collective calls a frame: the halo exchange
    up and down, and the gather to rank 0."""
    for r in _results(runs, f"ranks{n}"):
        assert int(r["frame_collectives"]) == 3


def test_frame_loop_replays_and_stops(runs):
    """Two frames, the first again: the same bits; ray counts summed on
    rank 0; rank 0's trace holds every rank's shard_render span on its
    own three frames; the follower returns at stop."""
    lead, follower = _results(runs, "ranks2")
    np.testing.assert_array_equal(lead["loop_5again"], lead["loop_5"])
    assert not np.array_equal(lead["loop_6"], lead["loop_5"])
    assert lead["loop_rays"] > 0
    assert sorted(map(tuple, lead["loop_spans"].tolist())) == [
        (r, f) for r in (0, 1) for f in (0, 1, 2)]
    assert follower["loop_followed"] == 1


def test_leader_loss_releases_followers(runs):
    """A leader that exits leaves its follower's follow() raising well
    inside the group's timeout."""
    d, ((rc0, _), (rc1, text)) = runs["die"]
    assert rc0 == 3
    assert rc1 == 0, text[-3000:]
    released = np.load(d / "rank1.npz")["die_released_s"]
    assert released < worker.DIE_TIMEOUT_S


def test_cold_cache_entry_built_once(runs):
    """Two ranks load a scene whose entry is cold: rank 0 builds the
    geometry and the shading table, rank 1 reads both."""
    lead, other = _results(runs, "ranks2")
    assert (lead["cache_builds"], other["cache_builds"]) == (2, 0)
    assert (lead["cache_hit"], other["cache_hit"]) == (0, 1)
    np.testing.assert_array_equal(lead["cache_v0"], other["cache_v0"])


def test_cli_distributed_route_matches_one_process(runs):
    """tpurender-torch under a 2-rank launch writes the one-process
    outputs of the same scene and seed (half floats): the buffers to
    their rounding, the final image within 1e-3 in L2 (the solve's
    chaos)."""
    d, done = runs["cli"]
    for r, (rc, text) in enumerate(done):
        assert rc == 0, f"process {r}:\n{text[-3000:]}"
    for suffix in ("-primal", "-dx", "-dy", "-direct"):
        np.testing.assert_allclose(
            exr.read_rgb(str(d / f"ranks{suffix}.exr")),
            exr.read_rgb(str(d / f"one{suffix}.exr")), rtol=1e-3, atol=1e-4,
            err_msg=suffix)
    got, want = (exr.read_rgb(str(d / f"{k}.exr")) for k in ("ranks", "one"))
    assert np.linalg.norm(got - want) <= 1e-3 * np.linalg.norm(want)
