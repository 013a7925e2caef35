"""Multi-process rendering over torch.distributed — the mtssrv analog.

Counterpart of gradientdomain_mitsuba_tpu/parallel/multihost.py
(Mitsuba's cluster rendering, src/libcore/sched_remote.cpp +
src/mitsuba/mtssrv.cpp).  Instead of a TCP daemon receiving serialized
scenes and work units, every process loads the scene from disk itself
(a replicated resource; a cold geometry cache entry is built once, by
rank 0: scene/prep_cache.py), joins one torch.distributed process group
with one rank per device, and runs the row-sharded renderers
(parallel/tiles.py), whose halo sends cross process boundaries.

FrameLoop is the servers' work loop: rank 0 leads, and every other rank
follows, blocked on a broadcast of a small command tensor until the
leader sends the next one (a final frame, the ray count and trace
switches, a collect of the trace, stop); then it makes the same call.

NCCL joins CUDA devices (rank r on cuda:r % device_count); gloo joins
CPU processes, which is how the tests run several ranks on one machine.
Every group gets a timeout: a collective that waits longer on a dead or
stuck rank raises instead of hanging the run.  Importing this module
initializes nothing.
"""
from __future__ import annotations

import os
import struct
from datetime import timedelta

import torch
import torch.distributed as dist

from ..utils import stats

# seconds a collective may wait on another rank: longer than a frame,
# a cold geometry cache build and what a leader does between frames
TIMEOUT_S = 600.0


def init(coordinator_address: str, num_processes: int, process_id: int,
         local_device_count: int | None = None, device: str = "cuda",
         timeout_s: float = TIMEOUT_S):
    """Join the process group: `coordinator_address` is "host:port" of
    rank 0 (the reference's analog of the mtssrv node list passed to
    `mitsuba -c`).  device "cuda" puts rank r on cuda:r % device_count
    and uses NCCL; "cpu" uses gloo.  Returns this rank's device.

    The reference's local_device_count makes that many virtual XLA
    devices per process; the port runs one rank per device, so a count
    above one raises."""
    if local_device_count is not None and local_device_count != 1:
        raise ValueError(
            f"local_device_count={local_device_count}: the port runs one "
            "rank per device; start one process per device instead")
    from ..config import get_device
    dev = get_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method="tcp://" +
                            coordinator_address, world_size=num_processes,
                            rank=process_id,
                            timeout=timedelta(seconds=timeout_s))
    return dev


def launched():
    """True in a process started by a torch.distributed launcher
    (torchrun) with a world of two or more (WORLD_SIZE)."""
    return int(os.environ.get("WORLD_SIZE", "1")) > 1


def init_from_env(device: str = "cuda", timeout_s: float = TIMEOUT_S):
    """init() from a launcher's environment: MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE and RANK."""
    e = os.environ
    return init(f"{e['MASTER_ADDR']}:{e['MASTER_PORT']}",
                int(e["WORLD_SIZE"]), int(e["RANK"]), device=device,
                timeout_s=timeout_s)


def global_mesh():
    """The world of the process group, rank-major: rank r owns the r-th
    block of film rows, so only the block seams cross processes."""
    from .tiles import make_mesh
    return make_mesh()


def render_gpt_multihost(tracer, scene, seed, n_samples):
    """Row-sharded G-PT render over the global mesh; returns the same
    gathered buffers dict on every rank."""
    from . import tiles
    return tiles.render_tiles_gpt(tracer, scene, global_mesh(), seed,
                                  n_samples)


def render_path_multihost(tracer, scene, seed, n_samples):
    """Row-sharded plain path-traced render over the global mesh."""
    from . import tiles
    return tiles.render_tiles_path(tracer, scene, global_mesh(), seed,
                                   n_samples)


# the commands: [op, arguments...] as int64
_RENDER, _SETTINGS, _COLLECT, _STOP = 1, 2, 3, 4
_CMD = 8
_MODES = ("L1", "L2")


def _bits(x):
    return struct.unpack("<q", struct.pack("<d", float(x)))[0]


def _float(b):
    return struct.unpack("<d", struct.pack("<q", int(b)))[0]


class FrameLoop:
    """The work loop of the ranks that render one G-PT frame after
    another (tiles.render_final_sharded) with a tracer and scene each
    rank made alike.  Every rank constructs it (a collective: it makes
    the loop's gloo group for commands); rank 0 then calls render_final,
    count_rays, collect and stop, and every other rank calls follow(),
    which returns at stop.

    While rank 0 leads followers, the program trace's collect() on rank
    0 also fetches the followers' `shard_render` spans (collect)."""

    def __init__(self, tracer, scene, timeout_s: float = TIMEOUT_S):
        from .tiles import make_mesh
        self.tracer, self.scene = tracer, scene
        self.mesh = make_mesh(device=str(tracer.device))
        self.leader = self.mesh.rank == 0
        self.group = (dist.new_group(backend="gloo",
                                     timeout=timedelta(seconds=timeout_s))
                      if self.mesh.size > 1 else None)
        if self.leader and self.group is not None:
            stats.remote_spans(self.collect)

    # -- both sides -----------------------------------------------------
    def _render(self, seed, spp, alpha, mode, l1_outer, l1_inner, l2_iters):
        from .tiles import render_final_sharded
        return render_final_sharded(self.tracer, self.scene, self.mesh,
                                    seed, spp, alpha=alpha, mode=mode,
                                    l1_outer=l1_outer, l1_inner=l1_inner,
                                    l2_iters=l2_iters)

    def _send(self, op, *args):
        if self.group is not None:
            cmd = torch.zeros(_CMD, dtype=torch.int64)
            cmd[:1 + len(args)] = torch.tensor((op,) + args)
            dist.broadcast(cmd, 0, group=self.group)

    # -- the leader -----------------------------------------------------
    def render_final(self, seed, spp, alpha=0.2, mode="L1", l1_outer=8,
                     l1_inner=40, l2_iters=100):
        """One final frame over every rank: (final image, buffers) on
        rank 0's device, as GPTracer.render_final returns them."""
        m = _MODES.index(mode.upper())
        self._send(_RENDER, int(seed), int(spp), _bits(alpha), m,
                   int(l1_outer), int(l1_inner), int(l2_iters))
        return self._render(seed, spp, alpha, _MODES[m], l1_outer, l1_inner,
                            l2_iters)

    def count_rays(self, on, tracing=False):
        """Ray counting on every rank; `tracing` turns the followers'
        program trace on or off (the leader's is its caller's)."""
        self._send(_SETTINGS, int(bool(on)), int(bool(tracing)))
        self.tracer.count_rays = bool(on)

    def collect(self):
        """The followers' `shard_render` span records since their last
        collect, one list a follower in rank order.  Call between
        frames."""
        if self.group is None:
            return []
        self._send(_COLLECT)
        got = [None] * self.mesh.size
        dist.gather_object([], got, dst=0, group=self.group)
        return got[1:]

    def stop(self):
        """Release the followers; the loop ends on every rank."""
        if self.leader and self.group is not None:
            stats.remote_spans(None)
            self._send(_STOP)
            self.group = None

    # -- a follower -----------------------------------------------------
    def follow(self):
        """Run the leader's commands until it stops the loop.  Raises when
        the leader is gone (its group's connection closes, or the
        timeout passes)."""
        cmd = torch.zeros(_CMD, dtype=torch.int64)
        while True:
            dist.broadcast(cmd, 0, group=self.group)
            op, *a = cmd.tolist()
            if op == _RENDER:
                self._render(a[0], a[1], _float(a[2]), _MODES[a[3]], a[4],
                             a[5], a[6])
            elif op == _SETTINGS:
                self.tracer.count_rays = bool(a[0])
                stats.tracing(bool(a[1]))
            elif op == _COLLECT:
                spans = [s for s in stats.collect()["spans"]
                         if s["name"] == "shard_render"]
                dist.gather_object(spans, None, dst=0, group=self.group)
            elif op == _STOP:
                return
            else:
                raise RuntimeError(f"frame loop: unknown command {op}")
