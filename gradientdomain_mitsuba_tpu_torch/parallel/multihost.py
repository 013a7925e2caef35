"""Multi-process rendering over torch.distributed — the mtssrv analog.

Counterpart of gradientdomain_mitsuba_tpu/parallel/multihost.py
(Mitsuba's cluster rendering, src/libcore/sched_remote.cpp +
src/mitsuba/mtssrv.cpp).  Instead of a TCP daemon receiving serialized
scenes and work units, every process loads the scene from disk itself
(a replicated resource), joins one torch.distributed process group with
one rank per device, and runs the row-sharded tile renderer
(parallel/tiles.py): its halo sends cross process boundaries, and the
final film is gathered on every rank.

NCCL joins CUDA devices (rank r on cuda:r % device_count); gloo joins
CPU processes, which is how the tests run several ranks on one machine.
Importing this module initializes nothing.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def init(coordinator_address: str, num_processes: int, process_id: int,
         local_device_count: int | None = None, device: str = "cuda"):
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
                            rank=process_id)
    return dev


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
