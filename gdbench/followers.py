"""The other ranks of a cell that spans several devices: processes a
route starts beside the harness's own (rank 0), each of which joins the
program's process group on its device, loads the cell's scene and makes
its tracer as program.setup does, and follows rank 0's frame loop
(the program's parallel/multihost.FrameLoop) until rank 0 stops it.

    python3 -m gdbench.followers <json spec>

from the checkout's root (start() runs it).  A follower exits when rank 0
stops its loop or when the process that started it is gone; the
harness's process stops its followers when it exits, or when a route
starts others in it.
"""
from __future__ import annotations

import atexit
import json
import os
import socket
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import torch

_LIVE = []


class Followers:
    """Ranks 1 .. world - 1 of the group at `addr` ("host:port") and of
    the frame loop that rank 0, this process, leads (`loop`, set once
    rank 0 has made it)."""

    def __init__(self, addr, procs):
        self.addr, self.procs, self.loop = addr, procs, None

    def stop(self, leave=True):
        """Release the followers and wait for them; with `leave`, leave
        the process group too (a process that is exiting need not)."""
        loop, self.loop = self.loop, None
        try:
            if loop is not None and torch.distributed.is_initialized():
                loop.stop()
        finally:
            for p in self.procs:
                try:
                    p.wait(timeout=60)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
            self.procs = []
            if leave and torch.distributed.is_initialized():
                torch.distributed.destroy_process_group()


def _stop_all(leave=True):
    while _LIVE:
        _LIVE.pop().stop(leave)


atexit.register(_stop_all, False)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def start(cell, kind):
    """Start ranks 1 .. cell.chips - 1 of a group on this host, on devices
    of `kind` ("cuda": rank r on cuda:r; "cpu": gloo), for the cell's
    configuration and traffic.  Stops the followers an earlier set-up of
    this process started."""
    _stop_all()
    addr = f"127.0.0.1:{_free_port()}"
    spec = dict(root=cell.root, config=cell.config, traffic=cell.traffic,
                addr=addr, world=cell.chips, kind=kind)
    f = Followers(addr, [subprocess.Popen(
        [sys.executable, "-m", "gdbench.followers",
         json.dumps(dict(spec, rank=r))], cwd=cell.root, stdout=2)
        for r in range(1, cell.chips)])
    _LIVE.append(f)
    return f


def _watch(parent):
    """Exit when the process that started this one is gone."""
    while os.getppid() == parent:
        time.sleep(1.0)
    os._exit(1)


def follow(spec):
    from gradientdomain_mitsuba_tpu_torch.parallel import multihost

    from gdbench import program
    threading.Thread(target=_watch, args=(os.getppid(),), daemon=True).start()
    if spec["kind"] == "cpu":
        torch.set_num_threads(1)
    dev = multihost.init(spec["addr"], spec["world"], spec["rank"],
                         device=spec["kind"])
    cell = SimpleNamespace(config=spec["config"], traffic=spec["traffic"],
                           root=spec["root"])
    prog = program.setup(cell, str(dev))
    multihost.FrameLoop(prog.tracer, prog.scene).follow()
    # stopped: nothing is left to do or to keep, and an NCCL group's
    # teardown can wait on ranks that are leaving too
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


if __name__ == "__main__":
    follow(json.loads(sys.argv[1]))
