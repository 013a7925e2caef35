"""Readings that set the limits of `correct`: the numbers the check
compares, for the program's frames on many seeds and for the control
(the reference in the program's place, computed in bfloat16), at the
cell's own size, in one process.

    python3 -m gdbench.readings --workload <cell> --seeds 1,2,3 \\
        --control-seeds 4,5,6 [--out FILE]

Prints one JSON line per seed (and appends it to FILE): the side
("program" or "control"), the seed, each number, the seconds the
reference took.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from gdbench import harness, registry


def _ints(s):
    return [int(x) for x in s.split(",") if x]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_ints, default=[])
    ap.add_argument("--control-seeds", type=_ints, default=[])
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    dev = "cuda:0"
    cell = registry.cell(args.workload)
    route = registry.module("routes", cell.config["route"], cell.root)
    prog = route.setup(cell, dev)
    route.frame(prog, 1)
    ds = harness.reference_scene(cell, prog.variables, dev)
    low = harness.reference_scene(cell, prog.variables, dev, torch.bfloat16)
    geom = prog.scene.geom
    jobs = ([("program", s) for s in args.seeds] +
            [("control", s) for s in args.control_seeds])
    for side, seed in jobs:
        fs = harness.frame_seed(seed, 0)
        rec = harness.Recorder(prog.tracer, torch.Generator().manual_seed(
            harness.frame_seed(seed, "rays")), False, geom.cbounds,
            prog.settings.cluster_window)
        with rec:
            out = route.frame(prog, fs)
        harness.sync(dev)
        t0 = time.perf_counter()
        samples = rec.samples
        if side == "control":
            out = route.control(cell, low, fs, out, seed)
            for s in samples:
                args_ = [s[k] for k in ("o", "d", "mint", "maxt")]
                if s["kind"] == "closest":
                    s["valid"], s["t"] = low.accel.closest(*args_)[:2]
                else:
                    s["occ"] = low.accel.occluded(*args_)
        nums = harness.check(cell, route, ds, fs, out, samples, seed)
        harness.sync(dev)
        line = dict(side=side, seed=seed, numbers=nums,
                    seconds=time.perf_counter() - t0)
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
