"""Run one cell of the benchmark once and print its result line.

    python3 -m gdbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  The last line of standard output is one
JSON object: correct, attempted, failed, metrics (the cell's end-to-end
metrics with --trace 0, its per-layer metrics with --trace 1), device,
with --trace 1 a breakdown, and last `checks`: each number that decides
`correct` with its limit (also the last lines on standard error).  Exits
non-zero with no result where there is no CUDA device, fewer than the
cell asks for, or a JAX module is loaded in the process.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def _fail(msg):
    print(f"gdbench: {msg}", file=sys.stderr)
    return 2


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from gdbench import harness, nojax, registry
    found = nojax.loaded()
    if found:
        return _fail(f"JAX modules loaded at start: {', '.join(found)}")
    import torch
    cell = registry.cell(args.workload)
    if not torch.cuda.is_available():
        return _fail("no CUDA device (torch.cuda.is_available() is False)")
    if torch.cuda.device_count() < cell.chips:
        return _fail(f"{cell.name} needs {cell.chips} devices, "
                     f"{torch.cuda.device_count()} visible")
    result, checks = harness.run_cell(cell, args.seed, args.seconds,
                                      args.trace, "cuda:0", T_START)
    found = nojax.loaded()
    if found:
        return _fail(f"JAX modules loaded after the window: "
                     f"{', '.join(found)}")
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in checks}
    for k, v, lim in checks:
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
