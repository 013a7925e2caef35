"""The program's own trace (its utils/stats.py spans and counters) for the
benchmark: what the per-layer metrics of a --trace 1 run read, and a
tool that runs a cell with the trace on from set-up.

The traced window runs under torch.profiler, and the program records its
spans while a profiler records: the metrics read the spans of the
window's frames (a frame is one top-level `render` span; the kept
frame's replay after the window comes later and is left out).  A program
without that trace gives nothing, and the metrics read None.

    python3 -m gdbench.program_trace --workload <cell> --seed <n> \\
        [--seconds 10] [--cost-frames 0] [--out FILE]

turns the program's tracing on before set-up, renders the cell's frames
for --seconds under the profiler and prints: the span tables of set-up
and of a frame, the 10 longest device idle gaps labelled by the
innermost program span open on the host when each ended, and the shared
clock's checks (every device op starts after its launch; the ops
launched inside a `solve` span start after its host start; the kernel
after each labelled gap starts after the host start of its span).  With
--cost-frames n it then renders n untraced frames with the program's
tracing on and n with it off, in turns.  The last line of standard
output is one JSON object; --out also writes it to FILE.  Needs a CUDA
device.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402


def _program_stats():
    """The program's utils/stats module where it has a trace, else None."""
    try:
        from gradientdomain_mitsuba_tpu_torch.utils import stats
    except ImportError:
        return None
    return stats if hasattr(stats, "collect") else None


def window(rec):
    """The program's trace of the traced window: {"spans", "counters"
    (summed over those spans), "frames"}, or None (no trace, or fewer
    traced frames than the window's).  Collected once a record; the first
    read prints its table on standard error."""
    if not hasattr(rec, "program_trace"):
        rec.program_trace = _window(rec)
    return rec.program_trace


def _window(rec):
    stats = _program_stats()
    if rec.trace is None or stats is None:
        return None
    got = stats.collect()
    frames = []
    for s in got["spans"]:
        if s["frame"] is not None and s["frame"] not in frames:
            frames.append(s["frame"])
    if len(frames) < rec.frames:
        return None
    keep = set(frames[:rec.frames])
    spans = [s for s in got["spans"] if s["frame"] in keep]
    counters = {}
    for s in spans:
        for k, v in s["counts"].items():
            counters[k] = counters.get(k, 0) + v
    tr = dict(spans=spans, counters=counters, frames=rec.frames)
    print(stats.table(tr, per=rec.frames, title="Program trace"),
          file=sys.stderr)
    return tr


def device_ms(tr, name):
    """Device ms summed over the spans `name`, or None where none of them
    recorded it."""
    ms = [s["device_ms"] for s in tr["spans"]
          if s["name"] == name and s["device_ms"] is not None]
    return sum(ms) if ms else None


def frame_spans(tr):
    """The top-level `render` span of each frame."""
    return [s for s in tr["spans"] if s["name"] == "render" and
            s["parent"] is None]


def innermost(spans, t_ns):
    """The innermost span open at host time t_ns, or None."""
    best = None
    for s in spans:
        if s["start_ns"] <= t_ns < (s["end_ns"] or s["start_ns"]):
            if best is None or s["start_ns"] >= best["start_ns"]:
                best = s
    return best


def label_gaps(events, spans, n=10):
    """The n longest idle gaps between device ops, longest first: [label,
    seconds], the label the path of the innermost span open on the host
    when the gap ended (the next op's start), or "harness", then the op
    after the gap.  events: (name, start_ns, end_ns)."""
    from gdbench import stats
    iv = [(s, e) for _, s, e in events]
    out = []
    for g, i in sorted(stats.gaps(iv), key=lambda g: -g[0])[:n]:
        name, start, _ = events[i]
        sp = innermost(spans, start)
        where = "harness" if sp is None else sp["path"]
        out.append([f"{where} | before {name[:120]}", g / 1e9, i,
                    None if sp is None else sp["start_ns"]])
    return out


def launches(prof):
    """(name, start_ns, end_ns, launch_ns) of every device op: launch_ns
    is the host start of the CUDA runtime call that launched it (the
    same correlation id), or None."""
    import torch
    host, dev = {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            dev.append(e)
        elif e.name().startswith("cu"):
            host[e.correlation_id()] = e.start_ns()
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
             host.get(e.correlation_id())) for e in dev]


def device_ms_by_span(ops, spans):
    """Device ms of the ops launched inside each span path (the innermost
    span open at the launch; "harness" outside every span), by a sweep
    over launch times.  ops: launches()'s tuples."""
    bounds = sorted([(s["start_ns"], 1, i) for i, s in enumerate(spans)] +
                    [(s["end_ns"], 0, i) for i, s in enumerate(spans)])
    out, stack, j = {}, [], 0
    for _, start, end, launch in sorted((o for o in ops
                                         if o[3] is not None),
                                        key=lambda o: o[3]):
        while j < len(bounds) and bounds[j][0] <= launch:
            if bounds[j][1]:
                stack.append(bounds[j][2])
            else:
                stack.remove(bounds[j][2])
            j += 1
        key = spans[stack[-1]]["path"] if stack else "harness"
        out[key] = out.get(key, 0.0) + (end - start) / 1e6
    return out


def clock_checks(ops, spans, gaps):
    """The shared clock's checks on a traced window, and the device busy
    time of the ops launched inside `solve` spans."""
    from gdbench import stats
    linked = [o for o in ops if o[3] is not None]
    solves = [s for s in spans if s["name"] == "solve"]
    in_solve = [(o, s) for s in solves for o in linked
                if s["start_ns"] <= o[3] < s["end_ns"]]
    labelled = [g for g in gaps if g[3] is not None]
    return dict(
        ops=len(ops), linked=len(linked),
        starts_before_launch=sum(1 for o in linked if o[1] < o[3]),
        min_start_after_launch_us=min((o[1] - o[3] for o in linked),
                                      default=0) / 1e3,
        solve_ops=len(in_solve),
        solve_ops_before_span=sum(1 for o, s in in_solve
                                  if o[1] < s["start_ns"]),
        solve_busy_ms=stats.union_length(
            [(o[1], o[2]) for o, _ in in_solve]) / 1e6,
        labelled_gaps=len(labelled),
        gap_kernels_before_span=sum(1 for g in labelled
                                    if ops[g[2]][1] < g[3]))


def _card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--cost-frames", type=int, default=0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    from gdbench import harness, registry
    from gradientdomain_mitsuba_tpu_torch.utils import stats as pstats
    if not torch.cuda.is_available():
        print("gdbench: no CUDA device", file=sys.stderr)
        return 2
    dev = "cuda:0"
    cell = registry.cell(args.workload)
    route = registry.module("routes", cell.config["route"], cell.root)

    pstats.reset()
    pstats.tracing(True)
    t0 = time.perf_counter()
    prog = route.setup(cell, dev)
    route.frame(prog, harness.frame_seed(args.seed, -1))
    harness.sync(dev)
    setup_s = time.perf_counter() - T_START
    setup = pstats.collect()
    print(pstats.table(setup, title="Set-up"), file=sys.stderr)
    top = [s for s in setup["spans"] if s["parent"] is None]
    prog_s = sum(s["end_ns"] - s["start_ns"] for s in top) / 1e9

    route.count_rays(prog, True)
    walls, rays = [], 0
    with harness.profiler(dev) as prof:
        tw = time.perf_counter()
        while time.perf_counter() - tw < args.seconds:
            tf = time.perf_counter()
            out = route.frame(prog, harness.frame_seed(args.seed, len(walls)))
            harness.sync(dev)
            walls.append(time.perf_counter() - tf)
            rays += route.frame_rays(prog, out)
        window_s = time.perf_counter() - tw
    route.count_rays(prog, False)
    pstats.tracing(False)
    win = pstats.collect()
    n = len(walls)
    print(pstats.table(win, per=n, title="A traced frame"), file=sys.stderr)
    ops = launches(prof)
    events = [o[:3] for o in ops]
    gaps = label_gaps(events, win["spans"])
    for g in gaps:
        print(f"gap {g[1] * 1e3:9.3f} ms  {g[0]}", file=sys.stderr)
    for k, v in device_ms_by_span(ops, win["spans"]).items():
        print(f"device {v / n:10.3f} ms a frame  {k}", file=sys.stderr)

    from gdbench import stats as gstats
    busy_ms = gstats.union_length([(s, e) for _, s, e in events]) / 1e6
    frame_ms = sum(s["device_ms"] or 0.0 for s in frame_spans(win))
    lanes = sum(s["counts"].get("lanes", 0) for s in win["spans"])
    result = dict(
        workload=cell.name, seed=args.seed, card=_card(),
        setup_s=setup_s, setup_program_s=prog_s,
        setup_before_program_s=t0 - T_START,
        setup_spans=pstats.summarize(setup),
        frames=n, window_s=window_s,
        wall_median_s=statistics.median(walls),
        busy_ms_per_frame=busy_ms / n,
        render_idle_ms_per_frame=(frame_ms - busy_ms) / n,
        solve_ms_per_frame=(device_ms(win, "solve") or 0.0) / n,
        host_syncs_per_frame=win["counters"].get("host_syncs", 0) / n,
        live_share=rays / lanes if lanes else None,
        frame_spans=pstats.summarize(win, per=n),
        device_ms_by_span={k: v / n for k, v in
                           device_ms_by_span(ops, win["spans"]).items()},
        idle_gaps=[g[:2] for g in gaps],
        clock=clock_checks(ops, win["spans"], gaps))
    del prof

    if args.cost_frames:
        cost = {True: [], False: []}
        for i in range(2 * args.cost_frames):
            on = i % 2 == 0
            pstats.tracing(on)
            tf = time.perf_counter()
            route.frame(prog, harness.frame_seed(args.seed, 10_000 + i))
            harness.sync(dev)
            cost[on].append(time.perf_counter() - tf)
            pstats.tracing(False)
            pstats.reset()
        result["untraced_walls_s"] = {"tracing_on": cost[True],
                                      "tracing_off": cost[False]}
        result["untraced_wall_median_s"] = {
            "tracing_on": statistics.median(cost[True]),
            "tracing_off": statistics.median(cost[False])}
    line = json.dumps(result)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
