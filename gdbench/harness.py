"""One run of one cell: set-up, the measured window, the traced readings
and the check that decides `correct`.

Set-up builds the program from the cell's configuration (the route's
setup: kernels built or loaded from the program's build directory, the
scene loaded through its disk cache and put on the device, the tracer
made by the program's factory) and renders one frame of the cell's own
size.  The window renders frames back to back, a closed loop with one
client: frame i uses the seed frame_seed(--seed, i), and each frame is
timed from its call to the device's synchronize.  One frame of the
window, drawn from the seed, is kept for the check.

After the window the kept frame is rendered again with the program's
traversal calls recorded (and, with --trace 1, profiled with the frozen
roofline count of each call); the two renders must agree bit for bit.
Then the program is freed and the plain reference (reference/) renders
what the kept frame's outputs must be; the route compares them, and the
recorded calls' answers are compared with the reference's traversal on a
sample of each call's rays.
"""
from __future__ import annotations

import os
import random
import sys
import time
from types import SimpleNamespace

import torch

from . import registry, roofline, stats
from .reference import common as rcommon
from .reference import scene as rscene

# program knobs that would leave the default path
PROGRAM_KNOBS = ("GDMT_LANES", "GDMT_KERNEL", "GDMT_RAY_SORT")
TRACE_SECONDS = 10.0     # the longest traced window
SAMPLE_RAYS = 4096       # rays of each traversal call the check reads
# hit t agreement of program and reference: T_RTOL of t plus T_OTOL of
# the origin's largest coordinate (a t from far-off coordinates carries
# their rounding)
T_RTOL, T_OTOL = 1e-4, 1e-5


def frame_seed(seed, i):
    """The program's seed of frame i (a 31-bit integer)."""
    return random.Random(f"gdbench:{seed}:{i}").getrandbits(31)


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def profiler(device):
    from torch.profiler import ProfilerActivity, profile
    acts = ([ProfilerActivity.CUDA] if torch.device(device).type == "cuda"
            else [ProfilerActivity.CPU])
    return profile(activities=acts)


def device_events(prof):
    """(name, start_ns, end_ns) of every device op of the profile."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            s = e.start_ns()
            out.append((e.name(), s, s + e.duration_ns()))
    return out


def _is_kernel(name):
    return not name.startswith(("Memcpy", "Memset", "Memory"))


class Recorder:
    """Wraps a tracer's closest / occluded: samples each call's live rays
    and the program's answers for the check, and with `bounds` adds each
    call's frozen roofline bound (an any-hit call's bound needs the
    rays' closest hits: one more closest call, marked as not the
    program's)."""

    def __init__(self, tracer, gen, bounds, cbounds, window):
        self.tracer, self.gen, self.bounds = tracer, gen, bounds
        self.cbounds, self.window = cbounds, window
        self.samples, self.launch_tags, self.bound_ms, self.rays = \
            [], [], 0.0, 0
        self.orig = (tracer.closest, tracer.occluded)

    def _sample(self, kind, o, d, mint, maxt, answer):
        live = (maxt > mint).nonzero(as_tuple=True)[0]
        self.rays += int(live.shape[0])
        if live.shape[0] > SAMPLE_RAYS:
            pick = torch.randperm(live.shape[0], generator=self.gen)
            live = live[pick[:SAMPLE_RAYS].to(live.device)]
        rec = dict(kind=kind, o=o[live], d=d[live], mint=mint[live],
                   maxt=maxt[live])
        if kind == "closest":
            rec.update(valid=answer.valid[live], t=answer.t[live])
        else:
            rec.update(occ=answer[live])
        self.samples.append(rec)

    def __enter__(self):
        closest, occluded = self.orig

        def c(o, d, mint, maxt, geom):
            hit = closest(o, d, mint, maxt, geom)
            self.launch_tags.append(True)
            self._sample("closest", o, d, mint, maxt, hit)
            if self.bounds:
                self.bound_ms += roofline.traversal_bound(
                    (o, d, mint, maxt), hit.valid, hit.t, hit.prim, None,
                    self.cbounds, self.window)[0]
            return hit

        def a(o, d, mint, maxt, geom):
            occ = occluded(o, d, mint, maxt, geom)
            self.launch_tags.append(True)
            self._sample("occluded", o, d, mint, maxt, occ)
            if self.bounds:
                hit = closest(o, d, mint, maxt, geom)
                self.launch_tags.append(False)
                self.bound_ms += roofline.traversal_bound(
                    (o, d, mint, maxt), hit.valid, hit.t, hit.prim, occ,
                    self.cbounds, self.window)[0]
            return occ

        self.tracer.closest, self.tracer.occluded = c, a
        return self

    def __exit__(self, *exc):
        self.tracer.closest, self.tracer.occluded = self.orig


def _traced_window(events, window_s, frames, kernel_names):
    """Device busy time, launches and traversal kernel time of a traced
    window, and the breakdown the result line carries."""
    iv = [(s, e) for _, s, e in events]
    busy_s = stats.union_length(iv) / 1e9
    trav_ns = sum(e - s for n, s, e in events
                  if any(k in n for k in kernel_names))
    by_name = {}
    for n, s, e in events:
        by_name[n] = by_name.get(n, 0) + (e - s)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(stats.gaps(iv), key=lambda g: -g[0])[:10]
    return dict(
        busy_s=busy_s, window_s=window_s, frames=frames,
        launches=sum(1 for n, _, _ in events if _is_kernel(n)),
        traversal_ms=trav_ns / 1e6,
        breakdown=dict(
            device_ops=[[n[:160], ns / 1e9] for n, ns in top],
            idle_gaps=[[f"before {events[i][0][:150]}", g / 1e9]
                       for g, i in gaps]))


def _kernel_names():
    import json
    with open(os.path.join(registry.HERE, "kernels.json")) as f:
        return json.load(f)["traversal"]


def hit_check(samples, ds):
    """Share of the sampled rays whose answer the reference does not
    give: a closest hit that differs in validity or, both hitting, in t
    by more than T_RTOL of t plus T_OTOL of the origin's largest
    coordinate; an any-hit answer that differs."""
    bad = total = 0
    for s in samples:
        n = s["o"].shape[0]
        if n == 0:
            continue
        args = [s[k].to(ds.device) for k in ("o", "d", "mint", "maxt")]
        if s["kind"] == "closest":
            valid, t, _, _, _ = ds.accel.closest(*args)
            pv, pt = s["valid"].to(ds.device), s["t"].to(ds.device)
            tol = (T_RTOL * t.float().abs() +
                   T_OTOL * args[0].float().abs().amax(-1))
            same = (valid == pv) & (~valid | ((t.float() - pt.float()).abs()
                                              <= tol))
        else:
            same = ds.accel.occluded(*args) == s["occ"].to(ds.device)
        bad += int((~same).sum())
        total += n
    return bad / max(total, 1)


def reference_scene(cell, variables, device, dtype=torch.float32):
    """The plain reference's scene on the device."""
    rs = rscene.load(registry.scene_path(cell.config, cell.root), variables)
    return rcommon.DeviceScene(rs, device, dtype)


def check(cell, route, ds, frame_seed, out, samples, seed):
    """The numbers that decide `correct` but replay_diff: the route's
    comparison of the frame's outputs with the reference's, and the
    sampled traversal answers against the reference's traversal."""
    numbers = route.compare(cell, out, route.expected(cell, ds, frame_seed,
                                                      out, seed))
    numbers["hit_mismatch_share"] = hit_check(samples, ds)
    return numbers


def run_cell(cell, seed, seconds, trace, device, t_start):
    """Returns (result dict, [(check name, value, limit)]).  The result
    has the keys of the benchmark's result line but `checks`."""
    for k in PROGRAM_KNOBS:
        os.environ.pop(k, None)
    route = registry.module("routes", cell.config["route"], cell.root)
    is_cuda = torch.device(device).type == "cuda"

    # ---- set-up -----------------------------------------------------------
    prog = route.setup(cell, device)
    route.frame(prog, frame_seed(seed, -1))
    sync(device)
    setup_s = time.perf_counter() - t_start

    # ---- the window ------------------------------------------------------
    limit = min(seconds, TRACE_SECONDS) if trace else seconds
    pick = random.Random(f"gdbench:{seed}:pick")
    bad = torch.zeros((), dtype=torch.int64, device=device)
    walls, rays, kept = [], 0, None
    route.count_rays(prog, bool(trace))
    prof = profiler(device) if trace else None
    if prof is not None:
        prof.__enter__()
    t0 = time.perf_counter()
    while True:
        fs = frame_seed(seed, len(walls))
        tf = time.perf_counter()
        out = route.frame(prog, fs)
        sync(device)
        t1 = time.perf_counter()
        walls.append(t1 - tf)
        if trace:
            rays += route.frame_rays(prog, out)
        bad += (~torch.isfinite(out["image"])).any()
        if pick.random() * len(walls) < 1.0:
            kept = (fs, out)
        if t1 - t0 >= limit:
            break
    window_s = t1 - t0
    if prof is not None:
        prof.__exit__(None, None, None)
    route.count_rays(prog, False)
    failed = int(bad)
    mem_peak = torch.cuda.max_memory_allocated(device) if is_cuda else 0
    w = sorted(walls)
    print(f"window: {len(walls)} frames in {window_s:.3f} s, frame wall "
          f"min {w[0]:.4f} median {w[len(w) // 2]:.4f} max {w[-1]:.4f} s",
          file=sys.stderr)

    rec = SimpleNamespace(
        frames=len(walls), walls=walls, window_s=window_s,
        samples_per_frame=prog.samples_per_frame, setup_s=setup_s,
        spans=dict(prog.spans), trace=None)
    if trace:
        kernels = _kernel_names()
        rec.trace = _traced_window(device_events(prof), window_s,
                                   len(walls), kernels)
        rec.trace["rays"] = rays
        rec.spans.update(route.after_window(prog, out))
        del prof

    # ---- replay of the kept frame, its traversal calls recorded -----------
    kseed, kout = kept
    gen = torch.Generator().manual_seed(frame_seed(seed, "rays"))
    geom = prog.scene.geom
    bounds = (bool(trace) and is_cuda and
              hasattr(prog.tracer.kernels[0], "n_clusters"))
    recd = Recorder(prog.tracer, gen, bounds, geom.cbounds,
                     prog.settings.cluster_window)
    rprof = profiler(device) if bounds else None
    with recd:
        if rprof is not None:
            rprof.__enter__()
        rout = route.frame(prog, kseed)
        sync(device)
        if rprof is not None:
            rprof.__exit__(None, None, None)
    replay_diff = max(float((rout[k].float() - kout[k].float()).abs().max())
                      for k in kout if torch.is_tensor(kout[k]) and
                      kout[k].is_floating_point())
    if rprof is not None:
        trav = [e for e in device_events(rprof)
                if any(k in e[0] for k in kernels)]
        if len(trav) == len(recd.launch_tags):
            k_ms = sum(e - s for (_, s, e), mine in zip(trav, recd.launch_tags)
                       if mine) / 1e6
            rec.trace["roofline"] = dict(bound_ms=recd.bound_ms,
                                         kernel_ms=k_ms, rays=recd.rays)
        del rprof
    samples = recd.samples
    variables = prog.variables
    del prog, out, rout, recd, kept
    if is_cuda:
        torch.cuda.empty_cache()

    # ---- the check --------------------------------------------------------
    ds = reference_scene(cell, variables, device)
    numbers = check(cell, route, ds, kseed, kout, samples, seed)
    numbers["replay_diff"] = replay_diff
    checks = [(k, float(v), float(cell.limits[k]))
              for k, v in numbers.items()]
    correct = failed == 0 and all(v <= lim for _, v, lim in checks)

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = registry.module("metrics", m["name"], cell.root).read(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {"correct": correct, "attempted": len(walls), "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if is_cuda else "cpu",
                         "kind": (torch.cuda.get_device_name(device)
                                  if is_cuda else "cpu"),
                         "count": cell.chips,
                         "memory_peak_bytes": int(mem_peak)}}
    if trace:
        result["device"]["busy_s"] = rec.trace["busy_s"]
        result["device"]["window_s"] = rec.trace["window_s"]
        result["breakdown"] = rec.trace["breakdown"]
    return result, checks
