"""Render statistics and observability.

Counterpart of gradientdomain_mitsuba_tpu/utils/stats.py (Mitsuba's
StatsCounter/Statistics registry + phase timers,
src/libcore/statistics.cpp, timer.cpp): phase wall-clocks, closed-form
ray counts per integrator (the estimate the CLI prints when a tracer
did not count its rays on the device), and a printStats()-style table.
The measured counts come from the tracers' int64 ray tallies
(ops/common.instrument_intersectors).

Beside them, the program's trace: spans at its layer boundaries and
host counters (span, count, tracing, collect, reset, table).
"""
from __future__ import annotations

import time
import warnings
from collections import OrderedDict

import torch
from torch.autograd import profiler as _profiler


class RenderStats:
    def __init__(self):
        self.phases = OrderedDict()
        self.counters = OrderedDict()
        self._t0 = {}

    def start(self, phase: str):
        self._t0[phase] = time.time()

    def stop(self, phase: str):
        dt = time.time() - self._t0.pop(phase)
        self.phases[phase] = self.phases.get(phase, 0.0) + dt
        return dt

    def add(self, counter: str, value):
        self.counters[counter] = self.counters.get(counter, 0) + value

    def set(self, counter: str, value):
        self.counters[counter] = value

    # -- derived ray counts (per the BASELINE.md protocol) ----------------
    @staticmethod
    def rays_path(width, height, spp, max_depth):
        bounces = max(max_depth, 1)
        return width * height * spp * (1 + 2 * (bounces - 1))

    @staticmethod
    def rays_gpt(width, height, spp, max_depth):
        bounces = max(max_depth - 1, 1)
        return width * height * spp * (5 + bounces * 10)

    @staticmethod
    def rays_bdpt(width, height, spp, max_depth):
        d = max_depth
        n_strat = sum(1 for t in range(1, d + 2) for s in range(0, d + 1)
                      if 2 <= s + t and s + t - 1 <= d)
        return width * height * spp * (2 * d + n_strat)

    def table(self) -> str:
        lines = ["  Render statistics:"]
        for k, v in self.phases.items():
            lines.append(f"    {k:<28s} {v:9.2f} s")
        for k, v in self.counters.items():
            if isinstance(v, float):
                lines.append(f"    {k:<28s} {v:12.3f}")
            else:
                lines.append(f"    {k:<28s} {v:>12,}")
        return "\n".join(lines)


# -- the program's trace: spans and counters ------------------------------
# One in-memory trace a process.  Spans are recorded while tracing is on
# (tracing(True)) or while a torch profiler records (so a profile of the
# program carries its layers, on the profiler's clock); otherwise span()
# returns one shared no-op context and count() returns at once.  Host
# times are time.time_ns(), the base of the profiler's device events, so
# spans and device ops share one timeline.

# the message of torch's sync debug mode ("warn") at a synchronizing call
SYNC_MESSAGE = "called a synchronizing CUDA operation"


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("trace", "id", "parent", "name", "attrs", "path", "frame",
                 "start_ns", "end_ns", "counts", "events", "annotation",
                 "warnings")

    def __init__(self, trace, name, device, attrs):
        self.trace, self.name, self.attrs = trace, name, attrs
        self.counts = {}
        self.events = device    # True until __enter__ records the first
        self.annotation = self.warnings = self.end_ns = None

    def __enter__(self):
        t = self.trace
        t.next_id += 1
        self.id = t.next_id
        top = t.stack[-1] if t.stack else None
        label = self.name + "".join(f":{v}" for v in self.attrs.values())
        self.path = label if top is None else top.path + "/" + label
        self.parent = None if top is None else top.id
        self.frame = None if top is None else top.frame
        if self.frame is None and self.name == "render":
            self.frame = t.frames
            t.frames += 1
        if top is None:
            self.warnings = _count_syncs()
        t.stack.append(self)
        t.spans.append(self)
        if t.annotate:
            self.annotation = _profiler.record_function(self.name)
            self.annotation.__enter__()
        self.events = _device_event() if self.events else None
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        if self.events is not None:
            self.events = (self.events, _device_event())
        if self.annotation is not None:
            self.annotation.__exit__(None, None, None)
        t = self.trace
        if self in t.stack:
            t.stack.remove(self)
        if self.warnings is not None:
            self.warnings.__exit__(None, None, None)
        return False

    def record(self):
        dev = None
        if isinstance(self.events, tuple):
            self.events[1].synchronize()
            dev = self.events[0].elapsed_time(self.events[1])
        return dict(id=self.id, parent=self.parent, name=self.name,
                    attrs=dict(self.attrs), path=self.path,
                    frame=self.frame, start_ns=self.start_ns,
                    end_ns=self.end_ns, counts=dict(self.counts),
                    device_ms=dev)


def _device_event():
    """A timing CUDA event recorded on the current stream, or None where
    CUDA is not in use."""
    if not torch.cuda.is_initialized():
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _count_syncs():
    """While the outermost span is open, torch's sync debug mode warns at
    every synchronizing call; the warning is counted as host_syncs on the
    innermost open span and not shown.  Returns the context that undoes
    it, or None where CUDA is not in use."""
    if not torch.cuda.is_initialized():
        return None
    shown = warnings.showwarning

    def show(message, category, filename, lineno, file=None, line=None):
        if str(message).startswith(SYNC_MESSAGE):
            count("host_syncs")
        else:
            shown(message, category, filename, lineno, file, line)

    ctx = _SyncCounting(torch.cuda.get_sync_debug_mode())
    ctx.__enter__()
    warnings.filterwarnings("always", message=SYNC_MESSAGE)
    warnings.showwarning = show
    torch.cuda.set_sync_debug_mode("warn")
    return ctx


class _SyncCounting(warnings.catch_warnings):
    """catch_warnings that also restores the sync debug mode."""

    def __init__(self, mode):
        super().__init__()
        self.mode = mode

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode(self.mode)
        return super().__exit__(*exc)


class Trace:
    """The records: spans in order of entry, counters, the frame ids
    given out, the open spans."""

    def __init__(self):
        self.on = False
        self.annotate = False
        self.next_id = 0
        self.reset()

    def reset(self):
        self.spans, self.stack, self.counters = [], [], {}
        self.frames = 0


_TRACE = Trace()


def span(name, device=False, **attrs):
    """Context of one span: name, attributes, parent, frame id (a
    top-level `render` span opens a new frame; spans inside share it),
    host start and end.  device=True also records a CUDA event pair on
    the current stream, resolved at collect()."""
    if not (_TRACE.on or _profiler._is_profiler_enabled):
        return _NO_SPAN
    return _Span(_TRACE, name, device, attrs)


def count(name, n=1):
    """Add the host integer n to counter `name` and to the innermost open
    span's count.  Never reads a device value."""
    t = _TRACE
    if not (t.on or _profiler._is_profiler_enabled):
        return
    t.counters[name] = t.counters.get(name, 0) + n
    if t.stack:
        c = t.stack[-1].counts
        c[name] = c.get(name, 0) + n


def tracing(on=True, annotate=False):
    """Turn tracing on or off.  annotate: spans also enter
    torch.autograd.profiler.record_function, so a profile names the
    program's layers (the profiler then records them as ranges on the
    device too)."""
    _TRACE.on = bool(on)
    _TRACE.annotate = bool(on and annotate)


def collect():
    """{"spans": [record, ...], "counters": {...}} recorded since the last
    collect() or reset(), which are then cleared (open spans stay open).
    Call after synchronizing: device times are read here."""
    t = _TRACE
    out = dict(spans=[s.record() for s in t.spans],
               counters=dict(t.counters))
    t.spans, t.counters = [], {}
    return out


def reset():
    """Drop every record, open spans included, and restart frame ids."""
    _TRACE.reset()


def summarize(trace, per=1):
    """Rows of a collected trace, one per span path in order of first
    entry: calls, host ms (total, and self: less its direct children),
    device ms (spans that record events) and counts, each divided by
    `per` (frames)."""
    spans = trace["spans"]
    dur = {s["id"]: (s["end_ns"] or s["start_ns"]) - s["start_ns"]
           for s in spans}
    child = {}
    for s in spans:
        if s["parent"] in dur:
            child[s["parent"]] = child.get(s["parent"], 0) + dur[s["id"]]
    rows = OrderedDict()
    for s in spans:
        r = rows.setdefault(s["path"], dict(path=s["path"], calls=0,
                                            host_ms=0.0, self_ms=0.0,
                                            device_ms=None, counts={}))
        r["calls"] += 1
        r["host_ms"] += dur[s["id"]] / 1e6
        r["self_ms"] += (dur[s["id"]] - child.get(s["id"], 0)) / 1e6
        if s["device_ms"] is not None:
            r["device_ms"] = (r["device_ms"] or 0.0) + s["device_ms"]
        for k, v in s["counts"].items():
            r["counts"][k] = r["counts"].get(k, 0) + v
    for r in rows.values():
        for k in ("calls", "host_ms", "self_ms", "device_ms"):
            if r[k] is not None:
                r[k] /= per
        r["counts"] = {k: v / per for k, v in r["counts"].items()}
    return list(rows.values())


def table(trace, per=1, title="Trace"):
    """The rows of summarize() and the counters as text."""
    unit = "" if per == 1 else " a frame"
    lines = [f"  {title} (calls, host ms total / self, device ms{unit}):"]
    for r in summarize(trace, per):
        dev = "" if r["device_ms"] is None else f" {r['device_ms']:10.3f}"
        cnt = "".join(f" {k}={v:g}" for k, v in r["counts"].items())
        lines.append(f"    {r['path']:<52s} {r['calls']:8g} "
                     f"{r['host_ms']:10.3f} {r['self_ms']:10.3f}{dev}{cnt}")
    for k, v in trace["counters"].items():
        lines.append(f"    {k:<52s} {v / per:>12,g}")
    return "\n".join(lines)
