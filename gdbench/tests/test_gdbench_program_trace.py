"""The readers of the program's trace (program_trace.py and the metrics
that read it) on synthetic records, the labelling of idle gaps on
synthetic intervals, and a traced CPU run of each cell reading the
program's own spans."""
import time
from types import SimpleNamespace

import pytest
from conftest import grove_cell

from gdbench import harness, program_trace, registry
from gradientdomain_mitsuba_tpu_torch.utils import stats as pstats

NEW = ("solve_ms_per_frame", "render_idle_ms_per_frame",
       "host_syncs_per_frame", "traversal_live_share")


def _span(id_, name, start, end, parent=None, frame=0, path=None,
          device_ms=None, **counts):
    return dict(id=id_, parent=parent, name=name, attrs={},
                path=path or name, frame=frame, start_ns=start,
                end_ns=end, counts=counts, device_ms=device_ms)


def _rec(tr, frames=2, busy_s=0.25, rays=300):
    return SimpleNamespace(frames=frames, program_trace=tr,
                           trace=dict(busy_s=busy_s, rays=rays,
                                      window_s=1.0))


def _read(name, rec):
    return registry.module("metrics", name).read(rec)


def test_readers_on_a_synthetic_trace():
    spans = [
        _span(1, "render", 0, 100, device_ms=140.0, host_syncs=1),
        _span(2, "traverse", 10, 20, 1, path="render/traverse",
              lanes=400),
        _span(3, "solve", 50, 90, 1, path="render/solve", device_ms=30.0),
        _span(4, "render", 200, 300, frame=1, device_ms=160.0),
        _span(5, "traverse", 210, 220, 4, frame=1, path="render/traverse",
              lanes=600, host_syncs=2),
        _span(6, "solve", 250, 290, 4, frame=1, path="render/solve",
              device_ms=34.0),
    ]
    tr = dict(spans=spans, counters=dict(lanes=1000, host_syncs=3),
              frames=2)
    rec = _read_all(tr)
    assert rec["solve_ms_per_frame"] == pytest.approx(32.0)
    # (140 + 160 ms of frames - 250 ms busy) / 2 frames
    assert rec["render_idle_ms_per_frame"] == pytest.approx(25.0)
    assert rec["host_syncs_per_frame"] == pytest.approx(1.5)
    assert rec["traversal_live_share"] == pytest.approx(30.0)


def _read_all(tr, **kw):
    rec = _rec(tr, **kw)
    return {m: _read(m, rec) for m in NEW}


def test_readers_read_none_without_a_trace(monkeypatch):
    """A program without the trace (the parent commit) gives None."""
    assert all(v is None for v in _read_all(None).values())
    monkeypatch.setattr(program_trace, "_program_stats", lambda: None)
    rec = SimpleNamespace(frames=2, trace=dict(busy_s=1.0, rays=5))
    assert program_trace.window(rec) is None
    assert all(_read(m, rec) is None for m in NEW)


def test_readers_without_device_times():
    """A CPU run records no device times: solve and idle read None."""
    spans = [_span(1, "render", 0, 10, lanes=10),
             _span(2, "solve", 2, 8, 1, path="render/solve")]
    got = _read_all(dict(spans=spans, counters=dict(lanes=10), frames=1),
                    frames=1, rays=5)
    assert got == {"solve_ms_per_frame": None,
                   "render_idle_ms_per_frame": None,
                   "host_syncs_per_frame": 0.0,
                   "traversal_live_share": 50.0}


def test_window_keeps_the_first_frames():
    """The window's frames come first; a later frame (the kept frame's
    replay) and spans outside frames are left out."""
    pstats.reset()
    pstats.tracing(True)
    try:
        for i in range(3):
            with pstats.span("render"):
                pstats.count("lanes", 10 * (i + 1))
        with pstats.span("solve"):
            pstats.count("lanes", 1000)
    finally:
        pstats.tracing(False)
    rec = SimpleNamespace(frames=2, trace=dict(busy_s=0.0, rays=0))
    tr = program_trace.window(rec)
    assert tr["counters"] == {"lanes": 30}
    assert [s["frame"] for s in tr["spans"]] == [0, 1]
    assert program_trace.window(rec) is tr
    rec = SimpleNamespace(frames=2, trace=dict(busy_s=0.0, rays=0))
    assert program_trace.window(rec) is None  # the trace was collected


def test_gap_labels():
    """A gap ending inside nested spans takes the innermost; one ending
    outside every span is the harness's."""
    spans = [_span(1, "render", 100, 1000),
             _span(2, "pass", 150, 900, 1, path="render/pass"),
             _span(3, "shift", 400, 600, 2, path="render/pass/shift")]
    events = [("k0", 0, 50), ("k1", 120, 200), ("k2", 450, 500),
              ("k3", 520, 560), ("k4", 1200, 1300)]
    gaps = program_trace.label_gaps(events, spans)
    assert [g[0] for g in gaps] == [
        "harness | before k4", "render/pass/shift | before k2",
        "render | before k1", "render/pass/shift | before k3"]
    assert [g[1] for g in gaps] == [640e-9, 250e-9, 70e-9, 20e-9]
    assert [g[3] for g in gaps] == [None, 400, 100, 400]
    ops = [e + (e[1] - 10,) for e in events]
    ops[3] = ops[3][:3] + (530,)   # starts before its launch
    checks = program_trace.clock_checks(
        ops, spans + [_span(4, "solve", 440, 470, 1, path="render/solve")],
        gaps)
    assert checks["starts_before_launch"] == 1
    assert checks["min_start_after_launch_us"] == -10e-3
    assert checks["solve_ops"] == 1 and checks["solve_ops_before_span"] == 0
    assert checks["solve_busy_ms"] == 50e-6
    assert checks["labelled_gaps"] == 3
    assert checks["gap_kernels_before_span"] == 0
    # each op's device time goes to the innermost span open at its launch
    assert program_trace.device_ms_by_span(ops, spans) == {
        "harness": 100e-6 + 50e-6, "render": 80e-6,
        "render/pass/shift": 50e-6 + 40e-6}


@pytest.mark.parametrize("name", ["forest-path.2560x1440-1spp",
                                  "forest-gpt-l1.1920x1080-4spp"])
def test_a_traced_cpu_run_reads_the_program_trace(name):
    """The traced window runs under the profiler, so the program records
    its spans: the live share and the syncs (none on the CPU) read."""
    pstats.reset()
    cell = grove_cell(name)
    res, checks = harness.run_cell(cell, 2**31 + 91, 0.05, 1, "cpu",
                                   time.perf_counter())
    assert res["correct"], checks
    got = res["metrics"]
    assert got["host_syncs_per_frame"]["value"] == 0
    assert 0 < got["traversal_live_share"]["value"] <= 100
    assert "solve_ms_per_frame" not in got   # no device times on the CPU
