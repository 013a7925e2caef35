"""The program's trace (utils/stats.py: span, count, tracing, collect,
reset) on the CPU: off it records nothing and reads no clock; on, spans
nest with parent and frame id, counters add up, a torch profiler turns
recording on without annotating, and the renders' span trees come out
of PathTracer.render and GPTracer.render_final with the same image bits
as untraced.  The solve's iterates do not depend on whether its CG
residuals are recorded."""
import os
import time
import warnings

import pytest
import torch

from gradientdomain_mitsuba_tpu_torch.models import poisson
from gradientdomain_mitsuba_tpu_torch.models.gpt import GPTracer
from gradientdomain_mitsuba_tpu_torch.models.path import PathTracer
from gradientdomain_mitsuba_tpu_torch.scene import bridge
from gradientdomain_mitsuba_tpu_torch.scene import scene as port_scene
from gradientdomain_mitsuba_tpu_torch.utils import stats

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CBOX = os.path.join(ROOT, "data/scenes/cbox/cbox.xml")


@pytest.fixture(autouse=True)
def clean_trace():
    stats.tracing(False)
    stats.reset()
    yield
    stats.tracing(False)
    stats.reset()


@pytest.fixture()
def clock(monkeypatch):
    """time.time_ns as a counter: each read advances 1,000 ns."""
    now = [0]

    def fake():
        now[0] += 1000
        return now[0]
    monkeypatch.setattr(time, "time_ns", fake)
    return now


def test_off_records_nothing_and_reads_no_clock(monkeypatch):
    def no_clock():
        raise AssertionError("a clock was read with tracing off")
    monkeypatch.setattr(time, "time_ns", no_clock)
    a = stats.span("render")
    b = stats.span("solve", device=True, i=3)
    assert a is b
    with a, b:
        stats.count("lanes", 5)
    assert stats.collect() == {"spans": [], "counters": {}}


def test_spans_nest_with_parent_and_frame(clock):
    stats.tracing(True)
    with stats.span("load_scene"):
        with stats.span("parse"):
            pass
    for _ in range(2):
        with stats.span("render"):
            with stats.span("pass"):
                with stats.span("bounce", b=0):
                    stats.count("lanes", 7)
                    with stats.span("traverse", kind="closest"):
                        stats.count("lanes", 3)
            with stats.span("render"):  # nested: no frame of its own
                stats.count("host_syncs")
    t = stats.collect()
    paths = [s["path"] for s in t["spans"]]
    assert paths[:2] == ["load_scene", "load_scene/parse"]
    assert paths[2:7] == ["render", "render/pass", "render/pass/bounce:0",
                          "render/pass/bounce:0/traverse:closest",
                          "render/render"]
    by_id = {s["id"]: s for s in t["spans"]}
    for s in t["spans"]:
        if s["parent"] is not None:
            assert s["path"].startswith(by_id[s["parent"]]["path"] + "/")
            assert s["start_ns"] > by_id[s["parent"]]["start_ns"]
            assert s["end_ns"] < by_id[s["parent"]]["end_ns"]
    assert [s["frame"] for s in t["spans"]] == [None] * 2 + [0] * 5 + \
        [1] * 5
    assert t["counters"] == {"lanes": 20, "host_syncs": 2}
    # span ids run on through the process (reset() restarts frame ids
    # only), so the first frame's spans are found by their place
    spans = t["spans"]
    assert [s["id"] - spans[0]["id"] for s in spans] == list(range(12))
    assert spans[4]["counts"] == {"lanes": 7}
    assert spans[5]["counts"] == {"lanes": 3}
    assert spans[6]["counts"] == {"host_syncs": 1}
    assert all(s["device_ms"] is None for s in t["spans"])
    rows = {r["path"]: r for r in stats.summarize(t, per=2)}
    assert rows["render"]["calls"] == 1
    assert rows["render/pass/bounce:0"]["counts"] == {"lanes": 7}
    # self = duration less the direct children's
    b = rows["render/pass/bounce:0"]
    tr = rows["render/pass/bounce:0/traverse:closest"]
    assert b["self_ms"] == pytest.approx(b["host_ms"] - tr["host_ms"])
    text = stats.table(t, per=2)
    assert "render/pass/bounce:0" in text and "host_syncs" in text
    assert stats.collect() == {"spans": [], "counters": {}}


def test_reset_restarts_frames_and_tracing_off_stops(clock):
    stats.tracing(True)
    with stats.span("render"):
        pass
    stats.reset()
    with stats.span("render"):
        stats.tracing(False)
        with stats.span("pass"):
            stats.count("lanes", 1)
    t = stats.collect()
    assert [(s["path"], s["frame"]) for s in t["spans"]] == [("render", 0)]
    assert t["counters"] == {}


def test_sync_warnings_counted_on_innermost_span(monkeypatch):
    """Where CUDA is in use, the outermost span turns torch's sync debug
    mode to "warn"; each sync warning is counted on the innermost open
    span and not shown, other warnings pass, and the mode and warning
    filters come back when the span closes."""
    modes = [0]
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode",
                        lambda: modes[-1])
    monkeypatch.setattr(
        torch.cuda, "set_sync_debug_mode",
        lambda m: modes.append({"warn": 1}.get(m, m)))
    monkeypatch.setattr(stats, "_device_event", lambda: None)
    filters = list(warnings.filters)
    stats.tracing(True)
    with stats.span("render"):
        assert modes[-1] == 1
        with stats.span("pass"):
            for _ in range(3):
                warnings.warn(stats.SYNC_MESSAGE + " (function item)")
        warnings.warn(stats.SYNC_MESSAGE)
        with pytest.warns(UserWarning, match="another"):
            warnings.warn("another warning")
    assert modes[-1] == 0
    assert warnings.filters == filters
    t = stats.collect()
    assert [s["counts"] for s in t["spans"]] == [{"host_syncs": 1},
                                                 {"host_syncs": 3}]
    assert t["counters"] == {"host_syncs": 4}


def test_profiler_records_spans_without_annotating():
    """A torch profiler turns recording on (tracing stays off) and gets
    no range of the program's; tracing(True, annotate=True) adds them."""
    from torch.profiler import ProfilerActivity, profile
    x = torch.ones(64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with stats.span("render"):
            x = x * 2
    names = {e.name for e in prof.events()}
    assert "render" not in names
    assert [s["path"] for s in stats.collect()["spans"]] == ["render"]
    t0 = time.time_ns()
    stats.tracing(True, annotate=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with stats.span("render"):
            x = x * 2
    assert "render" in {e.name for e in prof.events()}
    # spans and the profiler's events share time.time_ns()'s base
    span = stats.collect()["spans"][0]
    mul = [e for e in prof.profiler.kineto_results.events()
           if e.name() == "aten::mul"]
    assert t0 <= span["start_ns"] <= mul[0].start_ns() <= span["end_ns"]


@pytest.fixture(scope="module")
def cbox():
    scene_np, st = port_scene.load_scene(
        CBOX, {"width": "16", "height": "16", "spp": "2", "maxDepth": "3"})
    return bridge.to_torch(scene_np, "cpu"), st


def _render(tracer, scene, kind):
    if kind == "path":
        return {"image": tracer.render(scene, seed=5, spp=2)}
    final, bufs = tracer.render_final(scene, 5, 2)
    return dict(bufs, image=final)


@pytest.mark.parametrize("kind", ["path", "gpt"])
def test_render_span_tree_and_same_bits(cbox, kind):
    scene, st = cbox
    tracer = (PathTracer if kind == "path" else GPTracer)(scene, st)
    tracer.count_rays = True
    off = _render(tracer, scene, kind)
    assert stats.collect() == {"spans": [], "counters": {}}
    stats.tracing(True)
    on = _render(tracer, scene, kind)
    stats.tracing(False)
    for k, v in off.items():
        assert torch.equal(v, on[k]), k
    t = stats.collect()
    paths = {s["path"] for s in t["spans"]}
    expect = {"render", "render/pass", "render/pass/camera",
              "render/pass/traverse:closest", "render/pass/bounce:0",
              "render/pass/bounce:0/traverse:occluded",
              "render/pass/bounce:0/traverse:closest", "render/pass/film"}
    if kind == "gpt":
        expect |= {"render/pass/bounce:0/shift", "render/solve",
                   "render/solve/irls:0", "render/solve/irls:7"}
    assert expect <= paths
    assert {s["frame"] for s in t["spans"]} == {0}
    assert not any("solve/irls:0/" in p for p in paths)
    lanes = sum(s["counts"].get("lanes", 0) for s in t["spans"]
                if s["name"] == "traverse")
    assert lanes == t["counters"]["lanes"] > 0
    rays = (int(on["rays"]) if kind == "gpt" else tracer.last_ray_count)
    assert 0 < rays <= lanes


def test_scene_prep_spans():
    stats.tracing(True)
    scene_np, st = port_scene.load_scene(
        CBOX, {"width": "8", "height": "8", "spp": "1"})
    bridge.to_torch(scene_np, "cpu")
    paths = [s["path"] for s in stats.collect()["spans"]]
    assert paths[:2] == ["load_scene", "load_scene/parse"]
    assert {"load_scene/tessellate", "load_scene/geometry",
            "load_scene/geometry/bvh_build", "load_scene/shade_table",
            "to_torch"} <= set(paths)


@pytest.mark.parametrize("solve", ["l1", "l2"])
def test_solve_same_bits_with_or_without_residuals(solve):
    g = torch.Generator().manual_seed(11)
    P, gx, gy = (torch.rand(12, 17, 3, generator=g) for _ in range(3))
    if solve == "l1":
        a = poisson.solve_l1(P, gx, gy, outer_iters=3, inner_iters=7)
        b, res = poisson.solve_l1(P, gx, gy, outer_iters=3, inner_iters=7,
                                  return_residuals=True)
        assert res.shape == (21,)
    else:
        a = poisson.solve_l2(P, gx, gy, iters=9)
        b, res = poisson.solve_l2(P, gx, gy, iters=9, return_residuals=True)
        assert res.shape == (9,)
    assert torch.equal(a, b)
    assert torch.isfinite(res).all()
