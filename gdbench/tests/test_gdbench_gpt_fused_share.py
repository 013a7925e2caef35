"""The gpt_fused_share reader (metrics/gpt_fused_share.py) on synthetic
program traces, and on a traced CPU run of the G-PT cell, whose all-
diffuse, area-lit scene takes the fused G-PT route."""
import time
from types import SimpleNamespace

import pytest
from conftest import grove_cell

from gdbench import harness, registry
from gradientdomain_mitsuba_tpu_torch.utils import stats as pstats


def _trace(**counts):
    spans = [dict(id=1, parent=None, name="render", attrs={}, path="render",
                  frame=0, start_ns=0, end_ns=100, counts={},
                  device_ms=10.0),
             dict(id=2, parent=1, name="bounce", attrs={},
                  path="render/bounce", frame=0, start_ns=10, end_ns=20,
                  counts=counts, device_ms=None)]
    return dict(spans=spans, counters=dict(counts), frames=1)


def _read(tr):
    rec = SimpleNamespace(frames=1, program_trace=tr,
                          trace=dict(busy_s=0.0, rays=0, window_s=1.0))
    return registry.module("metrics", "gpt_fused_share").read(rec)


@pytest.mark.parametrize("counts,want", [
    (dict(gpt_lanes_fused=4000), 100.0),
    (dict(gpt_lanes_eager=4000), 0.0),
    (dict(gpt_lanes_fused=3000, gpt_lanes_eager=1000), 75.0),
    (dict(lanes=4000), None)])
def test_reads_the_lane_counters(counts, want):
    """100 from a fused G-PT trace, 0 from an eager one, None from a
    trace that counts neither (a path frame, or a program without the
    counters)."""
    assert _read(_trace(**counts)) == want


def test_reads_none_without_a_trace():
    assert _read(None) is None


def test_a_traced_cpu_run_reads_100():
    """The G-PT cell on the grove, traced: every bounce fused."""
    pstats.reset()
    cell = grove_cell("forest-gpt-l1.1920x1080-4spp")
    res, checks = harness.run_cell(cell, 2**31 + 93, 0.05, 1, "cpu",
                                   time.perf_counter())
    assert res["correct"], checks
    assert res["metrics"]["gpt_fused_share"]["value"] == 100.0
