"""The program's trace (utils/stats.py) on the card: a planted host sync
is counted once, on the innermost open span; a `solve` span's CUDA
events time its device ops; spans and the profiler's device events
share one clock.  Imports no jax, so the card's machine (which has none)
runs it without the repo's conftest:

    python -m pytest --noconftest tests/test_torch_stats_cuda.py -m cuda -q

Without a card every case skips."""
import os

import pytest
import torch

from gradientdomain_mitsuba_tpu_torch.models import poisson
from gradientdomain_mitsuba_tpu_torch.models.gpt import GPTracer
from gradientdomain_mitsuba_tpu_torch.scene import bridge
from gradientdomain_mitsuba_tpu_torch.scene import scene as port_scene
from gradientdomain_mitsuba_tpu_torch.utils import stats

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CBOX = os.path.join(ROOT, "data/scenes/cbox/cbox.xml")


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (host syncs and device events "
                    "exist only on the card)")
    stats.tracing(False)
    stats.reset()
    yield torch.device("cuda")
    stats.tracing(False)
    stats.reset()


@pytest.mark.cuda
def test_a_planted_sync_is_counted_once(cuda_device):
    x = torch.arange(1000, device=cuda_device, dtype=torch.float32)
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    stats.tracing(True)
    with stats.span("render"):
        y = (x * 2).sum()               # no sync
        with stats.span("pass"):
            assert y.item() == 999000.0  # one sync
        z = x + 1                        # no sync
    stats.tracing(False)
    torch.cuda.synchronize()
    assert torch.cuda.get_sync_debug_mode() == mode
    t = stats.collect()
    assert [s["counts"] for s in t["spans"]] == [{}, {"host_syncs": 1}]
    assert t["counters"] == {"host_syncs": 1}
    assert float(z[0]) == 1.0           # outside spans: not counted
    assert stats.collect()["counters"] == {}


@pytest.mark.cuda
def test_solve_span_on_the_device_clock(cuda_device):
    """The solve's device ops, profiled, start after the span's host
    start and end before its host end plus the device's lag; its CUDA
    event pair spans the union of those ops."""
    from torch.profiler import ProfilerActivity, profile
    g = torch.Generator(device=cuda_device).manual_seed(3)
    P, gx, gy = (torch.rand(270, 480, 3, device=cuda_device, generator=g)
                 for _ in range(3))
    poisson.solve_l1(P, gx, gy, outer_iters=2, inner_iters=5)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        poisson.solve_l1(P, gx, gy, outer_iters=2, inner_iters=5)
        torch.cuda.synchronize()
    t = stats.collect()
    solve = [s for s in t["spans"] if s["name"] == "solve"]
    assert len(solve) == 1 and solve[0]["device_ms"] > 0
    assert [s["path"] for s in t["spans"]] == ["solve", "solve/irls:0",
                                               "solve/irls:1"]
    ops = [(e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == torch.autograd.DeviceType.CUDA]
    assert ops
    assert min(s for s, _ in ops) >= solve[0]["start_ns"]
    first, last = min(s for s, _ in ops), max(e for _, e in ops)
    assert solve[0]["device_ms"] >= 0.99 * (last - first) / 1e6


@pytest.mark.cuda
def test_render_final_span_tree_on_the_card(cuda_device):
    scene_np, st = port_scene.load_scene(
        CBOX, {"width": "64", "height": "64", "spp": "4", "maxDepth": "3"})
    scene = bridge.to_torch(scene_np, cuda_device)
    tracer = GPTracer(scene, st)
    off, _ = tracer.render_final(scene, 7, 4)
    stats.tracing(True)
    on, _ = tracer.render_final(scene, 7, 4)
    stats.tracing(False)
    torch.cuda.synchronize()
    assert torch.equal(off, on)
    t = stats.collect()
    rows = {r["path"]: r for r in stats.summarize(t)}
    assert rows["render"]["device_ms"] >= rows["render/solve"]["device_ms"]
    assert rows["render/solve"]["device_ms"] > 0
    assert rows["render/pass/bounce:0/shift"]["calls"] >= 1
    assert t["counters"]["lanes"] > 0
