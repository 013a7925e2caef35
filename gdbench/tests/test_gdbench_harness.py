"""The harness's control flow on the CPU at a small size (the grove,
16 x 12 pixels): a sound run is correct; the control (the reference in
the program's place, in bfloat16) and each fault a cell can have, planted
under the timed path, make `correct` false."""
import time

import pytest
import torch
from conftest import grove_cell

from gdbench import harness, registry

CELLS = ("forest-path.2560x1440-1spp", "forest-gpt-l1.1920x1080-4spp")


def _run(cell, trace=0, seed=2**31 + 77):
    return harness.run_cell(cell, seed, 0.05, trace, "cpu",
                            time.perf_counter())


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", (0, 1))
def test_a_sound_run_is_correct(name, trace):
    cell = grove_cell(name)
    res, checks = _run(cell, trace)
    assert res["correct"], checks
    assert res["attempted"] >= 1 and res["failed"] == 0
    want = cell.per_layer if trace else cell.end_to_end
    got = set(res["metrics"])
    if trace:
        assert "scene_load_s" in got
        assert "mrays_per_s" in got
        assert res["device"]["window_s"] > 0
    else:
        assert got == {m["name"] for m in want}
    assert {k for k, _, _ in checks} == set(cell.limits)


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    """The reference computed in bfloat16, in the program's place."""
    cell = grove_cell(name)
    route = registry.module("routes", cell.config["route"])
    prog = route.setup(cell, "cpu")
    ds = harness.reference_scene(cell, prog.variables, "cpu")
    low = harness.reference_scene(cell, prog.variables, "cpu",
                                  torch.bfloat16)
    for seed in (3, 4, 5):
        fs = harness.frame_seed(seed, 0)
        rec = harness.Recorder(prog.tracer, torch.Generator().manual_seed(
            seed), False, prog.scene.geom.cbounds, 64)
        with rec:
            out = route.frame(prog, fs)
        cout = route.control(cell, low, fs, out, seed)
        for s in rec.samples:
            a = [s[k] for k in ("o", "d", "mint", "maxt")]
            if s["kind"] == "closest":
                s["valid"], s["t"] = low.accel.closest(*a)[:2]
            else:
                s["occ"] = low.accel.occluded(*a)
        nums = harness.check(cell, route, ds, fs, cout, rec.samples, seed)
        assert any(v > cell.limits[k] for k, v in nums.items()), nums


def _faulty(monkeypatch, fault):
    """Plant `fault` under the routes the harness loads."""
    load = registry.module

    def module(kind, name, root=registry.ROOT):
        mod = load(kind, name, root)
        if kind == "routes":
            fault(mod)
        return mod
    monkeypatch.setattr(registry, "module", module)


def _stale(mod):
    """A step that returns its state unchanged: every frame after the
    first returns the first frame's outputs."""
    frame = mod.frame
    first = {}

    def stale(prog, seed):
        if "out" not in first:
            first["out"] = frame(prog, seed)
        return first["out"]
    mod.frame = stale


def _half_batch(mod):
    """Half of the samples left out, the mean taken over the rest."""
    frame = mod.frame

    def half(prog, seed):
        spp = prog.spp
        prog.spp = spp // 2
        try:
            return frame(prog, seed)
        finally:
            prog.spp = spp
    mod.frame = half


def _altered_answer(mod):
    """An answer altered where it is produced: the closest-hit kernel's
    answers for the rays of one 8 x 8 pixel tile come back 1% further."""
    setup = mod.setup

    def altered(cell, device):
        prog = setup(cell, device)
        closest = prog.tracer.closest
        W = cell.traffic["width"]

        def c(o, d, mint, maxt, geom):
            hit = closest(o, d, mint, maxt, geom)
            lane = torch.arange(o.shape[0]) % (W * cell.traffic["height"])
            tile = (lane % W < 8) & (lane // W < 8) & hit.valid
            return type(hit)(t=torch.where(tile, hit.t * 1.01, hit.t),
                             u=hit.u, v=hit.v, prim=hit.prim,
                             valid=hit.valid)
        prog.tracer.closest = c
        return prog
    mod.setup = altered


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", (_stale, _half_batch, _altered_answer))
def test_a_fault_under_the_timed_path_is_not_correct(monkeypatch, name,
                                                     fault):
    _faulty(monkeypatch, fault)
    res, checks = _run(grove_cell(name), seed=5)
    assert not res["correct"], checks
