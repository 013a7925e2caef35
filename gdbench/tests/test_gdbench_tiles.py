"""The four-card cell (forest10m-gpt-l1-tiles) on the CPU: its files read
through the registry, and its route over 2 gloo ranks on the grove at
64 x 48, 4 spp: a sound run is correct, and each of three faults of the
sharded frame, planted in rank 0, makes `correct` false by the number
named beside it."""
import dataclasses
import time

import pytest
import torch
from conftest import grove_cell

from gdbench import harness, registry
from gradientdomain_mitsuba_tpu_torch.models import poisson
from gradientdomain_mitsuba_tpu_torch.parallel import tiles
from gradientdomain_mitsuba_tpu_torch.utils import stats

CELL = "forest10m-gpt-l1-tiles.3840x2160-4spp"


def _cell():
    """The cell on the grove at 64 x 48, 4 spp, over 2 ranks."""
    c = grove_cell(CELL)
    return dataclasses.replace(
        c, chips=2, traffic=dict(c.traffic, width=64, height=48, spp=4))


def _run(trace=0, seed=2**31 + 91):
    # a run starts from an empty program trace, as in a fresh process:
    # another test in this worker may have left spans in it
    stats.reset()
    return harness.run_cell(_cell(), seed, 0.05, trace, "cpu",
                            time.perf_counter())


def test_the_cell_resolves():
    c = registry.cell(CELL)
    assert c.chips == 4 and c.config["route"] == "gpt_l1_tiles"
    assert (c.traffic["width"], c.traffic["height"], c.traffic["spp"]) == \
        (3840, 2160, 4)
    assert c.config["reduced"] == [] and c.config["triangles"] == \
        c.config["full_scale"]["triangles"] == 10188804
    assert {m["name"] for m in c.end_to_end} == {"msamples_per_s",
                                                 "setup_s"}
    assert [m["name"] for m in c.per_layer] == [
        "collective_ms_per_frame", "collectives_per_frame",
        "shard_skew_share"]
    assert set(c.limits) == {"buffer_mismatch_share", "seam_mismatch_share",
                             "final_rel_l2", "final_objective_gap",
                             "hit_mismatch_share", "replay_diff",
                             "not_applicable"}
    assert set(c.limits["not_applicable"]) == {"hit_mismatch_share"}
    route = registry.module("routes", "gpt_l1_tiles")
    assert route.seam_rows(c) == [539, 540, 1079, 1080, 1619, 1620]


@pytest.mark.parametrize("trace", (0, 1))
def test_a_sound_run_is_correct(trace):
    res, checks = _run(trace)
    assert res["correct"], checks
    assert res["attempted"] >= 1 and res["failed"] == 0
    if trace:
        # the CPU records no device events: the counter alone reads
        assert res["metrics"]["collectives_per_frame"]["value"] > 0
    else:
        assert set(res["metrics"]) == {"msamples_per_s", "setup_s"}


def _drop_seam(monkeypatch):
    """Rank 0 drops what rank 1 sends up at their seam."""
    def halo(fb, B, mesh):
        inner = fb[B:fb.shape[0] - B].clone()
        tiles._pass_along(mesh, fb[:B], -1)
        inner[:B] += tiles._pass_along(mesh, fb[fb.shape[0] - B:], 1)
        return inner
    monkeypatch.setattr(tiles, "_halo_exchange_add", halo)


def _block_solve(monkeypatch):
    """Rank 0 solves each rank's block of the gathered frame alone, so
    the solve loses its coupling across the seam."""
    solve = poisson.reconstruct

    def blocks(bufs, *a, **k):
        R = -(-bufs["primal"].shape[0] // 2)
        return torch.cat([solve({n: v[i:i + R] for n, v in bufs.items()},
                                *a, **k) for i in (0, R)])
    monkeypatch.setattr(poisson, "reconstruct", blocks)


def _row_off(monkeypatch):
    """The gather places rank 1's block one row down."""
    gather = tiles._gather_root

    def off(v, H, mesh):
        full = gather(v, H, mesh)
        R = v.shape[1]
        out = full.clone()
        out[:, R + 1:] = full[:, R:-1]
        return out
    monkeypatch.setattr(tiles, "_gather_root", off)


@pytest.mark.parametrize("fault,number", (
    (_drop_seam, "seam_mismatch_share"),
    (_block_solve, "final_rel_l2"),
    (_row_off, "buffer_mismatch_share")))
def test_a_fault_of_the_sharded_frame_is_not_correct(monkeypatch, fault,
                                                      number):
    fault(monkeypatch)
    res, checks = _run(seed=7)
    got = {k: (v, lim) for k, v, lim in checks}
    assert not res["correct"], checks
    assert got[number][0] > got[number][1], checks
