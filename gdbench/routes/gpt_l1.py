"""Route of the G-PT + L1 configurations: the program's fused
GPTracer.render_final (the CLI's route for integrator=gpt: render, the
buffers normalized, the screened-Poisson L1 solve, very_direct added)
and the plain reference.

Checked:
- buffer_mismatch_share: on CHECK_ROWS film rows drawn from the seed,
  the share of (pixel, buffer) pairs of primal, very_direct, dx and dy
  off the reference G-PT's (PIXEL_RTOL of the reference value plus
  PIXEL_ATOL of the buffer's mean magnitude on those rows);
- final_rel_l2: the program's final image against the reference's L1
  solve, in float64, of the program's own primal, dx and dy plus its
  very_direct: the L2 norm of the difference over the reference's, over
  the whole frame;
- final_objective_gap: the L1 objective (reference/poisson.objective)
  of the program's final image less its very_direct, over the
  reference's, less 1.

The solve is judged from the program's buffers, which
buffer_mismatch_share checks on its rows: the reference renders only
those rows.  The solve's iterates are chaotic under rounding (float32
against float64 moves single pixels by several times their value, the
whole frame by under 1%), so it is judged over the whole frame, not by
its worst pixel."""
from __future__ import annotations

import random

import torch

from gdbench import program
from gdbench.reference import gpt as rgpt
from gdbench.reference import poisson as rpoisson

CHECK_ROWS = 64
PIXEL_RTOL = 1e-3
PIXEL_ATOL = 1e-3
BUFFERS = ("primal", "very_direct", "dx", "dy")


def setup(cell, device):
    prog = program.setup(cell, device)
    rc = cell.config["reconstruction"]
    prog.solve = dict(alpha=float(rc["alpha"]), mode="L1",
                      l1_outer=int(rc["outer"]), l1_inner=int(rc["inner"]))
    return prog


def frame(prog, seed):
    final, bufs = prog.tracer.render_final(prog.scene, seed, prog.spp,
                                           **prog.solve)
    return dict(bufs, image=final)


def count_rays(prog, on):
    prog.tracer.count_rays = on


def frame_rays(prog, out):
    return int(out["rays"]) if "rays" in out else 0


def after_window(prog, out):
    """The device busy time of the program's L1 solve on the last frame's
    buffers: one solve run again outside any frame, under the profiler
    (after one unprofiled run)."""
    from gradientdomain_mitsuba_tpu_torch.models import poisson

    from gdbench import harness, stats
    if out["primal"].device.type != "cuda":
        return {}

    def solve():
        poisson.solve_l1(out["primal"], out["dx"], out["dy"],
                         alpha=prog.solve["alpha"],
                         outer_iters=prog.solve["l1_outer"],
                         inner_iters=prog.solve["l1_inner"])
        torch.cuda.synchronize()
    solve()
    with harness.profiler(out["primal"].device) as prof:
        solve()
    iv = [(s, e) for _, s, e in harness.device_events(prof)]
    return {"poisson_ms": stats.union_length(iv) / 1e6}


def check_rows(height, seed):
    rnd = random.Random(f"gdbench:{seed}:rows")
    return sorted(rnd.sample(range(height - 1), min(CHECK_ROWS, height - 1)))


def expected(cell, ds, frame_seed, out, seed):
    rs = ds.rs
    rows = check_rows(rs.height, seed)
    exp = rgpt.render_rows(ds, frame_seed, rs.spp, rows)
    rc = cell.config["reconstruction"]
    dev = ds.device
    inputs = [out[k].to(dev, torch.float64)
              for k in ("primal", "dx", "dy", "very_direct")]
    rec = rpoisson.solve_l1(*inputs[:3], alpha=float(rc["alpha"]),
                            outer=int(rc["outer"]), inner=int(rc["inner"]))
    exp["final"] = rec + inputs[3]
    exp["objective"] = rpoisson.objective(rec, *inputs[:3],
                                          alpha=float(rc["alpha"]))
    exp["inputs"] = inputs
    exp["alpha"] = float(rc["alpha"])
    exp["rows"] = rows
    return exp


def compare(cell, out, exp):
    dev = exp["final"].device
    rows = exp["rows"]
    bad = total = 0
    for k in BUFFERS:
        got = out[k].to(dev).float()[rows]
        ref = exp[k].float()
        tol = PIXEL_RTOL * ref.abs() + PIXEL_ATOL * ref.abs().mean()
        off = ((got - ref).abs() > tol).any(-1)
        bad += int(off.sum())
        total += off.numel()
    ref = exp["final"]
    img = out["image"].to(dev, torch.float64)
    primal, dx, dy, vd = exp["inputs"]
    obj = rpoisson.objective(img - vd, primal, dx, dy, alpha=exp["alpha"])
    return {"buffer_mismatch_share": bad / total,
            "final_rel_l2": float((img - ref).norm() / ref.norm()),
            "final_objective_gap": obj / exp["objective"] - 1.0}


def control(cell, low, frame_seed, out, seed):
    """The reference in the program's place, in the lower precision of
    the scene `low`: its buffers on the checked rows, and its L1 solve of
    the program's buffers."""
    rs, dev = low.rs, low.device
    rows = check_rows(rs.height, seed)
    got = rgpt.render_rows(low, frame_seed, rs.spp, rows)
    cout = {}
    for k in BUFFERS:
        cout[k] = torch.zeros(out[k].shape, device=dev)
        cout[k][rows] = got[k].float()
    rc = cell.config["reconstruction"]
    rec = rpoisson.solve_l1(
        *(out[k].to(dev, low.dtype) for k in ("primal", "dx", "dy")),
        alpha=float(rc["alpha"]), outer=int(rc["outer"]),
        inner=int(rc["inner"]))
    cout["image"] = rec.float() + out["very_direct"].to(dev).float()
    return cout
