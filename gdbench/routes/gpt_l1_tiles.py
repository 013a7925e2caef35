"""Route of the row-sharded G-PT + L1 configurations: one final frame
over the cards of a node through the program's frame loop
(parallel/multihost.FrameLoop: tiles.render_final_sharded, each rank's
rows rendered, its neighbours' halos added, the buffers gathered on
rank 0, which runs the L1 solve over the whole frame), the route the
program's CLI takes under a distributed launch.

setup starts the other ranks (gdbench/followers.py: cell.chips - 1
processes on cuda:1, cuda:2, ... or, on the CPU, gloo processes), joins
rank 0 on the harness's device and returns rank 0's scene, tracer and
settings, so the harness's Recorder, its roofline count and its memory
peak see rank 0 alone.

Checked, as the one-device G-PT + L1 route (routes/gpt_l1.py) checks,
on the frame gathered on rank 0:
- buffer_mismatch_share on its rows drawn from the seed, final_rel_l2
  and final_objective_gap over the whole frame;
- seam_mismatch_share: the same share as buffer_mismatch_share on the
  film rows on both sides of every seam between two ranks' rows (the
  rows whose dy pairs and filter splats cross the seam, which a lost
  halo add would leave short);
- hit_mismatch_share on rank 0's traversal calls: its check samples the
  rays of rank 0's rows only.  In forest10m's 4K frame those rows all
  look above the horizon, so there it reads 0 whatever the traversal
  does, and the limits file marks it not applicable."""
from __future__ import annotations

import functools

import torch

from gdbench import followers, program, registry
from gdbench.reference import gpt as rgpt

@functools.lru_cache(maxsize=None)
def _base(root):
    """The one-device G-PT + L1 route, whose checks this route makes."""
    return registry.module("routes", "gpt_l1", root)


def setup(cell, device):
    from gradientdomain_mitsuba_tpu_torch.parallel import multihost, tiles
    if not hasattr(tiles, "render_final_sharded"):
        raise RuntimeError("the program has no sharded G-PT frame")
    kind = torch.device(device).type
    ranks = followers.start(cell, kind)
    multihost.init(ranks.addr, cell.chips, 0, device=kind)
    prog = program.setup(cell, device)
    ranks.loop = prog.loop = multihost.FrameLoop(prog.tracer, prog.scene)
    rc = cell.config["reconstruction"]
    prog.solve = dict(alpha=float(rc["alpha"]), mode="L1",
                      l1_outer=int(rc["outer"]), l1_inner=int(rc["inner"]))
    return prog


def frame(prog, seed):
    final, bufs = prog.loop.render_final(seed, prog.spp, **prog.solve)
    return dict(bufs, image=final)


def count_rays(prog, on):
    """Ray counting on every rank, and with it the other ranks' trace
    (rank 0's is the harness's profiler's)."""
    prog.loop.count_rays(on, tracing=on)


def frame_rays(prog, out):
    return int(out["rays"]) if "rays" in out else 0


def after_window(prog, out):
    return {}


def seam_rows(cell):
    """The film rows on both sides of every seam between ranks' rows."""
    H, n = int(cell.traffic["height"]), cell.chips
    R = -(-H // n)
    return sorted({r for k in range(1, n) if k * R < H
                   for r in (k * R - 1, k * R)})


def _mismatch(base, out, exp, rows, dev):
    """Share of (pixel, buffer) pairs of `rows` off the reference's, as
    the one-device route `base` counts buffer_mismatch_share."""
    bad = total = 0
    for k in base.BUFFERS:
        got = out[k].to(dev).float()[rows]
        ref = exp[k].float()
        tol = (base.PIXEL_RTOL * ref.abs() +
               base.PIXEL_ATOL * ref.abs().mean())
        off = ((got - ref).abs() > tol).any(-1)
        bad += int(off.sum())
        total += off.numel()
    return bad / total


def expected(cell, ds, frame_seed, out, seed):
    exp = _base(cell.root).expected(cell, ds, frame_seed, out, seed)
    exp["seams"] = seam_rows(cell)
    exp["seam"] = rgpt.render_rows(ds, frame_seed, ds.rs.spp, exp["seams"])
    return exp


def compare(cell, out, exp):
    base = _base(cell.root)
    nums = base.compare(cell, out, exp)
    nums["seam_mismatch_share"] = _mismatch(
        base, out, exp["seam"], exp["seams"], exp["final"].device)
    return nums


def control(cell, low, frame_seed, out, seed):
    """The reference in the program's place, in the lower precision of
    the scene `low`: the one-device route's control, and its buffers on
    the seam rows."""
    cout = _base(cell.root).control(cell, low, frame_seed, out, seed)
    rows = seam_rows(cell)
    got = rgpt.render_rows(low, frame_seed, low.rs.spp, rows)
    for k in got:
        cout[k][rows] = got[k].float()
    return cout
