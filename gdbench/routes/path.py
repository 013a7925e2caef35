"""Route of the path-tracing configurations: the program's PathTracer
render (the CLI's route for integrator=path) and the plain reference's
full frame.

Checked: every pixel of the kept frame against the reference path
tracer's value of that pixel, with the same samples (image_mismatch_share:
the share of pixels off by more than PIXEL_RTOL of the reference value
plus PIXEL_ATOL of the frame's mean)."""
from __future__ import annotations

from gdbench import program
from gdbench.reference import path as rpath

PIXEL_RTOL = 1e-3
PIXEL_ATOL = 1e-3


def setup(cell, device):
    return program.setup(cell, device)


def frame(prog, seed):
    return {"image": prog.tracer.render(prog.scene, seed=seed, spp=prog.spp)}


def count_rays(prog, on):
    prog.tracer.count_rays = on


def frame_rays(prog, out):
    return int(prog.tracer.last_ray_count or 0)


def after_window(prog, out):
    return {}


def mismatch_share(got, ref):
    """Share of pixels [..., 3] where any channel is off."""
    tol = PIXEL_RTOL * ref.abs() + PIXEL_ATOL * ref.abs().mean()
    return float(((got.float() - ref).abs() > tol).any(-1).float().mean())


def expected(cell, ds, frame_seed, out, seed):
    rs = ds.rs
    return {"image": rpath.render(ds, frame_seed, rs.spp).reshape(
        rs.height, rs.width, 3)}


def compare(cell, out, exp):
    return {"image_mismatch_share": mismatch_share(out["image"].to(
        exp["image"].device), exp["image"])}


def control(cell, low, frame_seed, out, seed):
    """The reference in the program's place, in the lower precision of
    the scene `low`."""
    rs = low.rs
    return {"image": rpath.render(low, frame_seed, rs.spp).reshape(
        rs.height, rs.width, 3)}
