"""Builds the program under test from a cell: the scene loaded through
the program's loader (and its geometry disk cache) and put on the
device, and the tracer its factory makes for the configuration."""
from __future__ import annotations

import time
from types import SimpleNamespace

from . import registry


def variables(cell):
    """The scene's -D variables: the configuration's, then the frame
    size and samples of the traffic mix."""
    v = {k: str(x) for k, x in cell.config.get("variables", {}).items()}
    t = cell.traffic
    v.update(width=str(t["width"]), height=str(t["height"]),
             spp=str(t["spp"]))
    return v


def setup(cell, device):
    import torch
    from gradientdomain_mitsuba_tpu_torch.models.factory import \
        make_integrator
    from gradientdomain_mitsuba_tpu_torch.scene import bridge
    from gradientdomain_mitsuba_tpu_torch.scene import scene as sc
    var = variables(cell)
    t0 = time.perf_counter()
    scene_np, settings = sc.load_scene(
        registry.scene_path(cell.config, cell.root), var)
    scene = bridge.to_torch(scene_np, torch.device(device))
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    load_s = time.perf_counter() - t0
    del scene_np
    t = cell.traffic
    return SimpleNamespace(
        scene=scene, settings=settings,
        tracer=make_integrator(scene, settings), variables=var,
        spp=int(t["spp"]),
        samples_per_frame=int(t["width"]) * int(t["height"]) * int(t["spp"]),
        spans={"scene_load_s": load_s})
