"""Finds a cell's pieces by the names BENCHMARK.json gives them.

- a configuration: the JSON file its `configs` entry names (scene,
  integrator variables, the route that drives the program);
- a traffic mix: traffic/<traffic>.json (frame size, samples a frame);
- the limits of the cell's correctness numbers: limits/<cell>.json;
- a route: routes/<route>.py, the calls into the program and the
  reference check for one kind of configuration;
- a metric: metrics/<name>.py, whose read(record) returns the metric or
  None.

A cell, a configuration, a mix or a metric is added by adding its files
and its BENCHMARK.json entries; no file here names one.
"""
from __future__ import annotations

import importlib.util
import json
import os
import sys
from dataclasses import dataclass

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list      # metric entries this cell reports (--trace 0)
    per_layer: list       # metric entries this cell reports (--trace 1)
    limits: dict          # correctness number -> limit
    root: str = ROOT      # the checkout it belongs to


def _json(path):
    with open(path) as f:
        return json.load(f)


def benchmark(root=ROOT):
    return _json(os.path.join(root, "BENCHMARK.json"))


def _applies(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name, root=ROOT):
    """The cell `name` of the checkout at root."""
    bench = benchmark(root)
    here = os.path.join(root, "gdbench")
    wl = [w for w in bench["workloads"] if w["name"] == name]
    if not wl:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = wl[0]
    cfg = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    moved = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"]
           if _applies(m, name) and m["moves"] in moved]
    return Cell(
        name=name, config=_json(os.path.join(root, cfg["file"])),
        traffic=_json(os.path.join(here, "traffic", w["traffic"] + ".json")),
        chips=int(w["chips"]), end_to_end=e2e, per_layer=per,
        limits=_json(os.path.join(here, "limits", name + ".json")),
        root=root)


def module(kind, name, root=ROOT):
    """The module of file gdbench/<kind>/<name>.py of the checkout."""
    path = os.path.join(root, "gdbench", kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"gdbench.{kind}.{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def scene_path(config, root=ROOT):
    """The scene file a configuration names (relative to the root)."""
    return os.path.join(root, config["scene"])
