"""The harness finds configurations, traffic, limits, routes and metrics
by the names BENCHMARK.json gives them, and a new cell, configuration,
mix and metric come in as new files and entries alone."""
import json
import os
import shutil
import time

from conftest import GROVE

from gdbench import harness, registry


def _bench():
    return registry.benchmark()


def test_every_cell_resolves():
    b = _bench()
    for w in b["workloads"]:
        c = registry.cell(w["name"])
        assert c.traffic["width"] > 0 and c.traffic["spp"] > 0
        assert os.path.exists(registry.scene_path(c.config))
        route = registry.module("routes", c.config["route"])
        for fn in ("setup", "frame", "expected", "compare", "control"):
            assert callable(getattr(route, fn))
        e2e = {m["name"] for m in c.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert c.per_layer
        for m in c.end_to_end + c.per_layer:
            assert callable(registry.module("metrics", m["name"]).read)
        assert set(c.limits) >= {"hit_mismatch_share", "replay_diff"}


def test_metric_entries_name_their_moves_and_layers():
    b = _bench()
    e2e = {m["name"] for m in b["end_to_end"]}
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e and m["layer"]
        assert set(m["workloads"]) <= cells


def test_a_new_cell_config_mix_and_metric_need_only_new_files(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(registry.HERE, root / "gdbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = _bench()
    g = root / "gdbench"
    (g / "configs" / "grove-path.json").write_text(json.dumps(
        {"scene": GROVE, "route": "path",
         "variables": {"integrator": "path", "maxDepth": 3}}))
    (g / "traffic" / "8x6-1spp.json").write_text(json.dumps(
        {"width": 8, "height": 6, "spp": 1}))
    (g / "limits" / "grove-path.8x6-1spp.json").write_text(json.dumps(
        {"image_mismatch_share": 0.0, "hit_mismatch_share": 0.0,
         "replay_diff": 0.0}))
    (g / "metrics" / "frames_done.py").write_text(
        "def read(rec):\n    return float(rec.frames)\n")
    b["configs"].append({"name": "grove-path", "source": "test",
                         "file": "gdbench/configs/grove-path.json",
                         "reduced": [], "why": "test"})
    b["workloads"].append({"name": "grove-path.8x6-1spp",
                           "config": "grove-path", "traffic": "8x6-1spp",
                           "chips": 1, "why": "test"})
    b["per_layer"].append({"name": "frames_done", "unit": "frames",
                           "better": "higher", "source": "host_clock",
                           "layer": "Entry", "moves": "setup_s",
                           "workloads": ["grove-path.8x6-1spp"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    c = registry.cell("grove-path.8x6-1spp", root=str(root))
    assert c.traffic["width"] == 8 and c.config["route"] == "path"
    assert [m["name"] for m in c.per_layer][-1] == "frames_done"
    res, checks = harness.run_cell(c, 7, 0.05, 1, "cpu", time.perf_counter())
    assert res["metrics"]["frames_done"]["value"] >= 1
    assert res["correct"], checks
    # every file the benchmark had is as it was
    for dirpath, _, files in os.walk(registry.HERE):
        if "__pycache__" in dirpath or os.sep + "tests" in dirpath:
            continue
        for f in files:
            src = os.path.join(dirpath, f)
            rel = os.path.relpath(src, registry.HERE)
            with open(src, "rb") as a, open(g / rel, "rb") as b_:
                assert a.read() == b_.read(), rel
