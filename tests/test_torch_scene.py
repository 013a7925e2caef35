"""Port scene front end: the numpy loader of gradientdomain_mitsuba_tpu_torch
builds the same tables as the reference's, bit for bit; bridge.to_torch
carries them to a device unchanged; the port never imports jax."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gradientdomain_mitsuba_tpu.scene import scene as ref_scene
from gradientdomain_mitsuba_tpu_torch import config
from gradientdomain_mitsuba_tpu_torch.scene import bridge
from gradientdomain_mitsuba_tpu_torch.scene import scene as port_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = {
    "cbox": os.path.join(ROOT, "data/scenes/cbox/cbox.xml"),
    "cbox-mats": os.path.join(ROOT, "data/scenes/cbox-mats/cbox-mats.xml"),
    # analytic spheres (sph_center / sph_radius / sph_bsdf / sph_shape),
    # a dielectric and an Ag conductor row from the spectral tables
    "caustics": os.path.join(ROOT, "data/scenes/caustics/caustics.xml"),
    # envmap texel CDFs, a checkerboard texture row, a thin lens and the
    # rough / plastic rows; door: thindielectric and ldsampler
    "envmap": os.path.join(ROOT, "data/scenes/envmap/envmap.xml"),
    "door": os.path.join(ROOT, "data/scenes/door/door.xml"),
}
VARS = {"width": "32", "height": "24", "spp": "2", "maxDepth": "6",
        "integrator": "gpt"}


def _leaves(tree, prefix=""):
    """(path, leaf) pairs of a NamedTuple tree."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name, v in zip(tree._fields, tree):
            yield from _leaves(v, f"{prefix}.{name}" if prefix else name)
    else:
        yield prefix, tree


def _assert_same_tree(a, b):
    la, lb = list(_leaves(a)), list(_leaves(b))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        if x is None or y is None:
            assert x is None and y is None, path
            continue
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype, (path, x.dtype, y.dtype)
        assert x.shape == y.shape, (path, x.shape, y.shape)
        np.testing.assert_array_equal(x, y, err_msg=path)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_load_scene_matches_reference(name):
    """Every array of SceneData (geom.tris, linC, tri_shade, emitters,
    camera, materials, ray_eps, ...) and every RenderSettings field
    except the wall-clock prep_times is identical."""
    rs, rst = ref_scene.load_scene(SCENES[name], VARS)
    ps, pst = port_scene.load_scene(SCENES[name], VARS)
    _assert_same_tree(rs, ps)
    for f in dataclasses.fields(rst):
        if f.name != "prep_times":
            assert getattr(rst, f.name) == getattr(pst, f.name), f.name


@pytest.mark.parametrize("name", sorted(SCENES))
def test_to_torch_round_trips(name):
    scene, _ = port_scene.load_scene(SCENES[name], VARS)
    ts = bridge.to_torch(scene, "cpu")
    for (path, x), (_, t) in zip(_leaves(scene), _leaves(ts)):
        if x is None:
            assert t is None, path
            continue
        if not isinstance(x, (np.ndarray, np.generic)):
            assert t == x, path
            continue
        assert isinstance(t, torch.Tensor), path
        back = t.numpy()
        assert back.dtype == np.asarray(x).dtype, (path, back.dtype)
        np.testing.assert_array_equal(back, np.asarray(x), err_msg=path)


def test_reference_scene_bridges_too():
    """to_torch takes the reference loader's SceneData as well."""
    rs, _ = ref_scene.load_scene(SCENES["cbox"], VARS)
    ts = bridge.to_torch(rs, torch.device("cpu"))
    assert ts.geom.linC.dtype == torch.float32
    assert ts.geom.indices.dtype == torch.int32
    np.testing.assert_array_equal(ts.geom.tri_shade.numpy(),
                                  rs.geom.tri_shade)


def test_port_imports_no_jax():
    """A fresh interpreter imports every module of the port, loads cbox
    and moves it to tensors without jax ever being imported.  Runs as a
    subprocess in isolated mode: this process has jax loaded already."""
    code = f"""
import importlib, pkgutil, sys
sys.path.insert(0, {ROOT!r})
import gradientdomain_mitsuba_tpu_torch as pkg
for mod in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(mod.name)
from gradientdomain_mitsuba_tpu_torch.scene import scene, bridge
from gradientdomain_mitsuba_tpu_torch.models.gpt import GPTracer
s, st = scene.load_scene({SCENES['cbox']!r}, {{"width": "8", "height": "8"}})
GPTracer(bridge.to_torch(s, "cpu"), st)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib",
                                            "gradientdomain_mitsuba_tpu.")))
print("LEAKED", bad)
sys.exit(1 if bad else 0)
"""
    res = subprocess.run([sys.executable, "-I", "-c", code],
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def test_get_device_cuda_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        config.get_device("cuda")
    assert config.get_device("cpu") == torch.device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
