"""The port's path tracer on the CPU against the reference.

1. PathTracer on a small generated forest (tools/gen_forest.generate with
   a 2x2 grid: 25,476 triangles, 558 clusters of 128, above the
   2048-triangle sweep limit, so the port walks the pair traversal's plain
   version).  On the CPU the reference walks large scenes with its jnp
   cluster traversal; here its intersectors are pinned to the linear-MT
   matmul sweeps over a full coefficient table built in the test
   (torch_parity.pinned_full_matmul: build_linear_mt over the
   cluster-major soup's non-degenerate slots): the same math the v7
   kernel computes, with prims in the same slot space (k*W + lane).
   Measured ray counts are equal; the image agrees at rtol 1e-3 / atol
   1e-4 on >= 99% of pixels (the allowance covers an ulp-level t or u
   difference flipping a Russian-roulette decision).
2. render_accumulate resume is bit-exact.
3. G-PT's primal + very_direct equals the path tracer's image (the
   identity tests/test_gpt.py holds for the reference).
"""
import importlib.util
import os
import re

import jax
import numpy as np
import pytest
import torch

from gradientdomain_mitsuba_tpu.models import path as ref_path
from gradientdomain_mitsuba_tpu.ops import common as ref_common
from gradientdomain_mitsuba_tpu.scene import scene as ref_scene
from gradientdomain_mitsuba_tpu_torch.models import path as path_mod
from gradientdomain_mitsuba_tpu_torch.models.gpt import GPTracer
from gradientdomain_mitsuba_tpu_torch.models.path import PathTracer
from gradientdomain_mitsuba_tpu_torch.parallel import checkpoint as cp
from gradientdomain_mitsuba_tpu_torch.scene import bridge
from gradientdomain_mitsuba_tpu_torch.scene import scene as port_scene
from torch_parity import load_tool, pinned_full_matmul, pinned_matmul

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "gen_forest", os.path.join(ROOT, "tools", "gen_forest.py"))
gen_forest = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(gen_forest)
CBOX = os.path.join(ROOT, "data/scenes/cbox/cbox.xml")
FOREST_VARS = {"width": "16", "height": "16", "spp": "2", "maxDepth": "5"}
SEED, SPP = 11, 2


def write_small_forest(path):
    """A 2x2-tree forest with the camera moved in to frame it."""
    xml = re.sub(r'<lookat origin="[^"]*" target="[^"]*"',
                 '<lookat origin="250, 300, -500" target="250, 120, 250"',
                 gen_forest.generate(grid=2))
    path.write_text(xml)
    return str(path)


@pytest.fixture(scope="module")
def small_forest(tmp_path_factory):
    return write_small_forest(tmp_path_factory.mktemp("forest") /
                              "forest.xml")


@pytest.fixture(scope="module")
def forest_reference(small_forest):
    scene, st = ref_scene.load_scene(small_forest, FOREST_VARS)
    mp = pytest.MonkeyPatch()
    mp.setattr(ref_common, "choose_intersector", pinned_full_matmul(scene))
    try:
        tracer = ref_path.PathTracer(scene, st)
        tracer.count_rays = True
        img = tracer.render(jax.device_put(scene), seed=SEED, spp=SPP,
                            chunk=SPP)
    finally:
        mp.undo()
    return np.asarray(img), tracer.last_ray_count


@pytest.fixture(scope="module")
def forest_port(small_forest):
    scene, st = port_scene.load_scene(small_forest, FOREST_VARS)
    ts = bridge.to_torch(scene, "cpu")
    tracer = PathTracer(ts, st)
    tracer.count_rays = True
    img = tracer.render(ts, seed=SEED, spp=SPP, chunk=SPP)
    return img.numpy(), tracer


def test_forest_uses_pair_traversal(forest_port):
    _, tracer = forest_port
    assert tracer.large_scene
    assert [k.name for k in tracer.kernels] == ["pair_closest",
                                                "pair_occluded"]
    # CPU tensors run the plain version: no kernel launch is counted
    assert [k.launches for k in tracer.kernels] == [0, 0]


def test_forest_ray_counts_equal(forest_reference, forest_port):
    assert forest_port[1].last_ray_count == forest_reference[1] > 0


def test_forest_image_matches_reference(forest_reference, forest_port):
    got, ref = forest_port[0], forest_reference[0]
    assert got.shape == ref.shape == (16, 16, 3)
    assert np.isfinite(got).all()
    assert (got > 0).any(-1).mean() > 0.3     # lit, not black
    frac = np.isclose(got, ref, rtol=1e-3, atol=1e-4).all(-1).mean()
    assert frac >= 0.99, frac
    assert abs(got.mean() - ref.mean()) <= 1e-4 * abs(ref.mean()) + 1e-6


@pytest.fixture(scope="module")
def cbox16():
    scene, st = port_scene.load_scene(
        CBOX, {"width": "16", "height": "16", "spp": "8", "maxDepth": "3"})
    return bridge.to_torch(scene, "cpu"), st


def test_checkpoint_resume_exact(cbox16, tmp_path):
    """A resumed render is bit-identical to an uninterrupted one."""
    scene, st = cbox16
    pt = PathTracer(scene, st)
    pt.count_rays = True
    straight = pt.render(scene, seed=7, spp=8, chunk=4)
    rays = pt.last_ray_count
    ck = str(tmp_path / "render.ckpt")
    state, _ = cp.render_accumulate(pt, scene, 7, 4, chunk=4,
                                    checkpoint_path=ck)
    assert all(v.device == scene.geom.linC.device for v in state.values())
    resumed = pt.render(scene, seed=7, spp=8, chunk=4, checkpoint_path=ck,
                        resume=True)
    assert torch.equal(resumed, straight)
    assert pt.last_ray_count == rays > 0


def test_checkpoint_seed_mismatch(cbox16, tmp_path):
    scene, st = cbox16
    pt = PathTracer(scene, st)
    ck = str(tmp_path / "c.ckpt")
    pt.render(scene, seed=1, spp=2, chunk=2, checkpoint_path=ck)
    with pytest.raises(ValueError):
        pt.render(scene, seed=2, spp=4, chunk=2, checkpoint_path=ck,
                  resume=True)


def test_gpt_primal_equals_path():
    """G-PT's primal + very_direct equals the path tracer (same counters,
    same estimator), as tests/test_gpt.py holds for the reference."""
    scene_np, st = port_scene.load_scene(
        CBOX, {"width": "24", "height": "24", "spp": "8", "maxDepth": "3"})
    scene = bridge.to_torch(scene_np, "cpu")
    out = GPTracer(scene, st).render(scene, seed=5, spp=2, chunk=2)
    img = PathTracer(scene, st).render(scene, seed=5, spp=2)
    torch.testing.assert_close(out["primal"] + out["very_direct"], img,
                               rtol=2e-4, atol=2e-5)


def test_cbox_matches_reference_brute_in_mean(cbox16):
    """The reference as it runs on the CPU (brute-force Moeller-Trumbore
    for small scenes) agrees with the port's path tracer in image mean
    within 1%."""
    scene, st = cbox16
    img = PathTracer(scene, st).render(scene, seed=3, spp=4).numpy()
    rs, rst = ref_scene.load_scene(
        CBOX, {"width": "16", "height": "16", "spp": "8", "maxDepth": "3"})
    ref = np.asarray(ref_path.PathTracer(rs, rst).render(rs, seed=3, spp=4))
    assert abs(img.mean() - ref.mean()) < 0.01 * abs(ref.mean())


def test_unported_branches_raise(tmp_path):
    """The branches that raised before their step: trace_rays's
    sss_cache adds the dipole term (step G2c), against the reference's
    trace_rays on 64 rays of tools/sss_scene.py's marble floor with one
    cache in both packages; the rest build."""
    import jax.numpy as jnp
    from gradientdomain_mitsuba_tpu.models import sss as ref_sss_model
    from gradientdomain_mitsuba_tpu.ops import sss as ref_sss
    from gradientdomain_mitsuba_tpu_torch.models.sss import DipoleTracer
    scene_np, st = ref_scene.load_scene(
        load_tool("sss_scene").write_scene(str(tmp_path), "floor"),
        {"width": "8", "height": "8", "spp": "1", "maxDepth": "3"})
    mp = pytest.MonkeyPatch()
    mp.setattr(ref_common, "choose_intersector", pinned_matmul)
    try:
        rt = ref_sss_model.DipoleTracer(scene_np, st)
    finally:
        mp.undo()
    ts = bridge.to_torch(scene_np, "cpu")
    pt = DipoleTracer(ts, st)
    rs = np.random.RandomState(2)
    cache = {k: np.array(v) for k, v in jax.jit(
        lambda: ref_sss.sample_surface_points(scene_np, 96, 5))().items()}
    cache["E"] = rs.uniform(0.5, 2.0, (96, 3)).astype(np.float32)
    N = 64
    o = np.tile(np.float32([[0.0, 0.6, 2.6]]), (N, 1))
    aim = np.float32([0.0, 0.0, 0.0]) + rs.uniform(-1.0, 1.0, (N, 3)) * (
        np.float32([1.0, 0.0, 1.0]))
    d = (aim - o) / np.linalg.norm(aim - o, axis=-1, keepdims=True)
    d = d.astype(np.float32)
    ref = np.asarray(jax.jit(
        lambda sc, o, d, c: rt.trace_rays(
            sc, 3, jnp.zeros(N, jnp.uint32), jnp.arange(N, dtype=jnp.uint32),
            o, d, sss_cache=c))(jax.device_put(scene_np), jnp.asarray(o),
                                jnp.asarray(d),
                                {k: jnp.asarray(v) for k, v in cache.items()}))
    args = (ts, 3, torch.zeros(N, dtype=torch.int64), torch.arange(N),
            torch.from_numpy(o), torch.from_numpy(d))
    got = pt.trace_rays(*args, sss_cache={
        k: torch.from_numpy(v) for k, v in cache.items()}).numpy()
    plain = pt.trace_rays(*args).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-6)
    added = (got - plain).max(-1)
    assert (added > -1e-6).all() and (added > 1e-3).sum() >= N // 2
    # door.xml, whose thindielectric raised here before, builds (and
    # renders against the reference: tests/test_torch_door.py); so does a
    # table with woven cloth (irawan), item 12 and the last BSDF kind
    # that raised (tests/test_torch_irawan.py); delta lights (item 14
    # before) build (their parity: tests/test_torch_lights_render.py)
    scene_np, st2 = port_scene.load_scene(
        os.path.join(ROOT, "data/scenes/door/door.xml"),
        {"width": "16", "height": "16"})
    ts = bridge.to_torch(scene_np, "cpu")
    PathTracer(ts, st2)
    kinds = path_mod.bsdf_ops.scene_kinds(ts)
    mp = pytest.MonkeyPatch()
    mp.setattr(path_mod.bsdf_ops, "scene_kinds", lambda s: kinds | {16})
    try:
        assert 16 in PathTracer(ts, st2).kinds
    finally:
        mp.undo()
    st2.n_delta = 1
    assert PathTracer(ts, st2).n_delta == 1


@pytest.mark.parametrize("lanes", [None, "1", "256", "65536", "3000000"])
def test_samples_per_batch_reads_gdmt_lanes(monkeypatch, lanes):
    """GDMT_LANES sizes a pass as the reference's PathTracer reads it,
    with its defaults for large and small scenes (the reference's method
    called on a stand-in that carries `settings` and `large_scene`)."""
    from types import SimpleNamespace
    if lanes is None:
        monkeypatch.delenv("GDMT_LANES", raising=False)
    else:
        monkeypatch.setenv("GDMT_LANES", lanes)
    for large in (False, True):
        for w, h in ((16, 16), (256, 256), (37, 5)):
            tracer = SimpleNamespace(
                large_scene=large, settings=SimpleNamespace(width=w,
                                                            height=h))
            for n in (1, 2, 6, 16, 97):
                assert (PathTracer.samples_per_batch(tracer, n) ==
                        ref_path.PathTracer.samples_per_batch(tracer, n)), (
                    large, w, h, n)
