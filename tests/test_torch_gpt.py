"""The port's slice as a whole on the CPU: G-PT render + screened-Poisson
reconstruction of cbox (16^2, 2 spp, maxDepth 6, seed 3) in both packages.

On the CPU the reference intersects small scenes with intersect_brute;
here its intersectors are pinned to the linear-MT matmul sweeps
(intersect_matmul / occluded_matmul) — the math its Pallas sweep kernels
compute and the port's plain versions implement — so both sides trace
the same hits.  The buffers then agree tightly (rtol 1e-3 / atol 1e-4 on
>= 99% of pixels; the allowance covers an ulp-level t difference flipping
a Russian-roulette or shift decision) and the measured ray counts are
equal.  The L2 reconstruction is compared the same way; the L1 one by its
objective and mean, because the reference's own L1 IRLS moves by more
than that tolerance under one-ulp input changes (test_torch_poisson.py).
One reference render is compiled per configuration; the L2 final reuses
the reference's buffers through the reference's solve_l2, which is what
its render_final does after render_chunk."""
import os

import jax
import numpy as np
import pytest
import torch

from gradientdomain_mitsuba_tpu.models import gpt as ref_gpt
from gradientdomain_mitsuba_tpu.models import poisson as ref_poisson
from gradientdomain_mitsuba_tpu.ops import common as ref_common
from gradientdomain_mitsuba_tpu.ops import intersect as ref_isec
from gradientdomain_mitsuba_tpu.scene import scene as ref_scene
from gradientdomain_mitsuba_tpu_torch.models import gpt as gpt_mod
from gradientdomain_mitsuba_tpu_torch.models.gpt import GPTracer
from gradientdomain_mitsuba_tpu_torch.scene import bridge
from gradientdomain_mitsuba_tpu_torch.scene import scene as port_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CBOX = os.path.join(ROOT, "data/scenes/cbox/cbox.xml")
VARS = {"width": "16", "height": "16", "spp": "2", "maxDepth": "6",
        "integrator": "gpt"}
SEED, SPP = 3, 2
BUFS = ("primal", "very_direct", "dx", "dy")


def _pinned_matmul(settings, n_tris, n_clusters=0):
    def closest(o, d, mint, maxt, geom):
        return ref_isec.intersect_matmul(o, d, mint, maxt, geom.linC)

    def occl(o, d, mint, maxt, geom):
        return ref_isec.occluded_matmul(o, d, mint, maxt, geom.linC)
    return ref_common.add_sphere_intersections(closest, occl)


@pytest.fixture(scope="module")
def reference():
    """Reference render_final (L1) with the matmul sweeps pinned, plus
    its L2 final from the same buffers."""
    mp = pytest.MonkeyPatch()
    mp.setattr(ref_common, "choose_intersector", _pinned_matmul)
    try:
        scene, st = ref_scene.load_scene(CBOX, VARS)
        tracer = ref_gpt.GPTracer(scene, st)
        tracer.count_rays = True
        final, bufs = tracer.render_final(jax.device_put(scene), SEED, SPP,
                                          alpha=0.2, mode="L1")
    finally:
        mp.undo()
    out = {k: np.asarray(bufs[k]) for k in BUFS}
    out["rays"] = float(bufs["rays"])
    out["L1"] = np.asarray(final)
    out["L2"] = np.asarray(ref_poisson.solve_l2(
        bufs["primal"], bufs["dx"], bufs["dy"], alpha=0.2, iters=100) +
        bufs["very_direct"])
    return out


@pytest.fixture(scope="module")
def port():
    scene, st = port_scene.load_scene(CBOX, VARS)
    ts = bridge.to_torch(scene, "cpu")
    out = {}
    for mode in ("L1", "L2"):
        tracer = GPTracer(ts, st)
        tracer.count_rays = True
        final, bufs = tracer.render_final(ts, SEED, SPP, alpha=0.2,
                                          mode=mode)
        out[mode] = final.numpy()
        out["rays"] = int(bufs["rays"])
        out.update({k: bufs[k].numpy() for k in BUFS})
        assert tracer.kernels[0].launches == 0   # CPU: plain versions
    return out


def _frac_close(got, ref):
    return np.isclose(got, ref, rtol=1e-3, atol=1e-4).all(-1).mean()


def _rel_mean_diff(got, ref):
    return abs(got.mean() - ref.mean()) / max(abs(ref.mean()), 1e-12)


@pytest.mark.parametrize("name", BUFS)
def test_buffers_match_reference(reference, port, name):
    got, ref = port[name], reference[name]
    assert got.shape == ref.shape == (16, 16, 3)
    assert np.isfinite(got).all()
    assert _frac_close(got, ref) >= 0.99
    assert _rel_mean_diff(got, ref) < 1e-4 or \
        abs(got.mean() - ref.mean()) < 1e-6


def test_ray_counts_equal(reference, port):
    assert port["rays"] == reference["rays"] > 0


def test_l2_final_matches_reference(reference, port):
    assert _frac_close(port["L2"], reference["L2"]) >= 0.99
    assert _rel_mean_diff(port["L2"], reference["L2"]) < 1e-4


def test_l1_final_matches_reference(reference, port):
    got, ref = port["L1"], reference["L1"]
    assert np.isfinite(got).all()
    assert _rel_mean_diff(got, ref) < 5e-3
    # the same L1 objective over the reconstruction (final - very_direct)
    p, gx, gy = (reference[k] for k in ("primal", "dx", "dy"))
    vd = reference["very_direct"]

    def energy(x):
        gxm, gym = gx.copy(), gy.copy()
        gxm[:, -1] = 0.0
        gym[-1] = 0.0
        dx = np.pad(x[:, 1:] - x[:, :-1], ((0, 0), (0, 1), (0, 0)))
        dy = np.pad(x[1:] - x[:-1], ((0, 1), (0, 0), (0, 0)))
        return (np.abs(dx - gxm).sum() + np.abs(dy - gym).sum() +
                0.2 * np.abs(x - p).sum())

    e_ref, e_got = energy(ref - vd), energy(got - vd)
    assert abs(e_got - e_ref) <= 0.01 * e_ref, (e_got, e_ref)


def test_brute_force_reference_agrees_in_mean(port):
    """The reference as it runs on the CPU (unpinned: brute-force
    Moeller-Trumbore) agrees with the port in image means within 1%."""
    scene, st = ref_scene.load_scene(CBOX, VARS)
    tracer = ref_gpt.GPTracer(scene, st)
    final, bufs = tracer.render_final(jax.device_put(scene), SEED, SPP,
                                      alpha=0.2, mode="L1")
    assert _rel_mean_diff(port["L1"], np.asarray(final)) < 0.01
    assert _rel_mean_diff(port["primal"], np.asarray(bufs["primal"])) < 0.01


def test_walls_are_colored(port):
    """Red wall on the left, green on the right (cbox.xml)."""
    img = port["L2"]
    left, right = img[4:12, 0:2].mean((0, 1)), img[4:12, -2:].mean((0, 1))
    assert left[0] > left[1] and right[1] > right[0]


def test_render_is_deterministic():
    scene, st = port_scene.load_scene(CBOX, VARS)
    ts = bridge.to_torch(scene, "cpu")
    a = GPTracer(ts, st).render_chunk(ts, SEED, 0, SPP)
    b = GPTracer(ts, st).render_chunk(ts, SEED, 0, SPP)
    for k in a:
        assert torch.equal(a[k], b[k]), k


IRAWAN_XML = """<scene version="0.5.0">
  <sensor type="perspective">
    <float name="fov" value="45"/>
    <transform name="toWorld">
      <lookat origin="0, 1.2, 2.2" target="0, 0, 0" up="0, 1, 0"/>
    </transform>
    <film type="hdrfilm">
      <integer name="width" value="8"/><integer name="height" value="8"/>
    </film>
  </sensor>
  <shape type="rectangle">
    <transform name="toWorld"><rotate x="1" angle="-90"/></transform>
    <bsdf type="irawan">
      <string name="filename" value="cotton_denim.wif"/>
    </bsdf>
  </shape>
  <shape type="rectangle">
    <transform name="toWorld">
      <rotate x="1" angle="90"/><translate y="2.5"/>
    </transform>
    <emitter type="area"><rgb name="radiance" value="6, 6, 6"/></emitter>
  </shape>
</scene>
"""


def test_unported_scenes_raise(tmp_path):
    """Woven cloth (irawan), item 12 and the one BSDF kind that raised
    here, is ported: the loader builds the irawan XML and GPTracer
    renders it (its parity with the reference:
    tests/test_torch_irawan.py, tests/test_torch_texture_rest.py), as it
    renders door.xml.  Delta lights (item 14 before) build and render
    (their parity: tests/test_torch_lights_render.py)."""
    path = tmp_path / "cloth.xml"
    path.write_text(IRAWAN_XML)
    scene, st = port_scene.load_scene(str(path), VARS)
    ts = bridge.to_torch(scene, "cpu")
    assert 16 in gpt_mod.bsdf_ops.scene_kinds(ts)
    bufs = GPTracer(ts, st).render(ts, seed=0, spp=1)
    assert all(torch.isfinite(v).all() for v in bufs.values())
    assert bufs["primal"].sum() > 0
    scene, st = port_scene.load_scene(
        os.path.join(ROOT, "data/scenes/door/door.xml"), VARS)
    GPTracer(bridge.to_torch(scene, "cpu"), st)
    st.n_delta = 1
    tracer = GPTracer(bridge.to_torch(scene, "cpu"), st)
    assert tracer.n_delta == 1 and tracer.n_lights == tracer.n_area + 1


@pytest.mark.parametrize("lanes", [None, "1", "256", "300", "4096",
                                   "1000000"])
def test_samples_per_batch_reads_gdmt_lanes(monkeypatch, lanes):
    """GDMT_LANES sizes a pass as the reference's GPTracer reads it (the
    reference's method called on a stand-in that carries `settings`)."""
    from types import SimpleNamespace
    if lanes is None:
        monkeypatch.delenv("GDMT_LANES", raising=False)
    else:
        monkeypatch.setenv("GDMT_LANES", lanes)
    for w, h in ((16, 16), (256, 256), (37, 5)):
        tracer = SimpleNamespace(settings=SimpleNamespace(width=w, height=h))
        for n in (1, 2, 6, 64, 97):
            assert (GPTracer.samples_per_batch(tracer, n) ==
                    ref_gpt.GPTracer.samples_per_batch(tracer, n)), (w, h, n)


def test_gdmt_lanes_changes_only_summation_order(monkeypatch):
    """16^2 at 2 spp: one pass by default, two under GDMT_LANES=256; the
    same samples are drawn, so the buffers agree to summation order and
    the measured rays are equal."""
    scene, st = port_scene.load_scene(CBOX, VARS)
    ts = bridge.to_torch(scene, "cpu")
    out = []
    for lanes in (None, "256"):
        if lanes is None:
            monkeypatch.delenv("GDMT_LANES", raising=False)
        else:
            monkeypatch.setenv("GDMT_LANES", lanes)
        tracer = GPTracer(ts, st)
        tracer.count_rays = True
        assert tracer.samples_per_batch(SPP) == (SPP if lanes is None
                                                 else 1)
        out.append(tracer.render_chunk(ts, SEED, 0, SPP))
    a, b = out
    assert int(a["rays"]) == int(b["rays"]) > 0
    for k in (*BUFS, "wsum"):
        torch.testing.assert_close(a[k], b[k], rtol=1e-6, atol=1e-7)
