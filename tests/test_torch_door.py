"""door.xml (BASELINE config #2, the Veach door) through the port's G-PT
+ L1 and path tracer against the reference on the CPU, and the
reference's half-vector copy at a thin dielectric.

door.xml holds diffuse, roughconductor (Cu), roughplastic and
thindielectric rows, three of them two-sided; its thin glass makes
any_specular hold, so G-PT takes the half-vector copy at every bounce.
The camera room is lit only through the doorway: at the reference
test's size and settings (tests/test_scenes.py: 32^2, 4 spp, maxDepth 6)
most pixels are lit (the share is checked, so a rule over pixels says
something).  The reference's intersectors are pinned to the linear-MT
matmul sweeps (tests/torch_parity.py); torch on one thread with
subnormals flushed.  Images at rtol 1e-3 / atol 1e-4 on >= 99% of
pixels with means within 1e-3 relative, the L1 final by objective (1%)
and mean (5e-3).  Rays: path's equal; G-PT's within one of the
reference's jitted render (the difference between that render and the
reference's own pass outside jit that test_torch_specular.py documents
for glossy scenes).  BDPT and G-BDPT on door: test_torch_gbdpt_door.py."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gradientdomain_mitsuba_tpu.models import gpt as ref_gpt
from gradientdomain_mitsuba_tpu.ops import bsdf as ref_bsdf
from gradientdomain_mitsuba_tpu.scene import materials as M
from gradientdomain_mitsuba_tpu_torch.models import factory, gpt
from gradientdomain_mitsuba_tpu_torch.models.gpt import GPTracer
from gradientdomain_mitsuba_tpu_torch.ops import bsdf
from gradientdomain_mitsuba_tpu_torch.scene import bridge
from gradientdomain_mitsuba_tpu_torch.scene import scene as port_scene
from torch_parity import flush_subnormals, one_thread  # noqa: F401
from torch_parity import (assert_l1_final_close, frac_close, load,
                          make_both, op_close, rel_mean_diff)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOOR = os.path.join(ROOT, "data/scenes/door/door.xml")
SIZE, SPP, DEPTH, SEED = 32, 4, 6, 1
BUFS = ("primal", "very_direct", "dx", "dy")
pytestmark = pytest.mark.usefixtures("flush_subnormals", "one_thread")


def test_door_kinds_and_factory():
    """door.xml's rows are the kinds this slice ports, and the factory
    builds all four of its integrators (gpt, path, bdpt, gbdpt)."""
    scene, st = port_scene.load_scene(DOOR, {"width": "8", "height": "8"})
    ts = bridge.to_torch(scene, "cpu")
    kinds = bsdf.scene_kinds(ts)
    assert kinds == {M.DIFFUSE, M.ROUGH_CONDUCTOR, M.ROUGH_PLASTIC,
                     M.THIN_DIELECTRIC}
    assert (ts.materials.packed[:, 1].int() & M.FLAG_TWOSIDED).sum() == 3
    for name in ("gpt", "path", "bdpt", "gbdpt"):
        st.integrator = name
        tracer = factory.make_integrator(ts, st)
        assert tracer.kinds == kinds
    assert GPTracer(ts, st).any_specular


@pytest.fixture(scope="module")
def path_renders():
    scene, st = load(DOOR, "path", size=SIZE, spp=SPP, depth=DEPTH)
    rt, rs, pt, ts = make_both(scene, st)
    rt.count_rays = pt.count_rays = True
    ref = np.asarray(rt.render(rs, seed=SEED, spp=SPP))
    got = pt.render(ts, seed=SEED, spp=SPP).numpy()
    return ref, got, rt.last_ray_count, pt.last_ray_count


def test_path_matches_reference(path_renders):
    ref, got, ref_rays, got_rays = path_renders
    assert got.shape == ref.shape == (SIZE, SIZE, 3)
    assert np.isfinite(got).all()
    # light reached the camera room on most pixels (measured 95%)
    assert (ref.max(-1) > 1e-4).mean() > 0.8
    assert frac_close(got, ref) >= 0.99
    assert rel_mean_diff(got, ref) < 1e-3
    assert int(got_rays) == int(ref_rays) > 0


@pytest.fixture(scope="module")
def gpt_renders():
    """Both packages' render_final (L1) with their buffers and rays."""
    scene, st = load(DOOR, "gpt", size=SIZE, spp=SPP, depth=DEPTH)
    rt, rs, pt, ts = make_both(scene, st)
    assert type(pt) is GPTracer and pt.any_specular and rt.any_specular
    rt.count_rays = pt.count_rays = True
    out = {}
    for name, tr, sc in (("ref", rt, rs), ("port", pt, ts)):
        final, bufs = tr.render_final(sc, SEED, SPP, alpha=0.2, mode="L1")
        out[name] = {k: np.asarray(bufs[k]) for k in BUFS}
        out[name]["L1"] = np.asarray(final)
        out[name]["rays"] = int(np.asarray(bufs["rays"]))
    return out


@pytest.mark.parametrize("name", BUFS)
def test_gpt_buffers_match_reference(gpt_renders, name):
    got, ref = gpt_renders["port"][name], gpt_renders["ref"][name]
    assert got.shape == ref.shape == (SIZE, SIZE, 3)
    assert np.isfinite(got).all()
    if name == "very_direct":   # the light is not seen from the room
        assert not ref.any()
    else:
        assert np.abs(ref).mean() > 1e-5
    if name == "primal":
        assert (ref.max(-1) > 1e-4).mean() > 0.8
    assert frac_close(got, ref) >= 0.99
    assert (rel_mean_diff(got, ref) < 1e-3 or
            abs(got.mean() - ref.mean()) < 1e-6)


def test_gpt_ray_counts(gpt_renders):
    got, ref = gpt_renders["port"]["rays"], gpt_renders["ref"]
    assert got > 0
    # 86,221 in the port, 86,220 in the reference's jitted render
    assert abs(got - ref["rays"]) <= 1


def test_gpt_l1_final_matches_reference(gpt_renders):
    assert_l1_final_close(gpt_renders["port"]["L1"], gpt_renders["ref"])


def _unit(rs, n):
    v = rs.normal(size=(n, 3))
    return np.float32(v / np.linalg.norm(v, axis=-1, keepdims=True))


def test_half_vector_copy_bends_at_thin_glass():
    """The reference's half-vector copy treats a thin dielectric offset as
    a solid one: where the base passed straight through the thin glass
    (wo = -wi), the offset is refracted about the normal with its eta,
    so its wo is NOT -wi_o, where thindielectric.cpp would let it pass
    unbent (ROADMAP Queue 3).  The port mirrors it: the copy equals the
    reference's at thin rows."""
    mb = M.MaterialBuilder()
    mb.add_row(kind=M.THIN_DIELECTRIC, eta=(1.5,) * 3)
    mb.add_row(kind=M.THIN_DIELECTRIC, eta=(1.33,) * 3,
               transmittance=(0.9, 0.8, 0.7), flags=M.FLAG_TWOSIDED)
    mats = mb.finalize()
    kinds = frozenset(int(k) for k in np.unique(mats.kind))
    rs = np.random.RandomState(13)
    n = 4000
    mid = rs.randint(0, 2, n).astype(np.int32)
    wi_m = _unit(rs, n)
    wi_o = wi_m + np.float32(rs.normal(0, 0.08, (n, 3)))
    wi_o = np.float32(wi_o / np.linalg.norm(wi_o, axis=-1, keepdims=True))
    u2 = np.float32(rs.uniform(size=(n, 2)))
    uc = np.float32(rs.uniform(size=n))
    rp = ref_bsdf.gather_params(jax.device_put(mats), jnp.asarray(mid))
    bs = ref_bsdf.sample(rp, jnp.asarray(wi_m), jnp.asarray(u2),
                         jnp.asarray(uc), kinds)
    wo_m = np.array(bs.wo)
    is_delta_m = np.array(bs.is_delta)
    ref = ref_gpt.half_vector_copy(
        lambda p, a, b: ref_bsdf.eval(p, a, b, kinds),
        lambda p, a, b: ref_bsdf.pdf(p, a, b, kinds),
        jnp.asarray(wi_m), jnp.asarray(wo_m), rp, jnp.asarray(is_delta_m),
        jnp.asarray(wi_o), rp)
    t = torch.from_numpy
    tp = bsdf.gather_params(bridge.to_torch(mats, "cpu"), t(mid))
    got = gpt.half_vector_copy(
        lambda p, a, b: bsdf.eval(p, a, b, kinds),
        lambda p, a, b: bsdf.pdf(p, a, b, kinds),
        t(wi_m), t(wo_m), tp, t(is_delta_m), t(wi_o), tp)
    for name in ("valid", "is_delta"):
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(ref[name]), name)
    for name in ("wo", "f", "pdf", "jac"):
        op_close(got[name].numpy(), np.asarray(ref[name]), name)
    through = np.isclose(wo_m, -wi_m, atol=1e-6).all(-1) & is_delta_m
    valid = got["valid"].numpy()
    lanes = through & valid
    assert lanes.mean() > 0.2
    wo_o = got["wo"].numpy()[lanes]
    bend = np.linalg.norm(wo_o + wi_o[lanes], axis=-1)
    # refracted with eta 1.33-1.5, not passed straight through
    assert (bend > 1e-3).mean() > 0.95
    # and not on wi_o's side either: it crossed the sheet
    assert (wo_o[:, 2] * wi_o[lanes, 2] < 0).all()
