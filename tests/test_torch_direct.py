"""The port's step-B integrators against the reference on the CPU, cbox
16^2, 2 spp, maxDepth 5, seed 3: direct, ao, field (every field),
multichannel (children path + ao) and adaptive, all built through the
factories; and the port's factory itself.

The reference's intersectors are pinned to the linear-MT matmul sweeps,
as in test_torch_gpt.py; the images then agree at rtol 1e-3 / atol 1e-4
on >= 99% of pixels, and the adaptive sample map is equal."""
import copy
import os

import jax
import numpy as np
import pytest

from gradientdomain_mitsuba_tpu.models import factory as ref_factory
from gradientdomain_mitsuba_tpu.ops import common as ref_common
from gradientdomain_mitsuba_tpu.ops import intersect as ref_isec
from gradientdomain_mitsuba_tpu.scene import scene as ref_scene
from gradientdomain_mitsuba_tpu_torch.models import (adaptive, bdpt, direct,
                                                     erpt, factory, gbdpt,
                                                     gpt, irrcache, mlt,
                                                     multichannel, path,
                                                     pssmlt, sppm, volpath,
                                                     vpl)
from gradientdomain_mitsuba_tpu_torch.scene import bridge
from torch_parity import one_thread  # noqa: F401

# torch on one thread: the suite runs six workers, and a multi-threaded
# CPU torch among them spends the renders' time contending for cores
pytestmark = pytest.mark.usefixtures("one_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CBOX = os.path.join(ROOT, "data/scenes/cbox/cbox.xml")
SEED, SPP = 3, 2
CHILDREN = [("path", {}), ("ao", {})]


def _pinned_matmul(settings, n_tris, n_clusters=0):
    def closest(o, d, mint, maxt, geom):
        return ref_isec.intersect_matmul(o, d, mint, maxt, geom.linC)

    def occl(o, d, mint, maxt, geom):
        return ref_isec.occluded_matmul(o, d, mint, maxt, geom.linC)
    return ref_common.add_sphere_intersections(closest, occl)


def _load(integrator, props=None):
    scene, st = ref_scene.load_scene(CBOX, {
        "width": "16", "height": "16", "spp": str(SPP), "maxDepth": "5",
        "integrator": integrator})
    st.integrator_props.update(props or {})
    if integrator == "multichannel":
        st.integrator_children = copy.deepcopy(CHILDREN)
    return scene, st


def _render_both(integrator, props=None):
    """(reference result, port result, reference tracer, port tracer);
    a dict result stays a dict, an image becomes {"image": ...}."""
    scene, st = _load(integrator, props)
    mp = pytest.MonkeyPatch()
    mp.setattr(ref_common, "choose_intersector", _pinned_matmul)
    try:
        rt = ref_factory.make_integrator(scene, st)
        ref = rt.render(jax.device_put(scene), seed=SEED, spp=SPP)
    finally:
        mp.undo()
    ts = bridge.to_torch(scene, "cpu")
    pt = factory.make_integrator(ts, st)
    got = pt.render(ts, seed=SEED, spp=SPP)
    if not isinstance(ref, dict):
        ref, got = {"image": ref}, {"image": got}
    return ({k: np.asarray(v) for k, v in ref.items()},
            {k: v.numpy() for k, v in got.items()}, rt, pt)


def _assert_image_close(got, ref):
    assert got.shape == ref.shape == (16, 16, 3)
    assert np.isfinite(got).all()
    assert np.isclose(got, ref, rtol=1e-3, atol=1e-4).all(-1).mean() >= 0.99
    assert abs(got.mean() - ref.mean()) <= 1e-4 * abs(ref.mean()) + 1e-6


@pytest.mark.parametrize("integrator,cls", [
    ("direct", direct.DirectIntegrator), ("ao", direct.AOIntegrator)])
def test_direct_and_ao_match_reference(integrator, cls):
    ref, got, _, pt = _render_both(integrator)
    assert type(pt) is cls
    _assert_image_close(got["image"], ref["image"])
    assert np.abs(ref["image"]).mean() > 0


def test_direct_keeps_settings():
    """DirectIntegrator runs maxDepth 2 on a copy of the settings."""
    scene, st = _load("direct")
    tr = direct.DirectIntegrator(bridge.to_torch(scene, "cpu"), st)
    assert tr.settings.max_depth == 2 and st.max_depth == 5


@pytest.mark.parametrize("field", direct.FIELDS)
def test_field_matches_reference(field):
    ref, got, _, pt = _render_both("field", {"field": field})
    assert type(pt) is direct.FieldIntegrator and pt.field == field
    _assert_image_close(got["image"], ref["image"])


def test_multichannel_matches_reference():
    ref, got, rt, pt = _render_both("multichannel")
    assert [n for n, _ in pt.children] == [n for n, _ in rt.children] == \
        ["path", "ao"]
    assert type(pt.children[0][1]) is path.PathTracer
    assert type(pt.children[1][1]) is direct.AOIntegrator
    assert sorted(got) == sorted(ref)
    for k in ref:
        _assert_image_close(got[k], ref[k])


def test_multichannel_channel_names_and_depths():
    scene, st = _load("multichannel")
    st.integrator_children = [("field", {"field": "uv"}),
                              ("field", {"field": "uv"}),
                              ("direct", {"maxDepth": 3, "rrDepth": 2})]
    ts = bridge.to_torch(scene, "cpu")
    mc = multichannel.MultiChannelIntegrator(ts, st)
    assert [n for n, _ in mc.children] == ["field_uv", "field_uv_1",
                                           "direct"]
    assert mc.children[2][1].settings.rr_depth == 2
    st.integrator_children = [("adaptive", {})]
    with pytest.raises(ValueError, match="nested"):
        multichannel.MultiChannelIntegrator(ts, st)


def test_adaptive_matches_reference():
    """At 16^2 the refine batch covers the film (K = N), so the refined
    pixels and their sample indices do not depend on the tie order: the
    sample map is equal and the image agrees."""
    ref, got, rt, pt = _render_both("adaptive")
    assert type(pt) is adaptive.AdaptiveTracer
    np.testing.assert_array_equal(pt.last_sample_map.numpy(),
                                  rt.last_sample_map)
    assert rt.last_sample_map.max() > SPP
    _assert_image_close(got["image"], ref["image"])


PORTED_TYPES = {"path": path.PathTracer, "gpt": gpt.GPTracer,
                "bdpt": bdpt.BDPTracer, "gbdpt": gbdpt.GBDPTracer,
                "direct": direct.DirectIntegrator,
                "ao": direct.AOIntegrator, "field": direct.FieldIntegrator,
                "multichannel": multichannel.MultiChannelIntegrator,
                "adaptive": adaptive.AdaptiveTracer,
                "volpath": volpath.VolPathTracer,
                "volpath_simple": volpath.VolPathTracer,
                "irrcache": irrcache.IrrCacheTracer, "vpl": vpl.VPLTracer,
                "sppm": sppm.SPPMTracer, "ppm": sppm.SPPMTracer,
                "photonmapper": sppm.SPPMTracer,
                "pssmlt": pssmlt.PSSMLTracer, "mlt": mlt.MLTracer,
                "erpt": erpt.ERPTracer}


@pytest.mark.parametrize("integrator", ref_factory.KNOWN)
def test_factory_covers_known_types(integrator):
    """Every type of the reference's KNOWN is constructed as its own
    class, never falling through to the path tracer, and none is left
    unported."""
    assert factory.KNOWN == ref_factory.KNOWN
    assert factory.UNPORTED == {}
    assert set(factory.PORTED) == set(factory.KNOWN)
    scene, st = _load(integrator)
    ts = bridge.to_torch(scene, "cpu")
    assert type(factory.make_integrator(ts, st)) is PORTED_TYPES[integrator]


def test_factory_unknown_type_and_subsurface(tmp_path):
    """An unknown type falls through to the path tracer; on a scene with
    dipole attachments (tools/sss_scene.py: test_sss.py's scene) the
    path family gets the DipoleTracer (its parity:
    tests/test_torch_sss.py)."""
    import importlib.util
    from gradientdomain_mitsuba_tpu_torch.models.sss import DipoleTracer
    scene, st = _load("path")
    ts = bridge.to_torch(scene, "cpu")
    st.integrator = "no-such-integrator"
    assert type(factory.make_integrator(ts, st)) is path.PathTracer
    spec = importlib.util.spec_from_file_location(
        "sss_scene", os.path.join(ROOT, "tools", "sss_scene.py"))
    sss_scene = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sss_scene)
    scene, st = ref_scene.load_scene(
        sss_scene.write_scene(str(tmp_path)),
        {"width": "8", "height": "8", "spp": "1"})
    assert st.has_sss and st.integrator == "path"
    tracer = factory.make_integrator(bridge.to_torch(scene, "cpu"), st)
    assert type(tracer) is DipoleTracer
