"""Helpers shared by the port's slice parity tests (test_torch_volpath.py,
test_torch_sppm.py, test_torch_irrcache.py): one scene rendered through
both packages' factories with the reference's intersectors pinned to the
linear-MT matmul sweeps (the function the port's plain sweeps compute, as
in test_torch_gpt.py), and the image check."""
import copy

import jax
import numpy as np
import pytest

from gradientdomain_mitsuba_tpu.models import factory as ref_factory
from gradientdomain_mitsuba_tpu.ops import common as ref_common
from gradientdomain_mitsuba_tpu.ops import intersect as ref_isec
from gradientdomain_mitsuba_tpu.scene import scene as ref_scene
from gradientdomain_mitsuba_tpu_torch.models import factory
from gradientdomain_mitsuba_tpu_torch.scene import bridge


def pinned_matmul(settings, n_tris, n_clusters=0):
    def closest(o, d, mint, maxt, geom):
        return ref_isec.intersect_matmul(o, d, mint, maxt, geom.linC)

    def occl(o, d, mint, maxt, geom):
        return ref_isec.occluded_matmul(o, d, mint, maxt, geom.linC)
    return ref_common.add_sphere_intersections(closest, occl)


def load(path, integrator, size=16, spp=2, depth=5, props=None):
    scene, st = ref_scene.load_scene(path, {
        "width": str(size), "height": str(size), "spp": str(spp),
        "maxDepth": str(depth)})
    st.integrator = integrator
    st.integrator_props.update(props or {})
    return scene, st


def make_both(scene, st):
    """(reference tracer, its device scene, port tracer, its scene), each
    built through its package's factory on its own copy of the
    settings; the reference's intersectors pinned while it is built."""
    mp = pytest.MonkeyPatch()
    mp.setattr(ref_common, "choose_intersector", pinned_matmul)
    try:
        rt = ref_factory.make_integrator(scene, copy.deepcopy(st))
    finally:
        mp.undo()
    ts = bridge.to_torch(scene, "cpu")
    return (rt, jax.device_put(scene),
            factory.make_integrator(ts, copy.deepcopy(st)), ts)


def render_both(scene, st, seeds, spp, count_rays=False):
    """Renders of each seed of `seeds` in both packages (one tracer each,
    so re-renders reuse it): ([reference images], [port images],
    reference tracer, port tracer)."""
    rt, rs, pt, ts = make_both(scene, st)
    rt.count_rays = pt.count_rays = count_rays
    ref = [np.asarray(rt.render(rs, seed=s, spp=spp)) for s in seeds]
    got = [pt.render(ts, seed=s, spp=spp).numpy() for s in seeds]
    return ref, got, rt, pt


def assert_image_close(got, ref, size=16):
    """rtol 1e-3 / atol 1e-4 on >= 99% of pixels, finite, equal shape."""
    assert got.shape == ref.shape == (size, size, 3)
    assert np.isfinite(got).all()
    frac = np.isclose(got, ref, rtol=1e-3, atol=1e-4).all(-1).mean()
    assert frac >= 0.99, frac
    assert abs(got.mean() - ref.mean()) <= 1e-3 * abs(ref.mean()) + 1e-6
