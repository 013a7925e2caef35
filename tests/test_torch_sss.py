"""Dipole subsurface scattering in the port (ROADMAP step G2c) against the
reference on the CPU: models/sss.py's DipoleTracer (its irradiance
cache and its render) on tests/test_sss.py's scene, written by
tools/sss_scene.py (a tessellated marble sphere, 32,258 triangles: the
port walks the pair traversal's plain version, the reference is pinned
to a full linear-MT matmul, torch_parity.pinned_full_matmul).  At
32x32, 1 spp, maxDepth 3 (the reference's matmul sweeps over 32k
triangles are most of this file's time; the scene's cache of 256
points x 4 rays as test_sss.py has it).  ops/sss.py's pieces:
tests/test_torch_sss_ops.py.

Tolerances: the cache's rows bit for bit, p / n / aw at rtol 1e-6, E at
rtol 1e-4 on >= 99.9% of points; the render with rays counted in both
packages equal, rtol 1e-3 / atol 1e-4 on >= 99% of pixels, means within
1e-4 relative."""
import copy

import jax
import numpy as np
import pytest

from gradientdomain_mitsuba_tpu.scene import scene as ref_scene
from gradientdomain_mitsuba_tpu_torch.models.path import PathTracer
from gradientdomain_mitsuba_tpu_torch.models.sss import DipoleTracer
from torch_parity import (count_port_rays, counting_choose, frac_close,
                          load_tool, make_both, pinned_full_matmul,
                          rel_mean_diff)
from torch_parity import one_thread  # noqa: F401

# torch on one thread: the suite runs six workers, and a multi-threaded
# CPU torch among them spends the renders' time contending for cores
pytestmark = pytest.mark.usefixtures("one_thread")

sss_scene = load_tool("sss_scene")
SEED, SPP, SIZE, DEPTH = 1, 1, 32, 3


@pytest.fixture(scope="module")
def dipole_renders(tmp_path_factory):
    """DipoleTracer on the one-sphere scene at 32x32, 1 spp, maxDepth 3,
    seed 1 (the cache: 256 points, 4 rays each, test_sss.py's values) in
    both packages, built through both factories, with the rays of the
    whole render (cache and passes) counted in both."""
    scene, st = ref_scene.load_scene(
        sss_scene.write_scene(str(tmp_path_factory.mktemp("sss"))),
        {"width": str(SIZE), "height": str(SIZE), "spp": str(SPP),
         "maxDepth": str(DEPTH)})
    ref_tally, port_tally = [], []
    rt, rs, pt, ts = make_both(
        scene, st, counting_choose(pinned_full_matmul(scene), ref_tally))
    count_port_rays(pt, port_tally)
    ref = np.asarray(rt.render(rs, seed=SEED, spp=SPP))
    got = pt.render(ts, seed=SEED, spp=SPP).numpy()
    jax.effects_barrier()
    plain = PathTracer(ts, copy.deepcopy(st)).render(ts, seed=SEED,
                                                     spp=SPP).numpy()
    return dict(ref=ref, got=got, plain=plain, rt=rt, pt=pt,
                ref_rays=sum(ref_tally), port_rays=sum(port_tally))


def test_factory_builds_dipole_tracer(dipole_renders):
    pt = dipole_renders["pt"]
    assert type(pt) is DipoleTracer
    assert [k.name for k in pt.kernels] == ["pair_closest", "pair_occluded"]
    assert (pt.n_points, pt.irr_samples) == (256, 4)


def test_dipole_cache_matches_reference(dipole_renders):
    got, ref = dipole_renders["pt"]._cache, dipole_renders["rt"]._cache
    np.testing.assert_array_equal(got["row"].numpy(), np.asarray(ref["row"]))
    for k in ("p", "n", "aw"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    E, E_ref = got["E"].numpy(), np.asarray(ref["E"])
    assert np.isfinite(E).all() and (E_ref.max(-1) > 0).mean() > 0.5
    assert np.isclose(E, E_ref, rtol=1e-4, atol=0).all(-1).mean() >= 0.999


def test_dipole_render_rays_equal(dipole_renders):
    assert dipole_renders["port_rays"] == dipole_renders["ref_rays"] > 0


def test_dipole_render_matches_reference(dipole_renders):
    got, ref = dipole_renders["got"], dipole_renders["ref"]
    assert got.shape == ref.shape == (SIZE, SIZE, 3)
    assert np.isfinite(got).all()
    assert frac_close(got, ref) >= 0.99
    assert rel_mean_diff(got, ref) <= 1e-4


def test_dipole_render_oracle(dipole_renders):
    """test_sss.py's oracle: the sphere in the image centre scatters light
    back out; and the dipole term adds light there (the same scene
    through PathTracer, which has no cache)."""
    got, plain = dipole_renders["got"], dipole_renders["plain"]
    c = got[12:20, 12:20].mean()
    assert c > 1e-3
    assert c > plain[12:20, 12:20].mean() * 1.05
