"""The port's irradiance cache (models/irrcache.py) against the reference
on the CPU, through both factories: cbox 16^2, 2 spp, maxDepth 5,
gatherSamples 16 (the default resolution 4: 16 records of 16 final-gather
walks).  Images at rtol 1e-3 / atol 1e-4 on >= 99% of pixels; a second
render with another seed rebuilds the cache in both packages (the
reference's test_irrcache_rerender_refreshes_cache) and matches too."""
import os

import numpy as np
import pytest

from gradientdomain_mitsuba_tpu_torch.models.irrcache import IrrCacheTracer
from torch_parity import assert_image_close, load, render_both
from torch_parity import one_thread  # noqa: F401

# torch on one thread: the suite runs six workers, and a multi-threaded
# CPU torch among them spends the renders' time contending for cores
pytestmark = pytest.mark.usefixtures("one_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CBOX = os.path.join(ROOT, "data/scenes/cbox/cbox.xml")
SPP = 2


@pytest.fixture(scope="module")
def renders():
    scene, st = load(CBOX, "irrcache", spp=SPP,
                     props={"gatherSamples": 16})
    return render_both(scene, st, [1, 2], SPP, count_rays=True)


def test_irrcache_matches_reference(renders):
    ref, got, rt, pt = renders
    assert type(pt) is IrrCacheTracer
    assert pt._all_diffuse and pt.gather_samples == 16
    for g, r in zip(got, ref):
        assert_image_close(g, r)
        assert np.abs(r).mean() > 1e-3
    # the cached render_chunk reports no rays, as the reference's
    assert pt.last_ray_count == int(rt.last_ray_count) == 0


def test_irrcache_rerender_refreshes_cache(renders):
    """The cache is rebuilt for the second seed: the images differ."""
    ref, got, _, _ = renders
    assert not np.allclose(got[0], got[1])
    assert not np.allclose(ref[0], ref[1])
