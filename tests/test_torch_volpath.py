"""The port's volumetric path tracer (models/volpath.py) against the
reference on the CPU, through both factories, 16^2, 2 spp, maxDepth 5:
cbox (no medium: the surface path), the Henyey-Greenstein slab of
tests/test_volpath.py (a null-bounded homogeneous medium, sigmaS 1.2,
g 0.6) and the same slab as a heterogeneous medium over a density-ramp
grid (both written by tools/media_scenes.py).  Images at rtol 1e-3 /
atol 1e-4 on >= 99% of pixels, measured ray counts equal."""
import importlib.util
import os

import numpy as np
import pytest

from gradientdomain_mitsuba_tpu_torch.models.volpath import VolPathTracer
from torch_parity import assert_image_close, load, render_both
from torch_parity import one_thread  # noqa: F401

# torch on one thread: the suite runs six workers, and a multi-threaded
# CPU torch among them spends the renders' time contending for cores
pytestmark = pytest.mark.usefixtures("one_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CBOX = os.path.join(ROOT, "data/scenes/cbox/cbox.xml")
_spec = importlib.util.spec_from_file_location(
    "media_scenes", os.path.join(ROOT, "tools", "media_scenes.py"))
media_scenes = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(media_scenes)
SEED, SPP = 3, 2


@pytest.mark.parametrize("which", ["cbox", "hg_slab", "het_slab"])
def test_volpath_matches_reference(tmp_path, which):
    path = (CBOX if which == "cbox" else
            media_scenes.write_slab_scenes(str(tmp_path))[which])
    scene, st = load(path, "volpath", spp=SPP)
    assert (st.width, st.height, st.max_depth) == (16, 16, 5)
    assert st.has_media == (which != "cbox")
    assert st.has_het_media == (which == "het_slab")
    (ref,), (got,), rt, pt = render_both(scene, st, [SEED], SPP,
                                         count_rays=True)
    assert type(pt) is VolPathTracer
    assert_image_close(got, ref)
    assert np.abs(ref).mean() > 1e-3
    if which != "cbox":   # the medium dims the light (radiance 3) behind it
        assert ref.mean() < 2.9
    assert pt.last_ray_count == int(rt.last_ray_count) > 0
