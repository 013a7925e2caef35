"""G-BDPT's specular prefix replay against the reference on the CPU:
caustics.xml (a glass and an Ag sphere over a diffuse floor, ldsampler,
gaussian filter) at 16^2, maxDepth 4, seed 1, through both factories.

One pass (sample 0) runs in both packages outside any jit and is compared
lane by lane: the film positions, the eye primal / very_direct /
gradient pairs, the light image's splat positions and values, and the
t=1 image-space gradient pairs, at rtol 1e-5 on >= 99.9% of lanes and
1e-4 on all (film positions at atol 1e-5: a few ulps of 16 pixels), with
equal rays.  The render's primal + very_direct equals the port's BDPT
(the reference's test_gbdpt_specular.py identity).  The reference's
intersectors are pinned to the linear-MT matmul sweeps and torch's CPU
arithmetic flushes subnormals as XLA's does, on one thread
(tests/torch_parity.py)."""
import copy
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gradientdomain_mitsuba_tpu_torch.models.bdpt import BDPTracer
from gradientdomain_mitsuba_tpu_torch.models.gbdpt import GBDPTracer
from torch_parity import flush_subnormals, one_thread  # noqa: F401
from torch_parity import load, make_both, op_close

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAUS = os.path.join(ROOT, "data/scenes/caustics/caustics.xml")
SIZE, SPP, SEED = 16, 2, 1
pytestmark = pytest.mark.usefixtures("flush_subnormals", "one_thread")


@pytest.fixture(scope="module")
def gbdpt_pass():
    """One G-BDPT pass (sample 0, seed 1) of caustics 16^2, maxDepth 4 in
    both packages, each outside any jit, with its rays; and the port's
    scene and settings."""
    scene, st = load(CAUS, "gbdpt", size=SIZE, spp=SPP, depth=4)
    rt, rs, pt, ts = make_both(scene, st)
    assert type(pt) is GBDPTracer and pt.any_specular and rt.any_specular
    rt.ray_tally = []
    ref = [np.asarray(a) for a in rt.trace_pass(rs, SEED, jnp.uint32(0))]
    ref_rays = int(sum(float(r) for r in rt.ray_tally))
    rt.ray_tally = None
    pt.ray_tally = torch.zeros((), dtype=torch.int64)
    got = [a.numpy() for a in pt.trace_pass(ts, SEED, 0)]
    got_rays = int(pt.ray_tally)
    pt.ray_tally = None
    return dict(ref=ref, got=got, ref_rays=ref_rays, got_rays=got_rays,
                st=st, ts=ts)


GBDPT_OUT = ("pos", "primal", "very_direct", "grad", "light_pos",
             "light_val", "t1_pos", "t1_grad")


@pytest.mark.parametrize("i,name", list(enumerate(GBDPT_OUT)))
def test_gbdpt_pass_matches_reference(gbdpt_pass, i, name):
    """Each output of trace_pass lane by lane: film positions, the eye
    primal / very_direct / gradient pairs, the light image's splat
    positions and values, and the t=1 image-space gradient pairs."""
    got, ref = gbdpt_pass["got"][i], gbdpt_pass["ref"][i]
    assert got.shape == ref.shape and np.isfinite(got).all()
    if name != "very_direct":
        assert np.abs(ref).max() > 0
    # film positions are pixels in [0, 16): a few ulps of 16 absolute
    op_close(got, ref, name, atol=1e-5 if name.endswith("pos") else 1e-6)


def test_gbdpt_ray_counts_equal(gbdpt_pass):
    assert gbdpt_pass["got_rays"] == gbdpt_pass["ref_rays"] > 0


def test_gbdpt_primal_equals_bdpt(gbdpt_pass):
    """primal (incl. the light image) + very_direct == the port's BDPT at
    the same seed: the replay does not perturb the primal estimator (the
    reference's test_gbdpt_specular.py identity, rtol 3e-4 / atol
    3e-5)."""
    ts, st = gbdpt_pass["ts"], gbdpt_pass["st"]
    out = GBDPTracer(ts, copy.deepcopy(st)).render(ts, seed=SEED, spp=SPP)
    img = BDPTracer(ts, copy.deepcopy(st)).render(ts, seed=SEED, spp=SPP)
    comb = (out["primal"] + out["very_direct"]).numpy()
    assert np.isfinite(comb).all() and comb.mean() > 1e-3
    np.testing.assert_allclose(comb, img.numpy(), rtol=3e-4, atol=3e-5)
    assert np.abs(out["dx"].numpy()).max() > 0
