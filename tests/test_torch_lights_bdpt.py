"""BDPT and G-BDPT + L1 on the lights board (tools/lights_board.py) in
the port against the reference on the CPU: the eye walk's environment
/ delta-light NEE family (aux_nee) beside the area-light strategies,
G-BDPT's aux-only G-PT pass (aux_via_gpt) with its gradients, and the
light image, on an open box under an area, a point, a spot and a
directional light and a constant environment, with a roughconductor and
a dielectric sphere.

16^2, 2 spp, maxDepth 3, seed 1, through both factories with the
reference's intersectors pinned to the linear-MT matmul sweeps and
torch on one thread with subnormals flushed (tests/torch_parity.py).
Images and buffers at rtol 1e-3 / atol 1e-4 on >= 99% of pixels with
means within 1e-3 relative, rays equal, the L1 final by objective (1%)
and mean (5e-3), and the port's G-BDPT primal + very_direct equal to
its BDPT image.  envmap.xml: test_torch_envmap_bdpt.py."""
import importlib.util
import os

import pytest

from torch_parity import flush_subnormals, one_thread  # noqa: F401
from torch_parity import (GBDPT_BUFS, assert_l1_final_close, bidir_renders,
                          check_bdpt, check_gbdpt_buffer,
                          check_gbdpt_primal_is_bdpt)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 16
pytestmark = pytest.mark.usefixtures("flush_subnormals", "one_thread")


def lights_board():
    """tools/lights_board.py, loaded from its path (tools/ is not a
    package)."""
    spec = importlib.util.spec_from_file_location(
        "lights_board", os.path.join(ROOT, "tools/lights_board.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def renders(tmp_path_factory):
    path = lights_board().write_board(str(tmp_path_factory.mktemp("lb")))
    return bidir_renders(path, SIZE, spp=2, depth=3, seed=1)


def test_bdpt_matches_reference(renders):
    check_bdpt(renders, SIZE, lit=0.8)


@pytest.mark.parametrize("name", GBDPT_BUFS)
def test_gbdpt_buffers_match_reference(renders, name):
    check_gbdpt_buffer(renders, name, SIZE)


def test_gbdpt_ray_counts_equal(renders):
    g = renders["gbdpt"]
    assert g["port"]["rays"] == g["ref"]["rays"] > 0


def test_gbdpt_l1_final_matches_reference(renders):
    assert_l1_final_close(renders["gbdpt"]["port"]["L1"],
                          renders["gbdpt"]["ref"])


def test_gbdpt_primal_equals_bdpt(renders):
    check_gbdpt_primal_is_bdpt(renders)


def test_remap0_treats_subnormals_as_zero():
    """The MIS ratios' zero remap: XLA's CPU arithmetic reads a subnormal
    density as zero, so the reference remaps it to 1 as it remaps 0; the
    port does so on any device (without it, a subnormal density in a
    G-BDPT t=1 view turned a technique sum into NaN on envmap.xml)."""
    import jax.numpy as jnp
    import numpy as np
    import torch
    from gradientdomain_mitsuba_tpu.models import bdpt as ref_bdpt
    from gradientdomain_mitsuba_tpu_torch.models import bdpt
    x = np.array([0.0, 1e-45, 1e-40, 1.1e-38, 1.1754944e-38, 2e-38, 0.5,
                  -1.0, 3e38], np.float32)
    got = bdpt._remap0(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(ref_bdpt._remap0(
        jnp.asarray(x))))
    assert (got[:4] == 1.0).all() and got[4] == x[4]
