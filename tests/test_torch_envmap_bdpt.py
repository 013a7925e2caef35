"""BDPT and G-BDPT + L1 on envmap.xml (BASELINE config #4) in the port
against the reference on the CPU: the envmap through the eye walk's
environment NEE family (aux_nee: the escape MIS-weighted against
environment NEE, one NEE draw a non-delta eye vertex) and through
G-BDPT's aux-only G-PT pass with its gradients (aux_via_gpt); the scene
has no area light, so the light subpaths carry nothing and the thin
lens's rays feed the eye walk.

16^2, 2 spp, maxDepth 3, seed 1, through both factories with the
reference's intersectors pinned to the linear-MT matmul sweeps and
torch on one thread with subnormals flushed (tests/torch_parity.py).
Images and buffers at rtol 1e-3 / atol 1e-4 on >= 99% of pixels with
means within 1e-3 relative, rays equal, the L1 final by objective (1%)
and mean (5e-3), and the port's G-BDPT primal + very_direct equal to
its BDPT image.  The lights board: test_torch_lights_bdpt.py."""
import os

import pytest

from torch_parity import flush_subnormals, one_thread  # noqa: F401
from torch_parity import (GBDPT_BUFS, assert_l1_final_close, bidir_renders,
                          check_bdpt, check_gbdpt_buffer,
                          check_gbdpt_primal_is_bdpt)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = os.path.join(ROOT, "data/scenes/envmap/envmap.xml")
SIZE = 16
pytestmark = pytest.mark.usefixtures("flush_subnormals", "one_thread")


@pytest.fixture(scope="module")
def renders():
    return bidir_renders(ENV, SIZE, spp=2, depth=3, seed=1)


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
