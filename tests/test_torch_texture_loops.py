"""Textured materials in the port's volumetric path tracer and
irradiance cache (ROADMAP step G2b-2) against the reference on the CPU.

tools/cloth_board.py's board, lifted off the axis planes, in the two
subsets of torch_parity (BOARD_CLOTH: woven cloth, the mask's textured
opacity, vertexcolors and wireframe; BOARD_WRAPPED: the bump and normal
maps and the blendbsdf's textured weight; both over the EWA floor) at
16x12, 2 spp, maxDepth 3, through both factories with the reference
pinned to the matmul sweeps: volpath and irrcache on the cloth subset
(the wrapped one runs through VPL and PSSMLT, in
test_torch_texture_photons.py and test_torch_texture_chains.py: a
reference compile on it costs ~15-40 s).
Rays counted in both packages are equal; images agree at rtol 1e-3 /
atol 1e-4 on >= 99% of pixels, means within 1e-4 relative.
"""
import pytest

from torch_parity import (BOARD_BITS, BOARD_CLOTH, board_renders,
                          check_board_image, flush_subnormals,
                          one_thread)  # noqa: F401

CASES = {
    "volpath-cloth": ("volpath", BOARD_CLOTH, None),
    "irrcache-cloth": ("irrcache", BOARD_CLOTH, {"gatherSamples": 16}),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def renders(request, tmp_path_factory, flush_subnormals, one_thread):
    family, labels, props = CASES[request.param]
    r = board_renders(tmp_path_factory.mktemp(request.param), family,
                      labels, props)
    r["labels"] = labels
    return r


def test_board_subset_holds_its_texture_bits(renders):
    assert renders["bits"] == BOARD_BITS[renders["labels"]]


def test_rays_equal(renders):
    assert renders["port_rays"] == renders["ref_rays"] > 0


def test_image_matches_reference(renders):
    check_board_image(renders)
