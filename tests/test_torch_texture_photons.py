"""Textured materials in the port's photon-mapping family (ROADMAP step
G2b-2): SPPM (models/sppm.py: the visible points and the photon walk
read the hits' barycentric payload, the gather does not, as in the
reference) and VPL (models/vpl.py: its three lookups read none) against
the reference on the CPU.

tools/cloth_board.py's board, lifted off the axis planes (a photon's
last bit picks its hash cell on a plane), in torch_parity's two subsets
at 16x12, 2 spp, maxDepth 3, through both factories with the reference
pinned to the matmul sweeps: SPPM (4,096 photons) on the cloth subset,
VPL (64 walks, chunks of 32) on both.  Rays counted in both packages are
equal; images agree at rtol 1e-3 / atol 1e-4 on >= 99% of pixels, means
within 1e-4 relative.
"""
import pytest

from torch_parity import (BOARD_BITS, BOARD_CLOTH, BOARD_WRAPPED,
                          board_renders, check_board_image,
                          flush_subnormals, one_thread)  # noqa: F401

VPL = {"vplCount": 64, "vplChunk": 32}
CASES = {
    "sppm-cloth": ("sppm", BOARD_CLOTH, {"photonCount": 4096}),
    "vpl-cloth": ("vpl", BOARD_CLOTH, VPL),
    "vpl-wrapped": ("vpl", BOARD_WRAPPED, VPL),
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
