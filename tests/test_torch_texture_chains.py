"""Textured materials in the port's primary-sample-space chains (ROADMAP
step G2b-2): PSSMLT and ERPT share _PSSPathTracer, a plain PathTracer in
the reference, so their chains shade textures through trace_rays, the
first bounce at the primary hits' footprint.

tools/cloth_board.py's board, lifted off the axis planes, in torch_parity's
cloth subset (woven cloth through the hits' payload, the mask's textured
opacity, vertexcolors, wireframe, the EWA floor) at 16x12, 2 mutations a
pixel, maxDepth 3, through both factories with the reference pinned to
the matmul sweeps and its chain loops unrolled
(torch_parity.render_chains): PSSMLT (64 chains) and ERPT (64 chains,
chainLength 2).  The wrapped subset's bits reach trace_rays through the
path tracer's own tests (test_torch_texture_rest.py renders the whole
board); a reference chain compile on it costs ~40 s.  Every acceptance
decision is equal, rays counted in both packages are equal, images
agree at rtol 1e-3 / atol 1e-4 on >= 99% of pixels, means within 1e-4
relative.
"""
import numpy as np
import pytest

from torch_parity import (BOARD_BITS, BOARD_CLOTH, board_renders,
                          check_board_image, flush_subnormals,
                          one_thread)  # noqa: F401

CASES = {
    "pssmlt-cloth": ("pssmlt", BOARD_CLOTH,
                     {"chains": 64, "luminanceSamples": 1024}),
    "erpt-cloth": ("erpt", BOARD_CLOTH,
                   {"chains": 64, "chainLength": 2,
                    "luminanceSamples": 256}),
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


def test_acceptance_decisions_equal(renders):
    ref, got = renders["ref_takes"], renders["port_takes"]
    assert ref.shape == got.shape and ref.shape[0] >= 4
    assert 0 < ref.mean() < 1          # some accepted, some rejected
    np.testing.assert_array_equal(got, ref)


def test_rays_equal(renders):
    assert renders["port_rays"] == renders["ref_rays"] > 0


def test_image_matches_reference(renders):
    check_board_image(renders)
