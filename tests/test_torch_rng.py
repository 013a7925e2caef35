"""Port counter RNG: bit-exact with the reference (G-PT's offset paths
replay base-path numbers through it, so the same counters must give the
same bits in both packages)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gradientdomain_mitsuba_tpu.core import rng as ref_rng
from gradientdomain_mitsuba_tpu_torch.core import rng as port_rng

DA = port_rng.DimAllocator


def _counters(seed=0, n=4096):
    rs = np.random.RandomState(seed)
    pix = rs.randint(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    smp = rs.randint(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    # values within 2^16 of 2^32 (and the extremes) in every counter
    top = (np.uint64(2 ** 32) - rs.randint(1, 2 ** 16, n // 4)).astype(
        np.uint32)
    pix[: n // 4] = top
    smp[n // 4: n // 2] = top
    pix[-2:] = [0, 2 ** 32 - 1]
    smp[-2:] = [2 ** 32 - 1, 0]
    return pix, smp


def _t(a):
    return torch.from_numpy(a.astype(np.int64))


@pytest.mark.parametrize("seed", [0, 3, 2 ** 32 - 1])
@pytest.mark.parametrize("dim", [
    DA.PIXEL_JITTER, DA.APERTURE,
    DA.bounce_dim(0, DA.D_LIGHT_SELECT), DA.bounce_dim(3, DA.D_BSDF_UV),
    DA.bounce_dim(39, DA.D_RR)])
def test_random_bits_and_uniforms_bitwise(seed, dim):
    pix, smp = _counters(seed % 1000)
    ref_bits = np.asarray(ref_rng.random_bits(seed, pix, smp, dim))
    got_bits = port_rng.random_bits(seed, _t(pix), _t(smp), dim).numpy()
    np.testing.assert_array_equal(got_bits, ref_bits.astype(np.int64))

    ref_u = np.asarray(ref_rng.uniform_float(seed, pix, smp, dim))
    got_u = port_rng.uniform_float(seed, _t(pix), _t(smp), dim).numpy()
    assert got_u.dtype == np.float32
    np.testing.assert_array_equal(got_u.view(np.uint32),
                                  ref_u.view(np.uint32))

    ref_2 = np.asarray(ref_rng.uniform_2d(seed, pix, smp, dim))
    got_2 = port_rng.uniform_2d(seed, _t(pix), _t(smp), dim).numpy()
    np.testing.assert_array_equal(got_2.view(np.uint32),
                                  ref_2.view(np.uint32))


@pytest.mark.parametrize("seed", [0, 2 ** 32 - 1])
def test_lane_uniform_2d_bitwise(seed):
    """The per-lane stream of the tracking loops draws the reference's
    uniform_2d bits."""
    pix, smp = _counters(seed % 1000)
    u = port_rng.lane_uniform_2d(seed, _t(pix), _t(smp))
    for dim in (0, 32768 + 126, 61440 + 2 * 63):
        ref = np.asarray(ref_rng.uniform_2d(seed, pix, smp, dim))
        np.testing.assert_array_equal(u(dim).numpy().view(np.uint32),
                                      ref.view(np.uint32))


def test_tensor_dims_and_seeds_bitwise():
    """Per-lane dims and seeds (broadcast counters) agree too."""
    pix, smp = _counters(11, 1024)
    rs = np.random.RandomState(1)
    dims = rs.randint(0, 400, 1024).astype(np.uint32)
    seeds = rs.randint(0, 2 ** 32, 1024, dtype=np.uint64).astype(np.uint32)
    ref = np.asarray(ref_rng.random_bits(jnp.asarray(seeds), pix, smp,
                                         jnp.asarray(dims)))
    got = port_rng.random_bits(_t(seeds), _t(pix), _t(smp), _t(dims))
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))


def test_dim_layout_matches_reference():
    R = ref_rng.DimAllocator
    for name in ("PIXEL_JITTER", "APERTURE", "TIME", "NUM_CAMERA_DIMS",
                 "D_LIGHT_SELECT", "D_LIGHT_UV", "D_BSDF_COMPONENT",
                 "D_BSDF_UV", "D_RR", "NUM_BOUNCE_DIMS"):
        assert getattr(R, name) == getattr(DA, name), name
    for b in range(41):
        assert R.bounce_dim(b, R.D_RR) == DA.bounce_dim(b, DA.D_RR)


def test_near_one_rounds_like_reference():
    """bits close to 2^32 round to 1.0 in the int->f32 conversion, as in
    the reference (kept, not 'fixed')."""
    top = np.arange(2 ** 32 - 200, 2 ** 32, dtype=np.uint64)
    got = (_t(top.astype(np.uint32)).to(torch.float32) *
           port_rng._INV_2_32).numpy()
    ref = np.asarray(jnp.asarray(top.astype(np.uint32)).astype(jnp.float32)
                     * ref_rng._INV_2_32)
    np.testing.assert_array_equal(got, ref)
    assert (got == 1.0).any()


@pytest.mark.parametrize("sampler", ["ldsampler", "halton",
                                     "independent"])
@pytest.mark.parametrize("spp", [1, 4, 12])
@pytest.mark.parametrize("dim", [DA.PIXEL_JITTER,
                                 DA.bounce_dim(1, DA.D_BSDF_UV),
                                 4096 + 8 + 5, 16384 + 3])
def test_stratified_samplers_bitwise(sampler, spp, dim):
    """make_sampler's (u1, u2) pair draws the reference's bits for every
    sampler family: LHS + the scrambled (0,2)-sequence (ldsampler,
    power-of-two spp and the rotation of other spp), the rotated Halton
    radical inverse, and the independent sampler (spp 1 falls back to it
    for every family).  Sample indices run over a few multiples of spp
    and over the full uint32 range."""
    ru1, ru2 = ref_rng.make_sampler(sampler, spp)
    pu1, pu2 = port_rng.make_sampler(sampler, spp)
    for seed in (0, 2 ** 32 - 1):
        pix, smp = _counters(seed % 1000, 2048)
        smp[: 1024] %= 4 * spp
        for ref_f, port_f in ((ru1, pu1), (ru2, pu2)):
            ref = np.asarray(ref_f(seed, pix, smp, dim))
            got = port_f(seed, _t(pix), _t(smp), dim).numpy()
            assert got.dtype == np.float32 and got.shape == ref.shape
            np.testing.assert_array_equal(got.view(np.uint32),
                                          ref.view(np.uint32))
    if spp == 1 or sampler == "independent":
        assert pu1 is port_rng.uniform_float
        assert pu2 is port_rng.uniform_2d


def test_sampler_integer_stages_bitwise():
    """The integer stages of the (0,2)-sequence (bit reversal, the second
    Sobol dimension) equal the reference's on the full uint32 range."""
    pix, smp = _counters(5, 4096)
    for ref_f, port_f in ((ref_rng._reverse_bits32, port_rng._reverse_bits32),
                          (ref_rng._sobol2_bits, port_rng._sobol2_bits)):
        ref = np.asarray(ref_f(jnp.asarray(smp)))
        got = port_f(_t(smp)).numpy()
        np.testing.assert_array_equal(got, ref.astype(np.int64))
