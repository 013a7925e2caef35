"""Counter-based stateless RNG, bit-exact with the reference.

Counterpart of gradientdomain_mitsuba_tpu/core/rng.py.  Every random
number is a pure function u = U(seed, pixel_id, sample_idx, dim), so the
G-PT offset paths replay the base path's numbers by construction.  The
port must give the SAME bits as the reference for the same counters.

torch's uint32 arithmetic is partial, so the uint32 lanes are emulated in
int64 holding values in [0, 2^32): every operation that can leave that
range is masked with 0xFFFFFFFF.  A product of two such values can
overflow int64, but it wraps modulo 2^64, so its low 32 bits (all the
mask keeps) are still the uint32 product.
"""
from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
_M1 = 0x7FEB352D
_M2 = 0x846CA68B
_GOLDEN = 0x9E3779B9
# 1/2^32 as float32: maps uint32 -> [0, 1)
_INV_2_32 = 2.3283064365386963e-10


def _u32(x):
    """Python int or integer tensor -> its uint32 value (two's complement
    wrap, as jnp.asarray(x, uint32) does): an int64 tensor in [0, 2^32),
    or a Python int, which the operations below take as a scalar without
    copying it to the device."""
    if torch.is_tensor(x):
        return x.to(torch.int64) & MASK
    return int(x) & MASK


def _mix(x):
    """lowbias32-style avalanche of uint32 lanes (int64 emulation; also
    exact on Python ints)."""
    x = x ^ (x >> 16)
    x = (x * _M1) & MASK
    x = x ^ (x >> 15)
    x = (x * _M2) & MASK
    x = x ^ (x >> 16)
    return x


def _combine_mixed(a, mixed_b):
    """hash_combine(a, b) given mixed_b = _mix(b)."""
    return _mix(a ^ ((mixed_b + (_GOLDEN + (a << 6) + (a >> 2))) & MASK))


def hash_combine(a, b):
    """Combine two uint32 streams (order-sensitive)."""
    return _combine_mixed(a, _mix(b))


def random_bits(seed, pixel_id, sample_idx, dim):
    """uint32 random bits (as int64 in [0, 2^32)), pure function of the 4
    counters (ints or broadcastable integer tensors)."""
    h = _mix((_u32(dim) + _GOLDEN) & MASK)
    h = hash_combine(h, _u32(sample_idx))
    h = hash_combine(h, _u32(pixel_id))
    h = hash_combine(h, _u32(seed))
    return h


def lane_uniform_2d(seed, pixel_id, sample_idx):
    """dim -> uniform_2d(seed, pixel_id, sample_idx, dim), the same bits,
    with the lanes' counter hashes mixed once: for loops that draw many
    dims from the same lanes (the media tracking steps)."""
    m_sample, m_pixel, m_seed = (_mix(_u32(c))
                                 for c in (sample_idx, pixel_id, seed))

    def u(dim):
        # both dims through the sample combine, then together
        h = torch.stack([_combine_mixed(_mix((_u32(d) + _GOLDEN) & MASK),
                                        m_sample) for d in (dim, dim + 1)],
                        dim=-1)
        h = _combine_mixed(_combine_mixed(h, m_pixel[..., None]),
                           m_seed if isinstance(m_seed, int)
                           else m_seed[..., None])
        return h.to(torch.float32) * _INV_2_32
    return u


def uniform_float(seed, pixel_id, sample_idx, dim):
    """f32 in [0, 1].  As in the reference, bits close to 2^32 round to
    1.0 in the int -> f32 conversion."""
    bits = random_bits(seed, pixel_id, sample_idx, dim)
    return bits.to(torch.float32) * _INV_2_32


def uniform_2d(seed, pixel_id, sample_idx, dim):
    """Two consecutive dims as a [..., 2] tensor."""
    u0 = uniform_float(seed, pixel_id, sample_idx, dim)
    u1 = uniform_float(seed, pixel_id, sample_idx, dim + 1)
    return torch.stack([u0, u1], dim=-1)


# the reference's stratified samplers (lhs / (0,2)-sequence / halton)
_UNPORTED_SAMPLERS = ("stratified", "ldsampler", "sobol", "halton",
                      "hammersley")


def make_sampler(sampler: str, spp: int):
    """Returns (u1, u2) draw functions for the configured sampler type.
    Only the independent sampler is ported; the reference's stratified
    samplers raise (ROADMAP Queue 1 item 2).  Unknown types fall back to
    independent, as in the reference."""
    if sampler in _UNPORTED_SAMPLERS and spp > 1:
        raise NotImplementedError(
            f"sampler {sampler!r}: ROADMAP Queue 1 item 2")
    return uniform_float, uniform_2d


class DimAllocator:
    """Static bookkeeping of the per-bounce random dimension layout
    (same layout as the reference, so the same counters drive both)."""
    # camera-sample dims (before the bounce loop)
    PIXEL_JITTER = 0      # 2 dims
    APERTURE = 2          # 2 dims (thinlens)
    TIME = 4              # 1 dim (reserved)
    NUM_CAMERA_DIMS = 8   # padded

    # per-bounce dims
    D_LIGHT_SELECT = 0    # 1 dim: NEE emitter pick
    D_LIGHT_UV = 1        # 2 dims: position/direction on emitter
    D_BSDF_COMPONENT = 3  # 1 dim: lobe selection
    D_BSDF_UV = 4         # 2 dims: direction sampling
    D_RR = 6              # 1 dim: russian roulette
    NUM_BOUNCE_DIMS = 8   # padded to keep layout stable

    @classmethod
    def bounce_dim(cls, bounce, which):
        return cls.NUM_CAMERA_DIMS + bounce * cls.NUM_BOUNCE_DIMS + which
