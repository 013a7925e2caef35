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

make_sampler gives the reference's samplers: independent, LHS with a
scrambled (0,2)-sequence (ldsampler / stratified / sobol) and rotated
Halton (halton / hammersley), each a pure counter function too.
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


def mod1(x):
    """x mod 1.0 with the sign of the divisor (jnp's `x % 1.0`: the
    truncated remainder, plus 1 where it is negative)."""
    r = torch.fmod(x, 1.0)
    return torch.where(r < 0, r + 1.0, r)


def lhs_float(seed, pixel_id, sample_idx, dim, spp):
    """Latin-hypercube stratified sample: over spp samples each pixel
    covers every 1/spp stratum of every dimension once, with a
    per-(pixel, dim) stratum permutation (an odd-multiplier LCG step for
    power-of-two spp, a rotation otherwise)."""
    h = random_bits(_u32(seed) ^ 0x51A7E, pixel_id, 0, dim)
    i = _u32(sample_idx)
    if spp & (spp - 1) == 0:
        stratum = (((i * (h | 1)) & MASK) + (h >> 16)) & MASK
    else:
        stratum = (i + h) & MASK
    stratum = stratum % spp
    u = uniform_float(seed, pixel_id, sample_idx, dim)
    return (stratum.to(torch.float32) + u) / spp


def lhs_2d(seed, pixel_id, sample_idx, dim, spp):
    return torch.stack([lhs_float(seed, pixel_id, sample_idx, dim, spp),
                        lhs_float(seed, pixel_id, sample_idx, dim + 1, spp)],
                       dim=-1)


# --- scrambled (0,2)-sequence (ldsampler / sobol) --------------------------
# Direction numbers of the 2nd Sobol dimension (dim 1 is van der Corput,
# a bit reversal), XOR-scrambled per (pixel, dim).
_SOBOL2_DIRS = []
_v = 1 << 31
for _k in range(32):
    _SOBOL2_DIRS.append(_v)
    _v ^= _v >> 1
del _v, _k
# bit j of direction k, as the [32, 32] 0/1 matrix of the XOR sum below
_SOBOL2_BITS = [[(dk >> j) & 1 for j in range(32)] for dk in _SOBOL2_DIRS]


def _reverse_bits32(x):
    x = ((x & 0x55555555) << 1) | ((x & 0xAAAAAAAA) >> 1)
    x = ((x & 0x33333333) << 2) | ((x & 0xCCCCCCCC) >> 2)
    x = ((x & 0x0F0F0F0F) << 4) | ((x & 0xF0F0F0F0) >> 4)
    x = ((x & 0x00FF00FF) << 8) | ((x & 0xFF00FF00) >> 8)
    return ((x << 16) & MASK) | (x >> 16)


_CONSTANTS = {}


def _constant(name, values, dtype, device):
    """A small constant table on `device`, copied there once."""
    key = (name, str(device))
    t = _CONSTANTS.get(key)
    if t is None:
        t = _CONSTANTS[key] = torch.tensor(values, dtype=dtype,
                                           device=device)
    return t


def _sobol2_bits(n):
    """2nd Sobol dimension of index n (uint32 lanes as int64, or a Python
    int): the XOR of the directions of n's set bits, for lanes bit by bit
    as the parity of a 0/1 product (at most 32 ones a sum, exact in
    f32)."""
    n = _u32(n)
    if not torch.is_tensor(n):
        r = 0
        for k, dk in enumerate(_SOBOL2_DIRS):
            if (n >> k) & 1:
                r ^= dk
        return r
    shifts = _constant("shifts", list(range(32)), torch.int64, n.device)
    nbits = ((n[..., None] >> shifts) & 1).to(torch.float32)
    table = _constant("sobol2", _SOBOL2_BITS, torch.float32, n.device)
    ones = (nbits @ table).to(torch.int64) & 1        # [..., 32] parities
    return (ones << shifts).sum(-1)


def sobol02_2d(seed, pixel_id, sample_idx, dim, spp):
    """Scrambled (0,2)-sequence point pair: with power-of-two spp each
    pixel's spp points hit every base-2 elementary interval of area
    1/spp once."""
    i = _u32(sample_idx)
    b0 = _reverse_bits32(i)
    b1 = _sobol2_bits(i)
    s = _u32(seed) ^ 0x50B01
    u0 = (b0 ^ random_bits(s, pixel_id, 0, dim)).to(torch.float32)
    u1 = (b1 ^ random_bits(s, pixel_id, 0, dim + 1)).to(torch.float32)
    return torch.stack(torch.broadcast_tensors(u0, u1), dim=-1) * _INV_2_32


# --- scrambled Halton (halton / hammersley) ---------------------------------
# Prime-base radical inverse with a per-(pixel, dim) Cranley-Patterson
# rotation.
_PRIMES = (
    2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53, 59, 61,
    67, 71, 73, 79, 83, 89, 97, 101, 103, 107, 109, 113, 127, 131, 137,
    139, 149, 151, 157, 163, 167, 173, 179, 181, 191, 193, 197, 199,
    211, 223, 227, 229, 233, 239, 241, 251, 257, 263, 269, 271, 277,
    281, 283, 293, 307, 311)


def halton_float(seed, pixel_id, sample_idx, dim):
    """Rotated radical inverse in base prime[dim % 64] of sample_idx
    (24 digits, as the reference's fixed loop).  XLA's CPU compiler
    contracts the digit step res + d * f into one fused multiply-add;
    the step is formed in float64 here (the f32 product exact, the sum
    rounded once, then to f32), which gives the fused result up to
    double-rounding ties."""
    if torch.is_tensor(dim):
        base = _constant("primes", _PRIMES, torch.int64,
                         dim.device)[dim.long() % 64]
    else:
        base = _PRIMES[int(dim) % 64]
    n, pix = _u32(sample_idx), _u32(pixel_id)
    if not torch.is_tensor(n):
        # a fill on the lanes' device (no host-to-device copy)
        n = (torch.full_like(pix, n) if torch.is_tensor(pix)
             else torch.tensor(n))
    if torch.is_tensor(pix):
        n, pix = torch.broadcast_tensors(n, pix)
    # 1/base, an f32 division
    inv_b = 1.0 / (base.to(torch.float32) if torch.is_tensor(base) else
                   torch.tensor(float(base), dtype=torch.float32))
    if not torch.is_tensor(base):
        inv_b = float(inv_b)
    res = torch.zeros(n.shape, dtype=torch.float32, device=n.device)
    f = torch.full(n.shape, 1.0, dtype=torch.float32, device=n.device) * inv_b
    for _ in range(24):
        d = (n % base).to(torch.float32)
        res = (res.double() + d.double() * f.double()).float()
        f = f * inv_b
        n = n // base
    rot = random_bits(_u32(seed) ^ 0x8A170, pix, 0, dim).to(
        torch.float32) * _INV_2_32
    return mod1(res + rot)


def halton_2d(seed, pixel_id, sample_idx, dim):
    return torch.stack([halton_float(seed, pixel_id, sample_idx, dim),
                        halton_float(seed, pixel_id, sample_idx, dim + 1)],
                       dim=-1)


LDS_SAMPLERS = ("stratified", "ldsampler", "sobol")
HALTON_SAMPLERS = ("halton", "hammersley")


def make_sampler(sampler: str, spp: int):
    """Returns (u1, u2) draw functions for the configured sampler type:
    the scrambled Halton pair, LHS in 1D with the (0,2)-sequence in 2D,
    or the independent sampler (spp 1, and unknown types, as in the
    reference)."""
    if sampler in HALTON_SAMPLERS and spp > 1:
        return halton_float, halton_2d
    if sampler in LDS_SAMPLERS and spp > 1:
        def u1(seed, pixel_id, sample_idx, dim):
            return lhs_float(seed, pixel_id, sample_idx, dim, spp)

        def u2(seed, pixel_id, sample_idx, dim):
            return sobol02_2d(seed, pixel_id, sample_idx, dim, spp)
        return u1, u2
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
