"""The independent sampler's counter RNG, for the plain reference.

Every random number is a pure function u = U(seed, pixel, sample, dim):
a lowbias32-style hash of the four counters (uint32 lanes held in int64),
mapped to [0, 1] by one multiplication.  This is the published stream of
the renderer's `independent` sampler; the reference draws the same
numbers as the program, so a lane's path can be replayed lane by lane.
"""
from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
_M1 = 0x7FEB352D
_M2 = 0x846CA68B
_GOLDEN = 0x9E3779B9
_INV_2_32 = 2.3283064365386963e-10

# the dimension layout: camera dims first, then 8 per bounce
PIXEL_JITTER = 0
NUM_CAMERA_DIMS = 8
NUM_BOUNCE_DIMS = 8
D_LIGHT_SELECT, D_LIGHT_UV, D_BSDF_COMPONENT, D_BSDF_UV, D_RR = 0, 1, 3, 4, 6


def bounce_dim(bounce, which):
    return NUM_CAMERA_DIMS + bounce * NUM_BOUNCE_DIMS + which


def _u32(x):
    if torch.is_tensor(x):
        return x.to(torch.int64) & MASK
    return int(x) & MASK


def _mix(x):
    x = x ^ (x >> 16)
    x = (x * _M1) & MASK
    x = x ^ (x >> 15)
    x = (x * _M2) & MASK
    return x ^ (x >> 16)


def _combine(a, b):
    mb = _mix(b)
    return _mix(a ^ ((mb + (_GOLDEN + (a << 6) + (a >> 2))) & MASK))


def uniform(seed, pixel, sample, dim, dtype=torch.float32):
    """u in [0, 1] for integer tensors pixel, sample and ints seed, dim."""
    h = _mix((_u32(dim) + _GOLDEN) & MASK)
    h = _combine(h, _u32(sample))
    h = _combine(h, _u32(pixel))
    h = _combine(h, _u32(seed))
    return (h.to(torch.float32) * _INV_2_32).to(dtype)


def uniform2(seed, pixel, sample, dim, dtype=torch.float32):
    return torch.stack([uniform(seed, pixel, sample, dim, dtype),
                        uniform(seed, pixel, sample, dim + 1, dtype)], -1)
