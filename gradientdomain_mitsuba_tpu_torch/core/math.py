"""Vector math on [..., 3] tensors, plus the numpy helpers the scene
loader uses.

Counterpart of gradientdomain_mitsuba_tpu/core/math.py (Mitsuba's
Point/Vector/Normal/Frame/Transform headers).  A "vector" is any tensor
whose last axis is 3; every function broadcasts over leading axes.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def dot(a, b, keepdims: bool = False):
    return torch.sum(a * b, dim=-1, keepdim=keepdims)


def cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def length(v, keepdims: bool = False):
    return torch.sqrt(torch.clamp_min(dot(v, v, keepdims=keepdims), 0.0))


def squared_length(v, keepdims: bool = False):
    return dot(v, v, keepdims=keepdims)


def normalize(v):
    return v / torch.clamp_min(length(v, keepdims=True), 1e-20)


def build_frame(n):
    """Branchless orthonormal basis from unit normal n (Duff et al. 2017).
    Returns (s, t) so that (s, t, n) is right-handed orthonormal
    (mitsuba Frame(n), include/mitsuba/core/frame.h)."""
    z = n[..., 2]
    sign = torch.where(z >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + z)
    b = n[..., 0] * n[..., 1] * a
    s = torch.stack(
        [1.0 + sign * n[..., 0] * n[..., 0] * a, sign * b, -sign * n[..., 0]],
        dim=-1)
    t = torch.stack([b, sign + n[..., 1] * n[..., 1] * a, -n[..., 1]],
                    dim=-1)
    return s, t


def to_local(v, s, t, n):
    """World direction -> local shading frame coordinates."""
    return torch.stack([dot(v, s), dot(v, t), dot(v, n)], dim=-1)


def to_world(v, s, t, n):
    """Local shading frame coordinates -> world direction."""
    return v[..., 0:1] * s + v[..., 1:2] * t + v[..., 2:3] * n


def spherical_direction(theta, phi):
    st, ct = torch.sin(theta), torch.cos(theta)
    sp, cp = torch.sin(phi), torch.cos(phi)
    return torch.stack([st * cp, st * sp, ct], dim=-1)


def spherical_coordinates(d):
    """Unit vector -> (theta, phi), phi in [0, 2pi)."""
    theta = torch.arccos(torch.clamp(d[..., 2], -1.0, 1.0))
    phi = torch.atan2(d[..., 1], d[..., 0])
    phi = torch.where(phi < 0.0, phi + 2.0 * math.pi, phi)
    return theta, phi


def transform_point(m, p):
    """Apply 4x4 matrix m to points p [..., 3]."""
    r = p @ m[:3, :3].T + m[:3, 3]
    w = p @ m[3, :3] + m[3, 3]
    return r / w[..., None]


def transform_vector(m, v):
    return v @ m[:3, :3].T


# ---------------------------------------------------------------------------
# host-side (numpy, float64) transforms for the scene loader
# ---------------------------------------------------------------------------

def np_look_at(origin, target, up):
    """Mitsuba <lookat> semantics: camera-to-world with +z toward target,
    +x right, +y up (reference: Transform::lookAt, src/libcore/transform.cpp)."""
    origin = np.asarray(origin, np.float64)
    target = np.asarray(target, np.float64)
    up = np.asarray(up, np.float64)
    d = target - origin
    d = d / np.linalg.norm(d)
    left = np.cross(up / np.linalg.norm(up), d)
    left = left / np.linalg.norm(left)
    new_up = np.cross(d, left)
    m = np.eye(4)
    # Mitsuba: x axis = "left" column so that the frame is right-handed with
    # +z forward; matches Transform::lookAt which uses (left, up, dir).
    m[:3, 0] = left
    m[:3, 1] = new_up
    m[:3, 2] = d
    m[:3, 3] = origin
    return m


def np_translate(v):
    m = np.eye(4)
    m[:3, 3] = v
    return m


def np_scale(v):
    m = np.eye(4)
    m[0, 0], m[1, 1], m[2, 2] = v[0], v[1], v[2]
    return m


def np_rotate(axis, angle_deg):
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    a = np.deg2rad(angle_deg)
    c, s = np.cos(a), np.sin(a)
    x, y, z = axis
    r = np.array([
        [c + x * x * (1 - c), x * y * (1 - c) - z * s, x * z * (1 - c) + y * s],
        [y * x * (1 - c) + z * s, c + y * y * (1 - c), y * z * (1 - c) - x * s],
        [z * x * (1 - c) - y * s, z * y * (1 - c) + x * s, c + z * z * (1 - c)],
    ])
    m = np.eye(4)
    m[:3, :3] = r
    return m


def np_perspective(fov_deg, near, far):
    """Mitsuba perspective projection (x fov by default)."""
    recip = 1.0 / (far - near)
    cot = 1.0 / np.tan(np.deg2rad(fov_deg) / 2.0)
    m = np.array([
        [cot, 0, 0, 0],
        [0, cot, 0, 0],
        [0, 0, far * recip, -near * far * recip],
        [0, 0, 1, 0],
    ])
    return m


# the Cephes constants of XLA's float32 exp
_F32_TINY = 2.0 ** -126
_LOG2E = 1.44269504088896341
_EXP_C1, _EXP_C2 = 0.693359375, -2.12194440e-4
_EXP_P = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
          4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1)


def _f32(v):
    """A Python float rounded to float32."""
    return float(torch.tensor(v, dtype=torch.float32))


def _fma(a, b, c):
    """float32 a * b + c with one rounding of the sum: the product of two
    float32s is exact in float64, so this is the fused multiply-add up to
    double-rounding ties."""
    return (a.double() * b + c).float()


def exp_f32(x):
    """float32 exp as XLA's CPU backend computes it: the Cephes
    reduction x = a + n log 2 and degree-5 polynomial, every multiply-add
    fused.  torch's exp differs from it in the last bit on some inputs;
    where that bit is amplified, the port takes this one so that it is
    the reference's bits: the chains' small steps (models/pssmlt.py) and
    the hk slab's transmission, a difference of two exps that cancels
    where the outgoing cosine nears the incoming one (ops/bsdf.py)."""
    x = torch.clamp(x, _f32(-87.8), _f32(88.8))
    n = torch.floor(_fma(x, _f32(_LOG2E), 0.5))
    n = torch.clamp(n, -127.0, 127.0)
    x = _fma(n, -_f32(_EXP_C1), x)
    x = _fma(n, -_f32(_EXP_C2), x)
    z = _fma(x, _f32(_EXP_P[0]), _f32(_EXP_P[1]))
    for p in _EXP_P[2:]:
        z = _fma(z, x.double(), _f32(p))
    z = _fma(z, (x * x).double(), x.double())
    z = 1.0 + z
    # 2^n, 0 at n = -127 (the reference's flush of the smallest range)
    pow2 = torch.where(n > -127.0, torch.exp2(n), 0.0)
    out = z * pow2
    # denormal results flush to zero, as there
    return torch.where(out < _F32_TINY, 0.0, out)
