"""Woven-cloth BSDF (Mitsuba's src/bsdfs/irawan.{h,cpp}, Irawan-Marschner,
"Specular Reflection from Woven Cloth", TOG 2012).

Counterpart of gradientdomain_mitsuba_tpu/ops/irawan.py, whose model is
its own closed-form redesign rather than irawan.cpp's integral over the
visible yarn arc (its docstring; PARITY.md); the port mirrors that
model, which is its contract:

- a tiled pattern grid assigns each uv cell to a warp or weft yarn
  segment (the weave tables and presets below, matched by the pattern
  file's name; no .wif file is read);
- each segment is a bent cylinder whose surface normal at the hit's own
  arc point centers a sphere-normalized von Mises lobe in microfacet
  form; twisted (staple) yarns tilt it across the yarn by psi;
- each segment's intensity is jittered by a counter hash of its absolute
  pattern cell (the reference's uint32 mix, emulated in int64 as
  core/rng.py does, bit for bit);
- sampling is cosine-weighted with eval / pdf weights (ops/bsdf.py).

The material row stores only (preset id, repeatU / V, kd, ks, eta); the
tables are small constants moved to the device at each call.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.rng import MASK, _mix

INV_PI = 1.0 / math.pi


def _twill(h, w, shift, floats):
    """Warp-faced twill: weft shows where (x - shift*y) mod w < floats."""
    g = np.zeros((h, w), np.int32)
    for y in range(h):
        for x in range(w):
            g[y, x] = 1 if (x - shift * y) % w < floats else 0
    return g


def _satin(n, counter):
    """n-harness satin: isolated weft interlacings at x = counter*y mod n."""
    g = np.zeros((n, n), np.int32)
    for y in range(n):
        g[y, (counter * y) % n] = 1
    return g


_PLAIN = np.array([[0, 1], [1, 0]], np.int32)

# name -> (grid, (umax_w, psi_w, kappa_w), (umax_f, psi_f, kappa_f),
#          kd, ks): _w the warp yarn, _f the weft yarn, angles in degrees;
# grid[y][x] 0 = warp segment (yarn along v), 1 = weft (yarn along u)
_PRESET_LIST = [
    ("plain", _PLAIN,
     (40.0, 35.0, 30.0), (40.0, 35.0, 30.0),
     (0.45, 0.43, 0.40), (0.25, 0.25, 0.25)),
    ("denim", _twill(4, 4, 1, 1),
     (38.0, 30.0, 35.0), (38.0, 30.0, 35.0),
     (0.07, 0.10, 0.25), (0.20, 0.20, 0.22)),
    ("gabardine", _twill(4, 4, 1, 2),
     (32.0, 30.0, 40.0), (32.0, 30.0, 40.0),
     (0.18, 0.16, 0.14), (0.30, 0.30, 0.30)),
    ("charmeuse", _satin(5, 2),
     (25.0, 0.0, 80.0), (30.0, 0.0, 60.0),
     (0.22, 0.20, 0.18), (0.50, 0.48, 0.45)),
    ("silk", _satin(5, 2),          # alias class for silk satins
     (25.0, 0.0, 80.0), (30.0, 0.0, 60.0),
     (0.22, 0.20, 0.18), (0.50, 0.48, 0.45)),
    ("polyester", _PLAIN,
     (35.0, 0.0, 60.0), (35.0, 0.0, 60.0),
     (0.30, 0.30, 0.32), (0.40, 0.40, 0.42)),
]

PRESET_IDS = {name: i for i, (name, *_) in enumerate(_PRESET_LIST)}

_P = len(_PRESET_LIST)
_GMAX = max(g.shape[0] for _, g, *_ in _PRESET_LIST)
GRID = np.zeros((_P, _GMAX, _GMAX), np.int32)
GRID_H = np.zeros(_P, np.int32)
GRID_W = np.zeros(_P, np.int32)
# per preset x {warp, weft}: [umax, psi (radians), kappa]
YARN = np.zeros((_P, 2, 3), np.float32)
PRESET_KD = np.zeros((_P, 3), np.float32)
PRESET_KS = np.zeros((_P, 3), np.float32)
for _i, (_n, _g, _wy, _fy, _kd, _ks) in enumerate(_PRESET_LIST):
    GRID[_i, :_g.shape[0], :_g.shape[1]] = _g
    GRID_H[_i], GRID_W[_i] = _g.shape
    YARN[_i, 0] = np.deg2rad([_wy[0], _wy[1], 0.0])
    YARN[_i, 0, 2] = _wy[2]
    YARN[_i, 1] = np.deg2rad([_fy[0], _fy[1], 0.0])
    YARN[_i, 1, 2] = _fy[2]
    PRESET_KD[_i] = _kd
    PRESET_KS[_i] = _ks


def preset_from_name(name: str) -> int:
    """The preset whose key the pattern file's name contains (plain if
    none): the reference ships the classes the plugin's documentation
    lists as built-in tables instead of reading .wif files."""
    low = name.lower()
    for key, pid in PRESET_IDS.items():
        if key in low:
            return pid
    return PRESET_IDS["plain"]


# per-segment intensity jitter amplitude (the reference's fixed stand-in
# for irawan.cpp's per-pattern "fineness" noise)
DELTA_X = 0.3

_H1, _H2, _H3 = 0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D


def _hash_cell(cx, cy, pid):
    """lowbias32-style mix of an integer cell (cx, cy) and a preset id ->
    uniform f32 in [0, 1), the reference's uint32 arithmetic bit for bit:
    each int32 is taken modulo 2^32 into int64 and every product is
    masked back to its low 32 bits."""
    def u32(x):
        return x.to(torch.int64) & MASK

    h = (((u32(cx) * _H1) & MASK) ^ ((u32(cy) * _H2) & MASK) ^
         ((u32(pid) * _H3) & MASK))
    return _mix(h).to(torch.float32) * (1.0 / 4294967296.0)


def _table(a, device):
    return torch.from_numpy(a).to(device)


def resolve_features(scene, mid, uv, bary):
    """The hit's yarn segment -> MatParams.cloth [N, 6]:
    [u_arc, v_twist, axis_cos, axis_sin, kappa, intensity].

    bary carries the shading-frame azimuth of dp/du in columns 4:6
    (ops/common.fill_intersection; the bidirectional tracers replay it
    from SubPath.aux); without it the yarn axis is the frame's s."""
    dev = uv.device
    row = scene.materials.packed[mid.long()]
    pid = row[..., 18].to(torch.int64)            # dist column
    rep_u = torch.clamp_min(row[..., 11], 1e-6)   # alpha column
    rep_v = torch.clamp_min(row[..., 21], 1e-6)   # alpha_v column

    gw = _table(GRID_W, dev)[pid].to(torch.float32)
    gh = _table(GRID_H, dev)[pid].to(torch.float32)
    x = uv[..., 0] * rep_u * gw
    y = uv[..., 1] * rep_v * gh
    cxa = torch.floor(x)
    cya = torch.floor(y)
    fx = x - cxa
    fy = y - cya
    cx = torch.remainder(cxa, gw).to(torch.int64)
    cy = torch.remainder(cya, gh).to(torch.int64)

    yarn = _table(GRID, dev)[pid, cy, cx].to(torch.int64)  # 0 warp, 1 weft
    prm = _table(YARN, dev)[pid, yarn]            # [N, 3]
    umax = prm[..., 0]
    psi = prm[..., 1]
    kappa = prm[..., 2]

    warp = yarn == 0
    along = torch.where(warp, fy, fx)
    across = torch.where(warp, fx, fy)
    u_arc = (2.0 * along - 1.0) * umax
    v_tw = (2.0 * across - 1.0) * psi

    # yarn axis in the shading frame: (c, s) = azimuth of dp/du; warp
    # yarns run along v (rotated +90 degrees)
    if bary is not None and bary.shape[-1] >= 6:
        c = bary[..., 4]
        s = bary[..., 5]
    else:
        c = torch.ones(uv.shape[:-1], device=dev)
        s = torch.zeros(uv.shape[:-1], device=dev)
    axis_c = torch.where(warp, -s, c)
    axis_s = torch.where(warp, c, s)

    inten = 1.0 + DELTA_X * (
        2.0 * _hash_cell(cxa.to(torch.int32), cya.to(torch.int32), pid)
        - 1.0)
    return torch.stack([u_arc, v_tw, axis_c, axis_s, kappa, inten], -1)


def eval_cloth(p, wi, wo):
    """f(wi, wo) * |cos_o| on IRAWAN lanes (local shading frame): kd /
    pi diffuse plus, where p.cloth is set, the segment's specular lobe

      n(u, v) = normalize(cos u cos v z + sin u t - sin v cos u b)

    (t the yarn axis, b the width axis, u the arc angle, v the twist),
    a von Mises NDF at n in microfacet form with dielectric Fresnel and
    no masking term."""
    from .bsdf import fresnel_dielectric
    kd = p.reflectance
    valid = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    diff = kd * INV_PI * torch.clamp_min(wo[..., 2], 0.0)[..., None]
    if p.cloth is None:
        return torch.where(valid[..., None], diff, 0.0)

    F = p.cloth
    cu = torch.cos(F[..., 0])
    su = torch.sin(F[..., 0])
    cv = torch.cos(F[..., 1])
    sv = torch.sin(F[..., 1])
    ac = F[..., 2]
    as_ = F[..., 3]
    kap = torch.clamp_min(F[..., 4], 1e-3)
    inten = F[..., 5]
    # n = cu cv z + su t - sv cu b, t = (ac, as, 0), b = (-as, ac, 0)
    nx = su * ac + sv * cu * as_
    ny = su * as_ - sv * cu * ac
    nz = cu * cv
    nlen = torch.sqrt(nx * nx + ny * ny + nz * nz)
    h = wi + wo
    hlen = torch.sqrt(torch.sum(h * h, -1))
    hdn = (h[..., 0] * nx + h[..., 1] * ny + h[..., 2] * nz) / \
        torch.clamp_min(hlen * nlen, 1e-12)
    hdwi = torch.sum(h * wi, -1) / torch.clamp_min(hlen, 1e-12)
    # sphere-normalized von Mises NDF at the segment normal
    D = kap * torch.exp(kap * (torch.clamp(hdn, -1.0, 1.0) - 1.0)) / \
        (2.0 * math.pi * (1.0 - torch.exp(-2.0 * kap)))
    Fr, _ = fresnel_dielectric(torch.clamp(torch.abs(hdwi), 0.0, 1.0),
                               p.eta[..., 0])
    spec = p.specular * (inten * Fr * D /
                         (4.0 * torch.clamp_min(wi[..., 2], 1e-4)))[..., None]
    return torch.where(valid[..., None], diff + spec, 0.0)
