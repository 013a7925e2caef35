"""BSDF sample/eval/pdf with a static dispatch over the scene's kinds.

Counterpart of gradientdomain_mitsuba_tpu/ops/bsdf.py.  Mitsuba
conventions: directions in the LOCAL shading frame (+z = shading
normal); wi points AWAY from the surface; eval() returns
f(wi,wo)*|cos(theta_o)|; pdf() is the solid-angle density of sample();
sample() returns (wo, weight = f*cos/pdf, pdf, is_delta, eta, valid).

`kinds` is the static set of material kinds in the scene (scene_kinds),
as in the reference.  Ported: the DIFFUSE lobe (src/bsdfs/diffuse.cpp)
and the NULL kind (src/bsdfs/null.cpp: an index-matched medium boundary,
a delta pass-through wo = -wi that eval and pdf mask out); any other
kind raises (ROADMAP Queue 1 item 12).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import warp
from ..core.spectrum import luminance
from ..scene.materials import (BLEND, COATING, CONDUCTOR, DIELECTRIC,
                               DIFFUSE, FLAG_TWOSIDED, NULL_BSDF,
                               ROUGH_CONDUCTOR, ROUGH_DIELECTRIC,
                               ROUGH_PLASTIC, THIN_DIELECTRIC, WARD)

INV_PI = warp.INV_PI
OPACITY = -2             # pseudo-kind: some row has a mask opacity
ROUGH_COAT = -3          # pseudo-kind: some COATING row has a rough layer
_ROUGH_LAYER_MIN = 1e-5  # coat_alpha above this = microfacet layer lobe
PORTED_KINDS = frozenset({DIFFUSE, NULL_BSDF})
# the kinds the gradient-domain and bidirectional tracers take: a null
# boundary is a delta vertex to them, and their delta vertices are
# ROADMAP Queue 1 item 12a
DIFFUSE_ONLY = frozenset({DIFFUSE})


class MatParams(NamedTuple):
    """Per-interaction material parameters (gathered from the table)."""
    kind: torch.Tensor          # [N] i32
    twosided: torch.Tensor      # [N] bool
    reflectance: torch.Tensor   # [N, 3]
    specular: torch.Tensor      # [N, 3]
    transmittance: torch.Tensor  # [N, 3]
    alpha: torch.Tensor         # [N]
    eta: torch.Tensor           # [N, 3]
    k: torch.Tensor             # [N, 3]
    dist: torch.Tensor          # [N] i32
    fdr_int: torch.Tensor       # [N]
    spec_weight: torch.Tensor   # [N] specular sampling weight
    alpha_v: torch.Tensor       # [N] second roughness
    opacity: torch.Tensor       # [N] mask wrapper opacity (1 = no mask)
    child0: torch.Tensor = None  # [N] i32 blend child row
    child1: torch.Tensor = None  # [N] i32
    blend_w: torch.Tensor = None  # [N] second-child weight


def gather_params(materials, mid) -> MatParams:
    """Material parameters for a batch of ids — ONE gather of the packed
    [M, 28] row table (Materials.packed); fields are slices of the row."""
    row = materials.packed[mid.long()]
    refl = row[..., 2:5]
    spec = row[..., 5:8]
    # Mitsuba's specularSamplingWeight: sAvg / (sAvg + dAvg) by luminance
    s_lum = luminance(spec)
    d_lum = luminance(refl)
    return MatParams(
        kind=row[..., 0].to(torch.int32),
        twosided=(row[..., 1].to(torch.int32) & FLAG_TWOSIDED) != 0,
        reflectance=refl, specular=spec,
        transmittance=row[..., 8:11],
        alpha=row[..., 11], eta=row[..., 12:15], k=row[..., 15:18],
        dist=row[..., 18].to(torch.int32), fdr_int=row[..., 19],
        spec_weight=s_lum / torch.clamp_min(s_lum + d_lum, 1e-9),
        alpha_v=row[..., 21], opacity=row[..., 22],
        child0=row[..., 24].to(torch.int32),
        child1=row[..., 25].to(torch.int32),
        blend_w=row[..., 26])


def _check_kinds(kinds):
    if kinds is None or not set(kinds) <= PORTED_KINDS:
        raise NotImplementedError(
            f"BSDF kinds {sorted(kinds) if kinds is not None else 'all'}: "
            "only diffuse and null are ported (ROADMAP Queue 1 item 12)")


def _diffuse_eval(p: MatParams, wi, wo):
    f = p.reflectance * INV_PI * torch.clamp_min(wo[..., 2], 0.0)[..., None]
    valid = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    return torch.where(valid[..., None], f, 0.0)


def _diffuse_pdf(p, wi, wo):
    valid = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    return torch.where(valid, warp.square_to_cosine_hemisphere_pdf(wo), 0.0)


def _flip_sign(p: MatParams, wi):
    """Two-sided handling: flip z for the (one-sided) diffuse model when
    lit from the back and the material is two-sided."""
    flip = p.twosided & (wi[..., 2] < 0)
    return torch.where(flip, -1.0, 1.0)


def _zflip(v, sign):
    one = torch.ones_like(sign)
    return v * torch.stack([one, one, sign], dim=-1)


def eval(p: MatParams, wi, wo, kinds=None):
    """f(wi,wo)*|cos_o| (the diffuse lobe; 0 on null rows, a delta)."""
    _check_kinds(kinds)
    sign = _flip_sign(p, wi)
    out = _diffuse_eval(p, _zflip(wi, sign), _zflip(wo, sign))
    if NULL_BSDF in kinds:
        out = torch.where((p.kind == NULL_BSDF)[..., None], 0.0, out)
    return out


def pdf(p: MatParams, wi, wo, kinds=None):
    """Solid-angle pdf of sample() (the diffuse lobe; 0 on null rows)."""
    _check_kinds(kinds)
    sign = _flip_sign(p, wi)
    out = _diffuse_pdf(p, _zflip(wi, sign), _zflip(wo, sign))
    if NULL_BSDF in kinds:
        out = torch.where(p.kind == NULL_BSDF, 0.0, out)
    return out


class BSDFSample(NamedTuple):
    wo: torch.Tensor        # [N, 3] local
    weight: torch.Tensor    # [N, 3] f*cos/pdf (0 on failure)
    pdf: torch.Tensor       # [N] solid-angle pdf
    is_delta: torch.Tensor  # [N] bool
    eta: torch.Tensor       # [N] relative IOR of the transition
    valid: torch.Tensor     # [N] bool


def sample(p: MatParams, wi, u2, u_comp, kinds=None) -> BSDFSample:
    """Sample an outgoing direction (cosine hemisphere; null rows pass
    straight through: wo = -wi, weight 1, pdf 1, delta). u2: [N,2],
    u_comp: [N] (unused by both)."""
    _check_kinds(kinds)
    sign = _flip_sign(p, wi)
    wif = _zflip(wi, sign)
    wo_d = warp.square_to_cosine_hemisphere(u2)
    pdf_d = warp.square_to_cosine_hemisphere_pdf(wo_d)
    weight = torch.where((wif[..., 2] > 0)[..., None], p.reflectance, 0.0)
    valid = (wif[..., 2] > 0) & (wo_d[..., 2] > 0)
    wo = _zflip(wo_d, sign)   # un-flip back to the true frame
    pdf_out = pdf_d
    is_delta = torch.zeros_like(valid)
    if NULL_BSDF in kinds:
        # the reference never flips a null row's frame (it handles the
        # sign itself), so its pass-through is -wi as given
        null = p.kind == NULL_BSDF
        wo = torch.where(null[..., None], -wi, wo)
        weight = torch.where(null[..., None], 1.0, weight)
        pdf_out = torch.where(null, 1.0, pdf_out)
        valid = valid | null
        is_delta = null
    weight = torch.where(valid[..., None], weight, 0.0)
    return BSDFSample(wo=wo, weight=weight,
                      pdf=torch.where(valid, pdf_out, 0.0),
                      is_delta=is_delta,
                      eta=torch.ones_like(pdf_d), valid=valid)


def scene_kinds(scene) -> frozenset:
    """Static set of material kinds present in a compiled scene (plus the
    OPACITY / ROUGH_COAT pseudo-kinds), read once on the host."""
    kinds = set(int(v) for v in
                np.unique(scene.materials.kind.cpu().numpy()))
    packed = scene.materials.packed.cpu().numpy()
    if (packed[:, 22] < 1.0).any() or (packed[:, 23] >= 0).any():
        kinds.add(OPACITY)
    coat_rows = packed[:, 0] == COATING
    if (packed[coat_rows, 21] > _ROUGH_LAYER_MIN).any():
        kinds.add(ROUGH_COAT)
    return frozenset(kinds)


def any_specular(materials, shift_threshold):
    """Host-side check: does ANY material classify as specular/glossy for
    shifting (roughness <= threshold)?"""
    kinds = materials.kind.cpu().numpy()
    alphas = materials.alpha.cpu().numpy()
    packed = materials.packed.cpu().numpy()
    coat_rough = np.where(packed[:, 21] > _ROUGH_LAYER_MIN, alphas, 0.0)
    rough = np.where(
        np.isin(kinds, (CONDUCTOR, DIELECTRIC, THIN_DIELECTRIC)), 0.0,
        np.where(kinds == COATING, coat_rough,
                 np.where(np.isin(kinds, (ROUGH_CONDUCTOR, ROUGH_PLASTIC,
                                          ROUGH_DIELECTRIC, WARD)), alphas,
                          np.inf)))
    has_mask = (packed[:, 22] < 1.0).any() or (packed[:, 23] >= 0).any()
    return bool((rough <= shift_threshold).any() or has_mask)


def _roughness_table(materials):
    """Per-material classification roughness (gpt.cpp getVertexType):
    0 for smooth-delta rows, alpha for microfacet/wrapper rows, 1e9 for
    diffuse rows."""
    kind = materials.kind
    alpha = materials.alpha
    r = torch.full(kind.shape, 1e9, dtype=torch.float32, device=kind.device)
    r = torch.where((kind == CONDUCTOR) | (kind == DIELECTRIC) |
                    (kind == THIN_DIELECTRIC), 0.0, r)
    r = torch.where((kind == ROUGH_CONDUCTOR) | (kind == ROUGH_DIELECTRIC) |
                    (kind == ROUGH_PLASTIC) | (kind == WARD) |
                    (kind == BLEND) | (kind == COATING), alpha, r)
    return r


def roughness(materials, mid):
    """Scalar roughness per lane used by G-PT vertex classification."""
    return _roughness_table(materials)[mid.long()]
