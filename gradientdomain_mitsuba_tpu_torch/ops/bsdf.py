"""BSDF sample/eval/pdf with a static dispatch over the scene's kinds.

Counterpart of gradientdomain_mitsuba_tpu/ops/bsdf.py.  Mitsuba
conventions: directions in the LOCAL shading frame (+z = shading
normal); wi points AWAY from the surface; eval() returns
f(wi,wo)*|cos(theta_o)|; pdf() is the solid-angle density of sample();
sample() returns (wo, weight = f*cos/pdf, pdf, is_delta, eta, valid).

`kinds` is the static set of material kinds in the scene (scene_kinds),
as in the reference.  Ported: the DIFFUSE lobe (src/bsdfs/diffuse.cpp),
the smooth CONDUCTOR (conductor.cpp: a delta mirror lobe weighted by the
conductor Fresnel term) and DIELECTRIC (dielectric.cpp: delta reflection
or refraction chosen by the dielectric Fresnel term), and the NULL kind
(src/bsdfs/null.cpp: an index-matched medium boundary, a delta
pass-through wo = -wi).  Delta lobes evaluate to 0 in eval and pdf.  Any
other kind raises (ROADMAP Queue 1 item 12).
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
PORTED_KINDS = frozenset({DIFFUSE, NULL_BSDF, CONDUCTOR, DIELECTRIC})
# the kinds the gradient-domain tracers take: their shifts through delta
# vertices (the half-vector shift) are ROADMAP Queue 1 item 7a
DIFFUSE_ONLY = frozenset({DIFFUSE})
# the ported kinds whose every lobe is a delta: 0 in eval and pdf
_DELTA_ONLY = (CONDUCTOR, DIELECTRIC, NULL_BSDF)


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
            "only diffuse, conductor, dielectric and null are ported "
            "(ROADMAP Queue 1 item 12)")


def fresnel_dielectric(cos_i, eta):
    """Exact unpolarized dielectric Fresnel (fresnelDielectricExt).
    cos_i may be signed (negative = from inside); eta = int/ext ratio.
    Returns (F, cos_t), cos_t carrying the sign of the transmitted
    side."""
    outside = cos_i >= 0.0
    rel_eta = torch.where(outside, eta, 1.0 / torch.clamp_min(eta, 1e-9))
    ci = torch.abs(cos_i)
    sin_t2 = (1.0 - ci * ci) / torch.clamp_min(rel_eta * rel_eta, 1e-18)
    tir = sin_t2 >= 1.0
    ct = torch.sqrt(torch.clamp_min(1.0 - sin_t2, 0.0))
    rs = (ci - rel_eta * ct) / torch.clamp_min(ci + rel_eta * ct, 1e-12)
    rp = (rel_eta * ci - ct) / torch.clamp_min(rel_eta * ci + ct, 1e-12)
    F = torch.where(tir, 1.0, 0.5 * (rs * rs + rp * rp))
    cos_t = torch.where(tir, 0.0, torch.where(outside, -ct, ct))
    return F, cos_t


def fresnel_conductor(cos_i, eta, k):
    """Unpolarized conductor Fresnel; eta / k are [..., 3] RGB."""
    ci = torch.abs(cos_i)[..., None]
    ci2 = ci * ci
    si2 = 1.0 - ci2
    e2 = eta * eta
    k2 = k * k
    t0 = e2 - k2 - si2
    a2b2 = torch.sqrt(torch.clamp_min(t0 * t0 + 4.0 * e2 * k2, 0.0))
    t1 = a2b2 + ci2
    a = torch.sqrt(torch.clamp_min(0.5 * (a2b2 + t0), 0.0))
    t2 = 2.0 * a * ci
    rs = (t1 - t2) / torch.clamp_min(t1 + t2, 1e-12)
    t3 = ci2 * a2b2 + si2 * si2
    t4 = t2 * si2
    rp = rs * (t3 - t4) / torch.clamp_min(t3 + t4, 1e-12)
    return 0.5 * (rp + rs)


def _reflect_local(w):
    """Reflect about +z in the local shading frame."""
    return torch.stack([-w[..., 0], -w[..., 1], w[..., 2]], dim=-1)


def _diffuse_eval(p: MatParams, wi, wo):
    f = p.reflectance * INV_PI * torch.clamp_min(wo[..., 2], 0.0)[..., None]
    valid = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    return torch.where(valid[..., None], f, 0.0)


def _diffuse_pdf(p, wi, wo):
    valid = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    return torch.where(valid, warp.square_to_cosine_hemisphere_pdf(wo), 0.0)


def _flip_sign(p: MatParams, wi):
    """Two-sided handling: flip z for the intrinsically one-sided models
    (diffuse, conductor) when lit from the back and the material is
    two-sided; dielectric and null rows handle signed cosines
    themselves and are never flipped."""
    handles_sign = (p.kind == DIELECTRIC) | (p.kind == NULL_BSDF)
    flip = p.twosided & (wi[..., 2] < 0) & ~handles_sign
    return torch.where(flip, -1.0, 1.0)


def _delta_only(p: MatParams, kinds):
    """Lanes whose material has only delta lobes, or None when the scene
    has no such kind."""
    mask = None
    for kk in _DELTA_ONLY:
        if kk in kinds:
            mask = p.kind == kk if mask is None else mask | (p.kind == kk)
    return mask


def _zflip(v, sign):
    one = torch.ones_like(sign)
    return v * torch.stack([one, one, sign], dim=-1)


def eval(p: MatParams, wi, wo, kinds=None):
    """f(wi,wo)*|cos_o| of the smooth lobes (the diffuse lobe); 0 on
    delta-only rows (conductor, dielectric, null)."""
    _check_kinds(kinds)
    sign = _flip_sign(p, wi)
    out = _diffuse_eval(p, _zflip(wi, sign), _zflip(wo, sign))
    delta = _delta_only(p, kinds)
    if delta is not None:
        out = torch.where(delta[..., None], 0.0, out)
    return out


def pdf(p: MatParams, wi, wo, kinds=None):
    """Solid-angle pdf of sample() restricted to the smooth lobes; 0 on
    delta-only rows."""
    _check_kinds(kinds)
    sign = _flip_sign(p, wi)
    out = _diffuse_pdf(p, _zflip(wi, sign), _zflip(wo, sign))
    delta = _delta_only(p, kinds)
    if delta is not None:
        out = torch.where(delta, 0.0, out)
    return out


class BSDFSample(NamedTuple):
    wo: torch.Tensor        # [N, 3] local
    weight: torch.Tensor    # [N, 3] f*cos/pdf (0 on failure)
    pdf: torch.Tensor       # [N] solid-angle pdf
    is_delta: torch.Tensor  # [N] bool
    eta: torch.Tensor       # [N] relative IOR of the transition
    valid: torch.Tensor     # [N] bool


def sample(p: MatParams, wi, u2, u_comp, kinds=None) -> BSDFSample:
    """Sample an outgoing direction.  u2: [N,2] (the diffuse lobe's
    cosine-hemisphere draw), u_comp: [N] (the dielectric's choice of
    reflection, u_comp <= F, or refraction).  Conductor rows mirror
    (weight specular * F, pdf 1), dielectric rows reflect (weight
    specular, pdf F) or refract (weight transmittance / eta^2, pdf 1 - F,
    eta the relative IOR), null rows pass straight through (wo = -wi,
    weight 1, pdf 1); all three are delta."""
    _check_kinds(kinds)
    sign = _flip_sign(p, wi)
    wif = _zflip(wi, sign)
    k = p.kind
    wo = warp.square_to_cosine_hemisphere(u2)
    pdf_out = warp.square_to_cosine_hemisphere_pdf(wo)
    weight = torch.where((wif[..., 2] > 0)[..., None], p.reflectance, 0.0)
    valid = (wif[..., 2] > 0) & (wo[..., 2] > 0)
    eta = torch.ones_like(pdf_out)
    is_delta = torch.zeros_like(valid)

    def pick(kk, wo_k, w_k, pdf_k, valid_k, eta_k=None):
        nonlocal wo, weight, pdf_out, valid, eta, is_delta
        on = k == kk
        wo = torch.where(on[..., None], wo_k, wo)
        weight = torch.where(on[..., None], w_k, weight)
        pdf_out = torch.where(on, pdf_k, pdf_out)
        valid = torch.where(on, valid_k, valid)
        if eta_k is not None:
            eta = torch.where(on, eta_k, eta)
        is_delta = is_delta | on

    one = torch.ones_like(pdf_out)
    if CONDUCTOR in kinds:
        pick(CONDUCTOR, _reflect_local(wif),
             p.specular * fresnel_conductor(wif[..., 2], p.eta, p.k), one,
             wif[..., 2] > 0)
    if DIELECTRIC in kinds:
        eta_s = p.eta[..., 0]
        F, cos_t = fresnel_dielectric(wi[..., 2], eta_s)
        refl = u_comp <= F
        rel_eta = torch.where(wi[..., 2] >= 0, eta_s,
                              1.0 / torch.clamp_min(eta_s, 1e-9))
        wo_refr = torch.stack([-wi[..., 0] / rel_eta, -wi[..., 1] / rel_eta,
                               cos_t], dim=-1)
        # radiance transport: the transmitted weight carries 1/eta^2
        w_die = torch.where(
            refl[..., None], p.specular,
            p.transmittance / torch.clamp_min(rel_eta * rel_eta,
                                              1e-9)[..., None])
        pdf_die = torch.where(refl, F, 1.0 - F)
        pick(DIELECTRIC,
             torch.where(refl[..., None], _reflect_local(wi), wo_refr),
             w_die, pdf_die, pdf_die > 0, torch.where(refl, 1.0, rel_eta))
    if NULL_BSDF in kinds:
        pick(NULL_BSDF, -wi, torch.ones_like(weight), one,
             torch.ones_like(valid))
    # un-flip back to the true frame (dielectric and null rows were never
    # flipped: their sign is 1)
    wo = _zflip(wo, sign)
    weight = torch.where(valid[..., None], weight, 0.0)
    return BSDFSample(wo=wo, weight=weight,
                      pdf=torch.where(valid, pdf_out, 0.0),
                      is_delta=is_delta, eta=eta, valid=valid)


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
