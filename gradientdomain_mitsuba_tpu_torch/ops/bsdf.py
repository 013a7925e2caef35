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
or refraction chosen by the dielectric Fresnel term), the NULL kind
(src/bsdfs/null.cpp: an index-matched medium boundary, a delta
pass-through wo = -wi), the microfacet kinds ROUGH_CONDUCTOR,
ROUGH_PLASTIC and ROUGH_DIELECTRIC (roughconductor.cpp,
roughplastic.cpp, roughdielectric.cpp over microfacet.h's Beckmann /
GGX with full-NDF sampling) and PLASTIC (plastic.cpp: a delta specular
lobe over a diffuse substrate; eval and pdf cover the substrate).  Delta
lobes evaluate to 0 in eval and pdf.  Any other kind raises (ROADMAP
Queue 1 item 12).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import math as m
from ..core import warp
from ..core.spectrum import luminance
from ..scene.materials import (BLEND, COATING, CONDUCTOR, DIELECTRIC,
                               DIFFUSE, DIST_GGX, FLAG_TWOSIDED, NULL_BSDF,
                               PLASTIC, ROUGH_CONDUCTOR, ROUGH_DIELECTRIC,
                               ROUGH_PLASTIC, THIN_DIELECTRIC, WARD)

INV_PI = warp.INV_PI
OPACITY = -2             # pseudo-kind: some row has a mask opacity
ROUGH_COAT = -3          # pseudo-kind: some COATING row has a rough layer
_ROUGH_LAYER_MIN = 1e-5  # coat_alpha above this = microfacet layer lobe
PORTED_KINDS = frozenset({DIFFUSE, NULL_BSDF, CONDUCTOR, DIELECTRIC,
                          ROUGH_CONDUCTOR, PLASTIC, ROUGH_PLASTIC,
                          ROUGH_DIELECTRIC})
# the ported kinds whose every lobe is a delta: 0 in eval and pdf
_DELTA_ONLY = (CONDUCTOR, DIELECTRIC, NULL_BSDF)


class MatParams(NamedTuple):
    """Per-interaction material parameters (gathered from the table)."""
    kind: torch.Tensor          # [N] i32
    twosided: torch.Tensor      # [N] bool
    reflectance: torch.Tensor   # [N, 3] (texture-resolved albedo)
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


def gather_params(materials, mid, albedo_override=None) -> MatParams:
    """Material parameters for a batch of ids — ONE gather of the packed
    [M, 28] row table (Materials.packed); fields are slices of the row.
    albedo_override (texture-resolved reflectance, [N, 3]) replaces the
    row's reflectance before the specular sampling weight is taken from
    it, as in the reference."""
    row = materials.packed[mid.long()]
    refl = row[..., 2:5]
    if albedo_override is not None:
        refl = albedo_override
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
            "only diffuse, conductor, dielectric, null, roughconductor, "
            "plastic, roughplastic and roughdielectric are ported (ROADMAP "
            "Queue 1 item 12)")


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


# ---------------------------------------------------------------------------
# Microfacet helpers (Beckmann / GGX, full NDF — Mitsuba 0.5 microfacet.h)
# ---------------------------------------------------------------------------

def mf_D(m_, alpha, dist):
    db = warp.square_to_beckmann_pdf(m_, alpha) / torch.clamp_min(
        torch.abs(m_[..., 2]), 1e-9)
    dg = warp.square_to_ggx_pdf(m_, alpha) / torch.clamp_min(
        torch.abs(m_[..., 2]), 1e-9)
    return torch.where(dist == DIST_GGX, dg, db)


def mf_sample(u, alpha, dist):
    mb = warp.square_to_beckmann(u, alpha)
    mg = warp.square_to_ggx(u, alpha)
    return torch.where((dist == DIST_GGX)[..., None], mg, mb)


def mf_pdf(m_, alpha, dist):
    """pdf of the sampled half vector (D * cos)."""
    pb = warp.square_to_beckmann_pdf(m_, alpha)
    pg = warp.square_to_ggx_pdf(m_, alpha)
    return torch.where(dist == DIST_GGX, pg, pb)


def _smith_g1(v, m_, alpha, dist):
    cos_v = v[..., 2]
    # side check: v and m on the same side
    valid = (m.dot(v, m_) * cos_v) > 0.0
    ct2 = torch.clamp(cos_v * cos_v, 1e-9, 1.0)
    tan_v = torch.sqrt(torch.clamp_min(1.0 - ct2, 0.0) / ct2)
    # Beckmann rational approximation
    a = 1.0 / torch.clamp_min(alpha * tan_v, 1e-9)
    g_b = torch.where(
        a < 1.6,
        (3.535 * a + 2.181 * a * a) / (1.0 + 2.276 * a + 2.577 * a * a),
        1.0)
    # GGX exact
    g_g = 2.0 / (1.0 + torch.sqrt(1.0 + (alpha * tan_v) ** 2))
    g = torch.where(dist == DIST_GGX, g_g, g_b)
    return torch.where(valid, g, 0.0)


def mf_G(wi, wo, m_, alpha, dist):
    return _smith_g1(wi, m_, alpha, dist) * _smith_g1(wo, m_, alpha, dist)


def _half_vector(wi, wo):
    """Normalized wi + wo on the +z side, and its pre-normalization
    length."""
    h = wi + wo
    hlen = m.length(h, keepdims=True)
    h = h / torch.clamp_min(hlen, 1e-12)
    return h * torch.sign(h[..., 2:3]), hlen[..., 0]


# ---------------------------------------------------------------------------
# Per-model eval / pdf (one-sided models take the flipped-to-front wi)
# ---------------------------------------------------------------------------

def _diffuse_eval(p: MatParams, wi, wo):
    f = p.reflectance * INV_PI * torch.clamp_min(wo[..., 2], 0.0)[..., None]
    valid = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    return torch.where(valid[..., None], f, 0.0)


def _diffuse_pdf(p, wi, wo):
    valid = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    return torch.where(valid, warp.square_to_cosine_hemisphere_pdf(wo), 0.0)


def _roughconductor_eval(p: MatParams, wi, wo):
    h, hlen = _half_vector(wi, wo)
    D = mf_D(h, p.alpha, p.dist)
    G = mf_G(wi, wo, h, p.alpha, p.dist)
    F = fresnel_conductor(m.dot(wi, h), p.eta, p.k)
    ci = wi[..., 2]
    spec = (D * G / torch.clamp_min(4.0 * ci, 1e-9))[..., None] * F * \
        p.specular
    valid = (ci > 0) & (wo[..., 2] > 0) & (hlen > 1e-12)
    return torch.where(valid[..., None], spec, 0.0)


def _roughconductor_pdf(p, wi, wo):
    h, _ = _half_vector(wi, wo)
    pdf_m = mf_pdf(h, p.alpha, p.dist)
    jac = 1.0 / torch.clamp_min(4.0 * torch.abs(m.dot(wo, h)), 1e-9)
    valid = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    return torch.where(valid, pdf_m * jac, 0.0)


def _roughconductor_spec_dielectric(p, wi, wo):
    """Microfacet specular lobe with DIELECTRIC Fresnel (roughplastic)."""
    h, hlen = _half_vector(wi, wo)
    D = mf_D(h, p.alpha, p.dist)
    G = mf_G(wi, wo, h, p.alpha, p.dist)
    F, _ = fresnel_dielectric(m.dot(wi, h), p.eta[..., 0])
    ci = wi[..., 2]
    spec = (D * G * F / torch.clamp_min(4.0 * ci, 1e-9))[..., None] * \
        p.specular
    valid = (ci > 0) & (wo[..., 2] > 0) & (hlen > 1e-12)
    return torch.where(valid[..., None], spec, 0.0)


def _substrate_eval(p, wi, wo):
    """The diffuse substrate under a dielectric interface (plastic.cpp /
    roughplastic.cpp with nonlinear=false): rho / (1 - fdr_int) times the
    two Fresnel transmissions and 1/eta^2."""
    Fi, _ = fresnel_dielectric(wi[..., 2], p.eta[..., 0])
    Fo, _ = fresnel_dielectric(wo[..., 2], p.eta[..., 0])
    inv_eta2 = 1.0 / torch.clamp_min(p.eta[..., 0] ** 2, 1e-9)
    diff = p.reflectance / torch.clamp_min(1.0 - p.fdr_int, 1e-6)[..., None]
    return diff * INV_PI * (inv_eta2 * (1.0 - Fi) * (1.0 - Fo) *
                            torch.clamp_min(wo[..., 2], 0.0))[..., None]


def _roughplastic_eval(p: MatParams, wi, wo):
    spec = _roughconductor_spec_dielectric(p, wi, wo)
    valid = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    return torch.where(valid[..., None], spec + _substrate_eval(p, wi, wo),
                       0.0)


def _spec_prob(p, wi):
    """Probability of picking the specular lobe of a (rough) plastic:
    Fresnel-weighted specular sampling weight.  Returns (prob, Fi)."""
    Fi, _ = fresnel_dielectric(wi[..., 2], p.eta[..., 0])
    sw = p.spec_weight
    prob = (Fi * sw) / torch.clamp_min(Fi * sw + (1 - Fi) * (1 - sw), 1e-9)
    return prob, Fi


def _roughplastic_pdf(p, wi, wo):
    prob_spec = torch.clamp(_spec_prob(p, wi)[0], 0.0, 1.0)
    pdf_s = _roughconductor_pdf(p, wi, wo)
    pdf_d = _diffuse_pdf(p, wi, wo)
    return prob_spec * pdf_s + (1 - prob_spec) * pdf_d


def _plastic_eval_diffuse(p, wi, wo):
    """Smooth plastic: delta specular + diffuse substrate; eval covers the
    diffuse part only (plastic.cpp eval with ESolidAngle)."""
    valid = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    return torch.where(valid[..., None], _substrate_eval(p, wi, wo), 0.0)


def _plastic_pdf(p, wi, wo):
    prob_spec = _spec_prob(p, wi)[0]
    return (1 - prob_spec) * _diffuse_pdf(p, wi, wo)


def _roughdielectric_H(p, wi, wo):
    """Half vector for reflection / refraction (Walter et al. 2007),
    oriented to +z.  Returns (H, refract_mask, rel_eta, H_ok)."""
    refract = (wi[..., 2] * wo[..., 2]) < 0
    rel = torch.where(wi[..., 2] >= 0, p.eta[..., 0],
                      1.0 / torch.clamp_min(p.eta[..., 0], 1e-9))
    h_refl = wi + wo
    h_refr = -(wi + rel[..., None] * wo)
    h = torch.where(refract[..., None], h_refr, h_refl)
    hlen = m.length(h, keepdims=True)
    h = h / torch.clamp_min(hlen, 1e-12)
    h = h * torch.sign(h[..., 2:3])
    return h, refract, rel, hlen[..., 0] > 1e-12


def _roughdielectric_valid(refract, widh, wodh, h_ok, wi, wo):
    """Microfacet sidedness: reflection keeps wi / wo on the same side of
    H, refraction on opposite sides, and the geometric sides agree."""
    same = (wi[..., 2] * wo[..., 2]) > 0
    side_ok = torch.where(refract, widh * wodh < 0, widh * wodh > 0)
    return h_ok & side_ok & torch.where(refract, ~same, same)


def _roughdielectric_eval(p: MatParams, wi, wo):
    """f*|cos_o| for rough dielectric (radiance transport: the eta^2
    compression folded in, as for the smooth dielectric)."""
    h, refract, rel, h_ok = _roughdielectric_H(p, wi, wo)
    D = mf_D(h, p.alpha, p.dist)
    G = mf_G(wi * torch.sign(wi[..., 2:3]), wo * torch.sign(wo[..., 2:3]),
             h, p.alpha, p.dist)
    widh = m.dot(wi, h)
    wodh = m.dot(wo, h)
    F, _ = fresnel_dielectric(widh, p.eta[..., 0])
    ci = torch.abs(wi[..., 2])

    f_refl = p.specular * (F * D * G /
                           torch.clamp_min(4.0 * ci, 1e-9))[..., None]
    denom = (widh + rel * wodh) ** 2
    f_refr = p.transmittance * (
        torch.abs(widh) * torch.abs(wodh) / torch.clamp_min(ci, 1e-9) *
        (1.0 - F) * D * G / torch.clamp_min(denom, 1e-12))[..., None]
    out = torch.where(refract[..., None], f_refr, f_refl)
    valid = _roughdielectric_valid(refract, widh, wodh, h_ok, wi, wo)
    return torch.where(valid[..., None], out, 0.0)


def _roughdielectric_pdf(p: MatParams, wi, wo):
    h, refract, rel, h_ok = _roughdielectric_H(p, wi, wo)
    widh = m.dot(wi, h)
    wodh = m.dot(wo, h)
    pm = mf_pdf(h, p.alpha, p.dist)   # D * |cos_h|
    F, _ = fresnel_dielectric(widh, p.eta[..., 0])
    jac_refl = 1.0 / torch.clamp_min(4.0 * torch.abs(wodh), 1e-9)
    denom = (widh + rel * wodh) ** 2
    jac_refr = (rel * rel) * torch.abs(wodh) / torch.clamp_min(denom, 1e-12)
    pdf_ = torch.where(refract, pm * jac_refr * (1.0 - F), pm * jac_refl * F)
    valid = _roughdielectric_valid(refract, widh, wodh, h_ok, wi, wo)
    return torch.where(valid, pdf_, 0.0)


def _roughdielectric_sample(p: MatParams, wi, u2, uc):
    """Returns (wo, weight, pdf, valid, eta of the transition)."""
    h = mf_sample(u2, p.alpha, p.dist)
    widh = m.dot(wi, h)
    F, _ = fresnel_dielectric(widh, p.eta[..., 0])
    choose_refl = uc <= F
    wo_refl = 2.0 * widh[..., None] * h - wi
    rel = torch.where(widh >= 0, p.eta[..., 0],
                      1.0 / torch.clamp_min(p.eta[..., 0], 1e-9))
    c2 = 1.0 - (1.0 - widh * widh) / torch.clamp_min(rel * rel, 1e-18)
    cos_tp = torch.sqrt(torch.clamp_min(c2, 0.0))
    sgn = torch.sign(widh)
    wo_refr = m.normalize(-wi / rel[..., None] +
                          (widh / rel - sgn * cos_tp)[..., None] * h)
    wo = torch.where(choose_refl[..., None], wo_refl, wo_refr)
    valid_mode = torch.where(choose_refl,
                             (wo[..., 2] * wi[..., 2]) > 0,
                             (wo[..., 2] * wi[..., 2]) < 0)
    f = _roughdielectric_eval(p, wi, wo)
    pdf_ = _roughdielectric_pdf(p, wi, wo)
    weight = f / torch.clamp_min(pdf_, 1e-12)[..., None]
    valid = valid_mode & (pdf_ > 0) & (f.amax(-1) > 0)
    return wo, weight, pdf_, valid, torch.where(choose_refl, 1.0, rel)


def _flip_sign(p: MatParams, wi):
    """Two-sided handling: flip z for the intrinsically one-sided models
    when lit from the back and the material is two-sided; dielectric,
    rough dielectric and null rows handle signed cosines themselves and
    are never flipped."""
    handles_sign = ((p.kind == DIELECTRIC) | (p.kind == ROUGH_DIELECTRIC) |
                    (p.kind == NULL_BSDF))
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


# smooth-lobe eval / pdf of each non-diffuse kind, in the reference's
# dispatch order
_EVALS = ((ROUGH_CONDUCTOR, _roughconductor_eval),
          (ROUGH_PLASTIC, _roughplastic_eval),
          (PLASTIC, _plastic_eval_diffuse),
          (ROUGH_DIELECTRIC, _roughdielectric_eval))
_PDFS = ((ROUGH_CONDUCTOR, _roughconductor_pdf),
         (ROUGH_PLASTIC, _roughplastic_pdf),
         (PLASTIC, _plastic_pdf),
         (ROUGH_DIELECTRIC, _roughdielectric_pdf))


def eval(p: MatParams, wi, wo, kinds=None):
    """f(wi,wo)*|cos_o| of the smooth lobes; 0 on delta-only rows
    (conductor, dielectric, null)."""
    _check_kinds(kinds)
    sign = _flip_sign(p, wi)
    wi, wo = _zflip(wi, sign), _zflip(wo, sign)
    out = _diffuse_eval(p, wi, wo)
    for kk, f in _EVALS:
        if kk in kinds:
            out = torch.where((p.kind == kk)[..., None], f(p, wi, wo), out)
    delta = _delta_only(p, kinds)
    if delta is not None:
        out = torch.where(delta[..., None], 0.0, out)
    return out


def pdf(p: MatParams, wi, wo, kinds=None):
    """Solid-angle pdf of sample() restricted to the smooth lobes; 0 on
    delta-only rows."""
    _check_kinds(kinds)
    sign = _flip_sign(p, wi)
    wi, wo = _zflip(wi, sign), _zflip(wo, sign)
    out = _diffuse_pdf(p, wi, wo)
    for kk, f in _PDFS:
        if kk in kinds:
            out = torch.where(p.kind == kk, f(p, wi, wo), out)
    delta = _delta_only(p, kinds)
    if delta is not None:
        out = torch.where(delta, 0.0, out)
    return out


class BSDFSample(NamedTuple):
    wo: torch.Tensor        # [N, 3] local
    weight: torch.Tensor    # [N, 3] f*cos/pdf (0 on failure)
    pdf: torch.Tensor       # [N] solid-angle pdf (delta: discrete prob)
    is_delta: torch.Tensor  # [N] bool
    eta: torch.Tensor       # [N] relative IOR of the transition
    valid: torch.Tensor     # [N] bool


def sample(p: MatParams, wi, u2, u_comp, kinds=None) -> BSDFSample:
    """Sample an outgoing direction.  u2: [N,2] (the diffuse lobe's
    cosine-hemisphere draw, or the microfacet normal's), u_comp: [N] (the
    choice of lobe: reflection u_comp <= F or refraction for the
    dielectrics, specular u_comp < prob_spec or diffuse for the
    plastics).  Conductor rows mirror (weight specular * F, pdf 1),
    dielectric rows reflect (weight specular, pdf F) or refract (weight
    transmittance / eta^2, pdf 1 - F, eta the relative IOR), null rows
    pass straight through (wo = -wi, weight 1, pdf 1): all three are
    delta, as is plastic's specular lobe (pdf = its pick probability).
    The microfacet kinds weight by eval / pdf."""
    _check_kinds(kinds)
    sign = _flip_sign(p, wi)
    wif = _zflip(wi, sign)
    k = p.kind
    wo_d = warp.square_to_cosine_hemisphere(u2)
    pdf_d = warp.square_to_cosine_hemisphere_pdf(wo_d)
    wo = wo_d
    pdf_out = pdf_d
    weight = torch.where((wif[..., 2] > 0)[..., None], p.reflectance, 0.0)
    valid = (wif[..., 2] > 0) & (wo_d[..., 2] > 0)
    eta = torch.ones_like(pdf_out)
    is_delta = torch.zeros_like(valid)

    def pick(kk, wo_k, w_k, pdf_k, valid_k, eta_k=None, delta_k=True):
        nonlocal wo, weight, pdf_out, valid, eta, is_delta
        on = k == kk
        wo = torch.where(on[..., None], wo_k, wo)
        weight = torch.where(on[..., None], w_k, weight)
        pdf_out = torch.where(on, pdf_k, pdf_out)
        valid = torch.where(on, valid_k, valid)
        if eta_k is not None:
            eta = torch.where(on, eta_k, eta)
        if delta_k is not False:
            is_delta = is_delta | (on if delta_k is True else on & delta_k)

    one = torch.ones_like(pdf_out)
    if CONDUCTOR in kinds:
        pick(CONDUCTOR, _reflect_local(wif),
             p.specular * fresnel_conductor(wif[..., 2], p.eta, p.k), one,
             wif[..., 2] > 0)
    eta_s = p.eta[..., 0]
    if DIELECTRIC in kinds:
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
    if ROUGH_CONDUCTOR in kinds or ROUGH_PLASTIC in kinds:
        m_h = mf_sample(u2, p.alpha, p.dist)
        wo_rc = 2.0 * m.dot(wif, m_h, keepdims=True) * m_h - wif
    if ROUGH_CONDUCTOR in kinds:
        pdf_rc = _roughconductor_pdf(p, wif, wo_rc)
        w_rc = (_roughconductor_eval(p, wif, wo_rc) /
                torch.clamp_min(pdf_rc, 1e-12)[..., None])
        pick(ROUGH_CONDUCTOR, wo_rc, w_rc, pdf_rc,
             (wo_rc[..., 2] > 0) & (wif[..., 2] > 0) & (pdf_rc > 0),
             delta_k=False)
    if ROUGH_PLASTIC in kinds:
        prob_rp = torch.clamp(_spec_prob(p, wif)[0], 0.0, 1.0)
        wo_rp = torch.where((u_comp < prob_rp)[..., None], wo_rc, wo_d)
        pdf_rp = _roughplastic_pdf(p, wif, wo_rp)
        w_rp = (_roughplastic_eval(p, wif, wo_rp) /
                torch.clamp_min(pdf_rp, 1e-12)[..., None])
        pick(ROUGH_PLASTIC, wo_rp, w_rp, pdf_rp,
             (wo_rp[..., 2] > 0) & (wif[..., 2] > 0) & (pdf_rp > 0),
             delta_k=False)
    if PLASTIC in kinds:
        prob_p, Fi_p = _spec_prob(p, wif)
        prob_p = torch.clamp(prob_p, 0.0, 1.0)
        spec_p = u_comp < prob_p
        wo_pl = torch.where(spec_p[..., None], _reflect_local(wif), wo_d)
        w_spec = p.specular * (Fi_p / torch.clamp_min(prob_p,
                                                      1e-9))[..., None]
        w_diff = (_plastic_eval_diffuse(p, wif, wo_pl) / torch.clamp_min(
            (1 - prob_p) * pdf_d, 1e-12)[..., None])
        pick(PLASTIC, wo_pl, torch.where(spec_p[..., None], w_spec, w_diff),
             torch.where(spec_p, prob_p, (1 - prob_p) * pdf_d),
             wif[..., 2] > 0, delta_k=spec_p)
    if ROUGH_DIELECTRIC in kinds:
        wo_rd, w_rd, pdf_rd, valid_rd, eta_rd = _roughdielectric_sample(
            p, wi, u2, u_comp)
        pick(ROUGH_DIELECTRIC, wo_rd, w_rd, pdf_rd, valid_rd, eta_rd,
             delta_k=False)
    if NULL_BSDF in kinds:
        pick(NULL_BSDF, -wi, torch.ones_like(weight), one,
             torch.ones_like(valid))
    # un-flip back to the true frame (the sign-handling rows were never
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
