"""BSDF sample/eval/pdf with a static dispatch over the scene's kinds.

Counterpart of gradientdomain_mitsuba_tpu/ops/bsdf.py.  Mitsuba
conventions: directions in the LOCAL shading frame (+z = shading
normal); wi points AWAY from the surface; eval() returns
f(wi,wo)*|cos(theta_o)|; pdf() is the solid-angle density of sample();
sample() returns (wo, weight = f*cos/pdf, pdf, is_delta, eta, valid).

`kinds` is the static set of material kinds in the scene (scene_kinds),
as in the reference.  Ported: every kind of the reference.  The
single-lobe kinds: DIFFUSE (src/bsdfs/diffuse.cpp),
ROUGH_DIFFUSE (roughdiffuse.cpp, Oren-Nayar), DIFFTRANS
(difftrans.cpp), PHONG (phong.cpp), WARD (ward.cpp) and HK (hk.cpp, a
single-scattering slab with a delta pass-through); the delta kinds
CONDUCTOR (conductor.cpp), DIELECTRIC (dielectric.cpp),
THIN_DIELECTRIC (thindielectric.cpp: reflect or pass straight through
with the two-interface reflectance) and NULL (null.cpp: an
index-matched medium boundary, wo = -wi); the microfacet kinds
ROUGH_CONDUCTOR, ROUGH_PLASTIC and ROUGH_DIELECTRIC (microfacet.h's
Beckmann / GGX with full-NDF sampling) and PLASTIC (a delta specular
lobe over a diffuse substrate; eval and pdf cover the substrate).  The
wrappers: a mask with a constant opacity (mask.cpp, the OPACITY
pseudo-kind), BLEND (blendbsdf.cpp / mixturebsdf.cpp) and COATING
(coating.cpp, roughcoating.cpp: the ROUGH_COAT pseudo-kind), the last
two on the child rows common.material_params resolves one level deep
(MatParams.blend / coat*).  IRAWAN (irawan.cpp, woven cloth:
ops/irawan.py's yarn-segment lobe over a diffuse term, sampled by the
cosine hemisphere with eval / pdf weights, MatParams.cloth filled by
common.material_params).  Delta lobes evaluate to 0 in eval and pdf.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..core import math as m
from ..core import warp
from ..core.records import tree_map
from ..core.spectrum import luminance
from ..scene.materials import (BLEND, COATING, CONDUCTOR, DIELECTRIC,
                               DIFFTRANS, DIFFUSE, DIST_GGX, FLAG_TWOSIDED,
                               HK, IRAWAN, NULL_BSDF, PHONG, PLASTIC,
                               ROUGH_CONDUCTOR, ROUGH_DIELECTRIC,
                               ROUGH_DIFFUSE, ROUGH_PLASTIC,
                               THIN_DIELECTRIC, WARD)
from ..scene.media import PHASE_HG, PHASE_ISOTROPIC
from . import medium

INV_PI = warp.INV_PI
OPACITY = -2             # pseudo-kind: some row has a mask opacity
ROUGH_COAT = -3          # pseudo-kind: some COATING row has a rough layer
_ROUGH_LAYER_MIN = 1e-5  # coat_alpha above this = microfacet layer lobe
PORTED_KINDS = frozenset({
    DIFFUSE, CONDUCTOR, DIELECTRIC, ROUGH_CONDUCTOR, PLASTIC, ROUGH_PLASTIC,
    ROUGH_DIELECTRIC, THIN_DIELECTRIC, ROUGH_DIFFUSE, PHONG, WARD,
    NULL_BSDF, BLEND, COATING, DIFFTRANS, HK, IRAWAN, OPACITY, ROUGH_COAT})
# the ported kinds whose every lobe is a delta: 0 in eval and pdf
_DELTA_ONLY = (CONDUCTOR, DIELECTRIC, THIN_DIELECTRIC, NULL_BSDF)


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
    blend_w: torch.Tensor = None  # [N] second-child weight (0 = no blend)
    # the wrapper fields common.material_params fills when the scene has
    # BLEND / COATING rows (has_textures bit 2): the second child's
    # params, and on COATING lanes the layer's
    blend: "MatParams" = None
    coat: torch.Tensor = None        # [N] bool lane is a COATING wrapper
    coat_eta: torch.Tensor = None    # [N] layer relative IOR
    coat_sigma: torch.Tensor = None  # [N, 3] sigmaA * thickness
    coat_spec: torch.Tensor = None   # [N, 3] layer specularReflectance
    coat_alpha: torch.Tensor = None  # [N] layer roughness (0 = smooth)
    coat_dist: torch.Tensor = None   # [N] i32 layer distribution
    # [N, 6] IRAWAN yarn-segment features (irawan.resolve_features; None
    # where the caller has no barycentric payload: the diffuse term only)
    cloth: torch.Tensor = None


def gather_params(materials, mid, albedo_override=None,
                  opacity_override=None) -> MatParams:
    """Material parameters for a batch of ids — ONE gather of the packed
    [M, 28] row table (Materials.packed); fields are slices of the row.
    albedo_override (texture-resolved reflectance, [N, 3]) replaces the
    row's reflectance before the specular sampling weight is taken from
    it, as in the reference; opacity_override ([N], a textured mask's
    opacity) replaces the row's opacity."""
    row = materials.packed[mid.long()]
    refl = row[..., 2:5]
    if albedo_override is not None:
        refl = albedo_override
    opacity = row[..., 22]
    if opacity_override is not None:
        opacity = opacity_override
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
        alpha_v=row[..., 21], opacity=opacity,
        child0=row[..., 24].to(torch.int32),
        child1=row[..., 25].to(torch.int32),
        blend_w=row[..., 26])


def _check_kinds(kinds):
    """The static kinds must be given (scene_kinds) and known."""
    if kinds is None or not set(kinds) <= PORTED_KINDS:
        raise ValueError(
            f"BSDF kinds {sorted(kinds) if kinds is not None else 'None'}: "
            f"the static set must be a subset of {sorted(PORTED_KINDS)}")


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


def _difftrans_eval(p: MatParams, wi, wo):
    """Diffuse transmitter (difftrans.cpp): a Lambertian lobe on the
    OPPOSITE hemisphere; `reflectance` carries the transmittance."""
    opposite = wi[..., 2] * wo[..., 2] < 0
    f = p.reflectance * INV_PI * torch.abs(wo[..., 2])[..., None]
    return torch.where(opposite[..., None], f, 0.0)


def _difftrans_pdf(p, wi, wo):
    opposite = wi[..., 2] * wo[..., 2] < 0
    return torch.where(opposite, torch.abs(wo[..., 2]) * INV_PI, 0.0)


def _hk_coeffs(p: MatParams):
    """(albedo, tau) of the HK slab: sigmaS in `reflectance`, sigmaA in
    `transmittance`, thickness in `alpha` (hk.cpp's parameters)."""
    sig_s = p.reflectance
    sig_t = sig_s + p.transmittance
    alb = sig_s / torch.clamp_min(sig_t, 1e-12)
    tau = sig_t * p.alpha[..., None]
    return alb, tau


def _hk_phase(p, wi, wo):
    """The slab's HG phase value (isotropic where |g| ~ 0), between the
    incident propagation -wi and wo."""
    kind = torch.where(torch.abs(p.alpha_v) < 1e-4, PHASE_ISOTROPIC,
                       PHASE_HG)
    return medium.phase_eval(kind, p.alpha_v, wi, wo)


def _hk_delta_t(p, wi):
    """Unscattered (delta) transmittance through the slab: exp(-tau/mu)."""
    _, tau = _hk_coeffs(p)
    mu_i = torch.clamp_min(torch.abs(wi[..., 2]), 1e-6)[..., None]
    return m.exp_f32(-tau / mu_i)


def _hk_eval(p: MatParams, wi, wo):
    """Hanrahan-Krueger single scattering in a slab of optical depth tau
    (hk.cpp).  f*|cos_o|:
      reflection:   alb p mu_o/(mu_i+mu_o) (1 - e^{-tau(1/mu_i+1/mu_o)})
      transmission: alb p mu_o (e^{-tau/mu_o} - e^{-tau/mu_i})/(mu_o-mu_i)
    with the mu_o -> mu_i limit alb p tau e^{-tau/mu}/mu.  The
    transmission's difference of exps cancels near that limit, scaling
    exp's last bit by up to ~1e3: every exp here is XLA's
    (m.exp_f32), so the slab is the reference's bits."""
    alb, tau = _hk_coeffs(p)
    mu_i = torch.clamp_min(torch.abs(wi[..., 2]), 1e-6)[..., None]
    mu_o = torch.clamp_min(torch.abs(wo[..., 2]), 1e-6)[..., None]
    ph = _hk_phase(p, wi, wo)[..., None]
    f_r = (alb * ph * mu_o / (mu_i + mu_o) *
           (1.0 - m.exp_f32(-tau * (1.0 / mu_i + 1.0 / mu_o))))
    dmu = mu_o - mu_i
    near = torch.abs(dmu) < 1e-4
    dmu_s = torch.where(near, 1.0, dmu)
    f_t_gen = (alb * ph * mu_o *
               (m.exp_f32(-tau / mu_o) - m.exp_f32(-tau / mu_i)) / dmu_s)
    f_t_lim = alb * ph * tau * m.exp_f32(-tau / mu_i) / mu_i
    f_t = torch.where(near, f_t_lim, f_t_gen)
    same_side = wi[..., 2] * wo[..., 2] > 0
    f = torch.where(same_side[..., None], f_r, f_t)
    valid = torch.abs(wi[..., 2]) > 1e-7
    return torch.where(valid[..., None], torch.clamp_min(f, 0.0), 0.0)


def _hk_scatter_prob(p, wi):
    """Probability of sampling the scattering lobe; the rest goes to the
    delta transmission, by the unscattered transmittance's luminance."""
    pd = luminance(_hk_delta_t(p, wi))
    return torch.clamp(1.0 - pd, 1e-3, 1.0)


def _hk_pdf(p, wi, wo):
    return _hk_scatter_prob(p, wi) * _hk_phase(p, wi, wo)


def _roughdiffuse_eval(p: MatParams, wi, wo):
    """Oren-Nayar (roughdiffuse.cpp's qualitative model); sampled and its
    pdf taken as the cosine hemisphere's."""
    sigma2 = p.alpha * p.alpha
    A = 1.0 - sigma2 / (2.0 * (sigma2 + 0.33))
    B = 0.45 * sigma2 / (sigma2 + 0.09)
    ci, co = wi[..., 2], wo[..., 2]
    si = torch.sqrt(torch.clamp_min(1 - ci * ci, 0.0))
    so = torch.sqrt(torch.clamp_min(1 - co * co, 0.0))
    cos_dphi = torch.where(
        (si > 1e-4) & (so > 1e-4),
        (wi[..., 0] * wo[..., 0] + wi[..., 1] * wo[..., 1]) /
        torch.clamp_min(si * so, 1e-9), 0.0)
    sin_alpha = torch.maximum(si, so)
    tan_beta = torch.minimum(si / torch.clamp_min(ci, 1e-4),
                             so / torch.clamp_min(co, 1e-4))
    f = (p.reflectance * INV_PI *
         (A + B * torch.clamp_min(cos_dphi, 0.0) * sin_alpha *
          tan_beta)[..., None] * torch.clamp_min(co, 0.0)[..., None])
    valid = (ci > 0) & (co > 0)
    return torch.where(valid[..., None], f, 0.0)


def _phong_eval(p: MatParams, wi, wo):
    """Modified Phong (phong.cpp): alpha is the exponent."""
    n = p.alpha
    cos_r = torch.clamp_min(m.dot(_reflect_local(wi), wo), 0.0)
    spec = p.specular * ((n + 2) * INV_PI * 0.5 * torch.pow(cos_r, n) *
                         torch.clamp_min(wo[..., 2], 0.0))[..., None]
    diff = p.reflectance * INV_PI * torch.clamp_min(wo[..., 2],
                                                    0.0)[..., None]
    valid = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    return torch.where(valid[..., None], spec + diff, 0.0)


def _phong_pdf(p, wi, wo):
    n = p.alpha
    cos_r = torch.clamp_min(m.dot(_reflect_local(wi), wo), 0.0)
    pdf_s = (n + 1) * INV_PI * 0.5 * torch.pow(cos_r, n)
    sw = p.spec_weight
    valid = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    return torch.where(valid, sw * pdf_s + (1 - sw) * _diffuse_pdf(p, wi, wo),
                       0.0)


def _ward_spec_terms(p: MatParams, wi, wo):
    """The classic Ward lobe (ward.cpp variant 'ward', Walter 2005's
    sampling notes): (f_spec scalar, pdf_spec, valid)."""
    ax = torch.clamp_min(p.alpha, 1e-4)
    ay = torch.clamp_min(p.alpha_v, 1e-4)
    h = wi + wo
    hz2 = torch.clamp_min(h[..., 2] * h[..., 2], 1e-12)
    expo = torch.exp(-((h[..., 0] / ax) ** 2 + (h[..., 1] / ay) ** 2) / hz2)
    ci = torch.clamp_min(wi[..., 2], 1e-6)
    co = torch.clamp_min(wo[..., 2], 1e-6)
    f_spec = expo / (4.0 * math.pi * ax * ay * torch.sqrt(ci * co))
    # p(h) = exp(.) / (pi ax ay cos^3 th); p(wo) = p(h) / (4 |h.wo|)
    hlen = torch.sqrt(torch.clamp_min((h * h).sum(-1), 1e-12))
    cos_h3 = torch.clamp_min(h[..., 2] / hlen, 0.0) ** 3
    hdwo = torch.abs((h * wo).sum(-1)) / hlen
    p_h = expo / (math.pi * ax * ay * torch.clamp_min(cos_h3, 1e-9))
    pdf_spec = p_h / torch.clamp_min(4.0 * hdwo, 1e-9)
    valid = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    return f_spec, pdf_spec, valid


def _ward_eval(p: MatParams, wi, wo):
    f_spec, _, valid = _ward_spec_terms(p, wi, wo)
    co = torch.clamp_min(wo[..., 2], 0.0)
    out = (p.specular * f_spec[..., None] +
           p.reflectance * INV_PI) * co[..., None]
    return torch.where(valid[..., None], out, 0.0)


def _ward_pdf(p: MatParams, wi, wo):
    _, pdf_spec, valid = _ward_spec_terms(p, wi, wo)
    sw = p.spec_weight
    out = sw * pdf_spec + (1 - sw) * _diffuse_pdf(p, wi, wo)
    return torch.where(valid, out, 0.0)


def _ward_sample_h(p: MatParams, u2):
    """The Ward half vector (Walter 2005, eq. 6-7)."""
    ax = torch.clamp_min(p.alpha, 1e-4)
    ay = torch.clamp_min(p.alpha_v, 1e-4)
    phi_iso = 2.0 * math.pi * u2[..., 1]
    phi = torch.atan2(ay * torch.sin(phi_iso), ax * torch.cos(phi_iso))
    cp, sp = torch.cos(phi), torch.sin(phi)
    tan2 = -torch.log(torch.clamp_min(u2[..., 0], 1e-9)) / \
        torch.clamp_min((cp / ax) ** 2 + (sp / ay) ** 2, 1e-12)
    cos_t = 1.0 / torch.sqrt(1.0 + tan2)
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t ** 2, 0.0))
    return torch.stack([sin_t * cp, sin_t * sp, cos_t], -1)


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
    when lit from the back and the material is two-sided; the
    dielectrics, null, difftrans and hk rows handle signed cosines
    themselves and are never flipped."""
    k = p.kind
    handles_sign = ((k == DIELECTRIC) | (k == THIN_DIELECTRIC) |
                    (k == ROUGH_DIELECTRIC) | (k == NULL_BSDF) |
                    (k == DIFFTRANS) | (k == HK))
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


def _bare(p: MatParams):
    """The lane's own (first-child) params without the wrapper fields."""
    return p._replace(blend=None, coat=None)


def _children(p: MatParams, shape):
    """A blend's two children as one record of lanes (the lane's own
    params, then MatParams.blend) concatenated along the first axis, each
    broadcast to the call's lane shape: one dispatch evaluates both, so
    the host issues each kind's operations once instead of twice, and
    every lane computes what it computed alone."""
    nd = p.kind.dim()
    bare = p._replace(blend=None, coat=None, coat_eta=None,
                      coat_sigma=None, coat_spec=None, coat_alpha=None,
                      coat_dist=None)
    return tree_map(lambda a, b: torch.cat([a.expand(shape + a.shape[nd:]),
                                            b.expand(shape + b.shape[nd:])]),
                    bare, p.blend)


def _twice(x, shape, trailing=1):
    """x broadcast to the lane shape (its last `trailing` axes kept) and
    repeated along the first axis, beside _children."""
    x = x.expand(shape + x.shape[x.dim() - trailing:])
    return torch.cat([x, x])


def _lanes(p: MatParams, *xs):
    """The lane shape of a call: p's broadcast against the direction /
    sample tensors xs (each with one trailing axis)."""
    return torch.broadcast_shapes(p.kind.shape, *(x.shape[:-1] for x in xs))


# ---------------------------------------------------------------------------
# Coating layer (coating.cpp / roughcoating.cpp): a dielectric slab with
# absorption over the child row.  Directions refract into the layer
# before the child's dispatch; the layer adds a reflection lobe (delta for
# a smooth layer, microfacet for a rough one).
# ---------------------------------------------------------------------------

def _coat_in(w, inv_eta):
    """Refract a local direction INTO the (denser) layer, hemisphere
    kept; always succeeds going in."""
    sin2_t = torch.clamp(1.0 - w[..., 2] ** 2, 0.0, 1.0) * inv_eta ** 2
    cos_t = torch.sqrt(torch.clamp_min(1.0 - sin2_t, 0.0))
    return torch.stack([w[..., 0] * inv_eta, w[..., 1] * inv_eta,
                        torch.sign(w[..., 2]) * cos_t], -1)


def _coat_out(w, eta):
    """Refract a local direction OUT of the layer: (wo, valid), invalid
    on total internal reflection."""
    sin2_t = torch.clamp(1.0 - w[..., 2] ** 2, 0.0, 1.0) * eta ** 2
    cos_t = torch.sqrt(torch.clamp_min(1.0 - sin2_t, 0.0))
    wo = torch.stack([w[..., 0] * eta, w[..., 1] * eta,
                      torch.sign(w[..., 2]) * cos_t], -1)
    return m.normalize(wo), sin2_t < 1.0


def _coat_absorption(p, wi_c, wo_c):
    tau = (1.0 / torch.clamp_min(torch.abs(wi_c[..., 2:3]), 1e-4) +
           1.0 / torch.clamp_min(torch.abs(wo_c[..., 2:3]), 1e-4))
    return torch.exp(-p.coat_sigma * tau)


def _coat_spec_prob(p, wi):
    """(Fi, probability of sampling the layer's reflection): the
    specular sampling weight of coating.cpp."""
    Fi, _ = fresnel_dielectric(torch.abs(wi[..., 2]), p.coat_eta)
    s_lum = luminance(p.coat_spec)
    d_lum = luminance(p.reflectance)
    sw = s_lum / torch.clamp_min(s_lum + d_lum, 1e-9)
    return Fi, (Fi * sw) / torch.clamp_min(Fi * sw + (1 - Fi) * (1 - sw),
                                           1e-9)


def _coat_flip(wi, wo):
    """Both local directions flipped into wi's upper hemisphere (the
    layer boundary is two-sided)."""
    s = torch.sign(wi[..., 2:3])
    fl = torch.cat([torch.ones_like(s), torch.ones_like(s), s], -1)
    return wi * fl, wo * fl


def _coat_layer_eval(p, wi, wo):
    """f*cos of the rough layer's microfacet reflection (roughcoating.cpp,
    dielectric Fresnel); 0 where the layer is smooth (its delta lobe is
    left out of eval like every delta lobe)."""
    wif, wof = _coat_flip(wi, wo)
    h, hlen = _half_vector(wif, wof)
    D = mf_D(h, p.coat_alpha, p.coat_dist)
    G = mf_G(wif, wof, h, p.coat_alpha, p.coat_dist)
    F, _ = fresnel_dielectric(torch.abs(m.dot(wif, h)), p.coat_eta)
    ci = wif[..., 2]
    spec = ((D * G * F / torch.clamp_min(4.0 * ci, 1e-9))[..., None] *
            p.coat_spec)
    valid = ((ci > 1e-6) & (wof[..., 2] > 1e-6) & (hlen > 1e-12) &
             (p.coat_alpha > _ROUGH_LAYER_MIN))
    return torch.where(valid[..., None], spec, 0.0)


def _coat_layer_pdf(p, wi, wo):
    """Half-vector sampling pdf of the rough layer lobe (dwh -> dwo)."""
    wif, wof = _coat_flip(wi, wo)
    h, _ = _half_vector(wif, wof)
    jac = 1.0 / torch.clamp_min(4.0 * torch.abs(m.dot(wof, h)), 1e-9)
    valid = ((wif[..., 2] > 1e-6) & (wof[..., 2] > 1e-6) &
             (p.coat_alpha > _ROUGH_LAYER_MIN))
    return torch.where(valid, mf_pdf(h, p.coat_alpha, p.coat_dist) * jac,
                       0.0)


def _coat_crossing(p, wi, wo):
    """(wi, wo refracted into the layer, the solid-angle compression
    inv_eta^2 |cos_o| / |cos_o in the layer|)."""
    inv_eta = 1.0 / p.coat_eta
    wi_c = _coat_in(wi, inv_eta)
    wo_c = _coat_in(wo, inv_eta)
    comp = (inv_eta ** 2 * torch.abs(wo[..., 2]) /
            torch.clamp_min(torch.abs(wo_c[..., 2]), 1e-6))
    return wi_c, wo_c, comp


def _coating_eval(p, wi, wo, kinds):
    """f*cos of the coated child plus, for a rough layer, the layer's
    microfacet reflection."""
    Fi, _ = fresnel_dielectric(torch.abs(wi[..., 2]), p.coat_eta)
    Fo, _ = fresnel_dielectric(torch.abs(wo[..., 2]), p.coat_eta)
    wi_c, wo_c, comp = _coat_crossing(p, wi, wo)
    f_in = eval(_bare(p), wi_c, wo_c, kinds)
    f = (f_in * ((1.0 - Fi) * (1.0 - Fo) * comp)[..., None] *
         _coat_absorption(p, wi_c, wo_c))
    if ROUGH_COAT in kinds:
        f = f + _coat_layer_eval(p, wi, wo)
    return f


def _coating_pdf(p, wi, wo, kinds):
    _, prob_spec = _coat_spec_prob(p, wi)
    wi_c, wo_c, comp = _coat_crossing(p, wi, wo)
    out = (1.0 - prob_spec) * pdf(_bare(p), wi_c, wo_c, kinds) * comp
    if ROUGH_COAT in kinds:
        # a rough layer's reflection lobe has a density
        out = out + prob_spec * _coat_layer_pdf(p, wi, wo)
    return out


def _coating_sample(p, wi, u2, u_comp, kinds):
    """The layer's reflection with probability prob_spec, else the child
    sampled inside the layer and refracted back out (total internal
    reflection kills the sample)."""
    Fi, prob_spec = _coat_spec_prob(p, wi)
    pick_spec = u_comp < prob_spec
    u_re = torch.clamp(torch.where(
        pick_spec, u_comp / torch.clamp_min(prob_spec, 1e-9),
        (u_comp - prob_spec) / torch.clamp_min(1.0 - prob_spec, 1e-9)),
        0.0, 1.0)

    # the child's lobe, sampled with the refracted incoming direction
    wi_c = _coat_in(wi, 1.0 / p.coat_eta)
    s_in = sample(_bare(p), wi_c, u2, u_re, kinds)
    wo_out, out_ok = _coat_out(s_in.wo, p.coat_eta)
    Fo, _ = fresnel_dielectric(torch.abs(wo_out[..., 2]), p.coat_eta)
    absorp = _coat_absorption(p, wi_c, s_in.wo)
    nested_valid = s_in.valid & out_ok
    # a smooth child sample weighs by the coating's own eval / pdf (one
    # sample MIS over the lobes); a delta one keeps its weight times the
    # crossing terms, and its pdf takes the pick probability
    f_c = _coating_eval(p, wi, wo_out, kinds)
    pdf_c = _coating_pdf(p, wi, wo_out, kinds)
    w_smooth = f_c / torch.clamp_min(pdf_c, 1e-12)[..., None]
    w_delta_in = (s_in.weight * absorp *
                  ((1.0 - Fi) * (1.0 - Fo) /
                   torch.clamp_min(1.0 - prob_spec, 1e-9))[..., None])
    nested_w = torch.where(s_in.is_delta[..., None], w_delta_in, w_smooth)
    nested_pdf = torch.where(s_in.is_delta, (1.0 - prob_spec) * s_in.pdf,
                             pdf_c)

    # the layer's reflection: a delta mirror for a smooth layer, a
    # microfacet half-vector sample for a rough one (u2 is free here:
    # the child sample it fed is discarded on this branch)
    wo_spec = _reflect_local(wi)
    w_spec = p.coat_spec * (Fi / torch.clamp_min(prob_spec, 1e-9))[..., None]
    pdf_spec = prob_spec
    spec_valid = prob_spec > 0
    spec_delta = torch.ones_like(pick_spec)
    if ROUGH_COAT in kinds:
        rough = p.coat_alpha > _ROUGH_LAYER_MIN
        fl = _zflip(torch.ones_like(wi), torch.sign(wi[..., 2]))
        wif = wi * fl
        m_h = mf_sample(u2, p.coat_alpha, p.coat_dist)
        wo_r = (2.0 * m.dot(wif, m_h, keepdims=True) * m_h - wif) * fl
        f_r = _coating_eval(p, wi, wo_r, kinds)
        pdf_r = _coating_pdf(p, wi, wo_r, kinds)
        w_r = f_r / torch.clamp_min(pdf_r, 1e-12)[..., None]
        valid_r = (pdf_r > 0) & (wo_r[..., 2] * wi[..., 2] > 0)
        wo_spec = torch.where(rough[..., None], wo_r, wo_spec)
        w_spec = torch.where(rough[..., None], w_r, w_spec)
        pdf_spec = torch.where(rough, pdf_r, pdf_spec)
        spec_valid = torch.where(rough, valid_r, spec_valid)
        spec_delta = ~rough

    valid = torch.where(pick_spec, spec_valid, nested_valid)
    weight = torch.where(pick_spec[..., None], w_spec, nested_w)
    return BSDFSample(
        wo=torch.where(pick_spec[..., None], wo_spec, wo_out),
        weight=torch.where(valid[..., None], weight, 0.0),
        pdf=torch.where(pick_spec, pdf_spec, nested_pdf),
        is_delta=torch.where(pick_spec, spec_delta, s_in.is_delta),
        eta=torch.ones_like(Fi), valid=valid)


def _irawan_eval(p, wi, wo):
    from .irawan import eval_cloth
    return eval_cloth(p, wi, wo)


# smooth-lobe eval / pdf of each non-diffuse kind, in the reference's
# dispatch order (rough diffuse samples and has the diffuse pdf)
_EVALS = ((ROUGH_DIFFUSE, _roughdiffuse_eval),
          (ROUGH_CONDUCTOR, _roughconductor_eval),
          (ROUGH_PLASTIC, _roughplastic_eval),
          (PHONG, _phong_eval),
          (WARD, _ward_eval),
          (PLASTIC, _plastic_eval_diffuse),
          (ROUGH_DIELECTRIC, _roughdielectric_eval),
          (DIFFTRANS, _difftrans_eval),
          (HK, _hk_eval),
          (IRAWAN, _irawan_eval))
_PDFS = ((ROUGH_CONDUCTOR, _roughconductor_pdf),
         (ROUGH_PLASTIC, _roughplastic_pdf),
         (PHONG, _phong_pdf),
         (WARD, _ward_pdf),
         (PLASTIC, _plastic_pdf),
         (ROUGH_DIELECTRIC, _roughdielectric_pdf),
         (DIFFTRANS, _difftrans_pdf),
         (HK, _hk_pdf))


def eval(p: MatParams, wi, wo, kinds=None):
    """f(wi,wo)*|cos_o| of the smooth lobes; 0 on delta-only rows
    (conductor, dielectric, thin dielectric, null).  With the wrapper
    fields set: blendbsdf's (1-w) f_child0 + w f_child1 (lanes that are
    not blends carry w = 0 and child0 = their own row), the coating on
    COATING lanes."""
    _check_kinds(kinds)
    if p.blend is not None:
        w = p.blend_w[..., None]
        sh = _lanes(p, wi, wo)
        f0, f1 = eval(_children(p, sh), _twice(wi, sh), _twice(wo, sh),
                      kinds).chunk(2)
        f = (1.0 - w) * f0 + w * f1
        if p.coat is not None and COATING in kinds:
            f = torch.where(p.coat[..., None],
                            _coating_eval(p, wi, wo, kinds), f)
        return f
    sign = _flip_sign(p, wi)
    wi, wo = _zflip(wi, sign), _zflip(wo, sign)
    out = _diffuse_eval(p, wi, wo)
    for kk, f in _EVALS:
        if kk in kinds:
            out = torch.where((p.kind == kk)[..., None], f(p, wi, wo), out)
    if OPACITY in kinds:
        out = out * p.opacity[..., None]  # mask: f = opacity * f_nested
    delta = _delta_only(p, kinds)
    if delta is not None:
        out = torch.where(delta[..., None], 0.0, out)
    return out


def pdf(p: MatParams, wi, wo, kinds=None):
    """Solid-angle pdf of sample() restricted to the smooth lobes; 0 on
    delta-only rows.  Wrappers as in eval."""
    _check_kinds(kinds)
    if p.blend is not None:
        w = p.blend_w
        sh = _lanes(p, wi, wo)
        p0, p1 = pdf(_children(p, sh), _twice(wi, sh), _twice(wo, sh),
                     kinds).chunk(2)
        out = (1.0 - w) * p0 + w * p1
        if p.coat is not None and COATING in kinds:
            out = torch.where(p.coat, _coating_pdf(p, wi, wo, kinds), out)
        return out
    sign = _flip_sign(p, wi)
    wi, wo = _zflip(wi, sign), _zflip(wo, sign)
    out = _diffuse_pdf(p, wi, wo)
    for kk, f in _PDFS:
        if kk in kinds:
            out = torch.where(p.kind == kk, f(p, wi, wo), out)
    if OPACITY in kinds:
        out = out * p.opacity  # mask: the continuous share
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


def _blend_sample(p: MatParams, wi, u2, u_comp, kinds):
    """blendbsdf: pick a child with probability (1-w, w), sample it, and
    weight by the mixture's eval / pdf (one-sample MIS); a delta child's
    pick probability cancels against its lobe weight, so its own weight
    is exact."""
    w = torch.clamp(p.blend_w, 0.0, 1.0)
    pick1 = u_comp < w
    u_re = torch.clamp(torch.where(
        pick1, u_comp / torch.clamp_min(w, 1e-9),
        (u_comp - w) / torch.clamp_min(1.0 - w, 1e-9)), 0.0, 1.0)
    sh = _lanes(p, wi, u2)
    s2 = sample(_children(p, sh), _twice(wi, sh), _twice(u2, sh),
                _twice(u_re, sh, 0), kinds)
    s0 = BSDFSample(*(a.chunk(2)[0] for a in s2))
    s1 = BSDFSample(*(a.chunk(2)[1] for a in s2))
    pick3 = pick1[..., None]
    wo = torch.where(pick3, s1.wo, s0.wo)
    is_delta = torch.where(pick1, s1.is_delta, s0.is_delta)
    valid = torch.where(pick1, s1.valid, s0.valid)
    pdf_mix = pdf(p, wi, wo, kinds)
    weight = torch.where(
        is_delta[..., None], torch.where(pick3, s1.weight, s0.weight),
        eval(p, wi, wo, kinds) / torch.clamp_min(pdf_mix, 1e-12)[..., None])
    pdf_out = torch.where(
        is_delta, torch.where(pick1, w, 1.0 - w) *
        torch.where(pick1, s1.pdf, s0.pdf), pdf_mix)
    return BSDFSample(wo=wo, weight=torch.where(valid[..., None], weight, 0.0),
                      pdf=pdf_out, is_delta=is_delta,
                      eta=torch.where(pick1, s1.eta, s0.eta), valid=valid)


def sample(p: MatParams, wi, u2, u_comp, kinds=None) -> BSDFSample:
    """Sample an outgoing direction.  u2: [N,2] (the diffuse lobe's
    cosine-hemisphere draw, the microfacet normal's, Phong's or Ward's
    lobe draw, or the HK phase function's), u_comp: [N] (the choice of
    lobe: reflection u_comp <= F or transmission for the dielectrics,
    specular u_comp < prob_spec or diffuse for the plastics, Phong and
    Ward, scattering or delta transmission for hk; a mask passes through
    where u_comp >= opacity and rescales u_comp for the rest).
    Conductor rows mirror (weight specular * F, pdf 1), dielectric rows
    reflect (weight specular, pdf F) or refract (weight transmittance /
    eta^2, pdf 1 - F, eta the relative IOR), thin dielectric rows
    reflect or pass straight through with the two-interface reflectance
    R' = R + (1-R)^2 R / (1 - R^2) (weight specular or transmittance),
    null rows pass straight through (wo = -wi, weight 1, pdf 1): all
    delta, as are plastic's specular lobe, hk's unscattered
    transmission and a mask's pass-through (pdf = their pick
    probability).  The other lobes weight by eval / pdf."""
    _check_kinds(kinds)
    if p.blend is not None:
        out = _blend_sample(p, wi, u2, u_comp, kinds)
        if p.coat is not None and COATING in kinds:
            sc = _coating_sample(p, wi, u2, u_comp, kinds)
            out = BSDFSample(*(
                torch.where(p.coat.reshape(p.coat.shape + (1,) *
                                           (a.dim() - p.coat.dim())), a, b)
                for a, b in zip(sc, out)))
        return out
    sign = _flip_sign(p, wi)
    wif = _zflip(wi, sign)
    k = p.kind
    if OPACITY in kinds:
        # mask.cpp: pass straight through with probability 1 - opacity
        op_m = torch.clamp(p.opacity, 0.0, 1.0)
        pass_m = u_comp >= op_m
        u_comp = torch.clamp(u_comp / torch.clamp_min(op_m, 1e-9), 0.0, 1.0)
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

    def by_eval(kk, wo_k, f_eval, f_pdf):
        """A smooth lobe weighted by its own eval / pdf."""
        pdf_k = f_pdf(p, wif, wo_k)
        w_k = f_eval(p, wif, wo_k) / torch.clamp_min(pdf_k, 1e-12)[..., None]
        pick(kk, wo_k, w_k, pdf_k,
             (wo_k[..., 2] > 0) & (wif[..., 2] > 0) & (pdf_k > 0),
             delta_k=False)

    one = torch.ones_like(pdf_out)
    if ROUGH_DIFFUSE in kinds:
        pick(ROUGH_DIFFUSE, wo_d,
             _roughdiffuse_eval(p, wif, wo_d) /
             torch.clamp_min(pdf_d, 1e-12)[..., None], pdf_d,
             (wif[..., 2] > 0) & (wo_d[..., 2] > 0), delta_k=False)
    if IRAWAN in kinds:
        # irawan.cpp samples the cosine hemisphere
        pick(IRAWAN, wo_d,
             _irawan_eval(p, wif, wo_d) /
             torch.clamp_min(pdf_d, 1e-12)[..., None], pdf_d,
             (wif[..., 2] > 0) & (wo_d[..., 2] > 0), delta_k=False)
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
    if THIN_DIELECTRIC in kinds:
        # two-interface reflectance R' = R + TRT + ... (thindielectric.cpp)
        F_raw, _ = fresnel_dielectric(torch.abs(wi[..., 2]), eta_s)
        F_t = torch.where(
            F_raw < 1.0, F_raw + (1 - F_raw) ** 2 * F_raw /
            torch.clamp_min(1 - F_raw ** 2, 1e-9), 1.0)
        refl_t = u_comp <= F_t
        pdf_t = torch.where(refl_t, F_t, 1.0 - F_t)
        pick(THIN_DIELECTRIC,
             torch.where(refl_t[..., None], _reflect_local(wi), -wi),
             torch.where(refl_t[..., None], p.specular, p.transmittance),
             pdf_t, pdf_t > 0)
    if ROUGH_CONDUCTOR in kinds or ROUGH_PLASTIC in kinds:
        m_h = mf_sample(u2, p.alpha, p.dist)
        wo_rc = 2.0 * m.dot(wif, m_h, keepdims=True) * m_h - wif
    if ROUGH_CONDUCTOR in kinds:
        by_eval(ROUGH_CONDUCTOR, wo_rc, _roughconductor_eval,
                _roughconductor_pdf)
    if ROUGH_PLASTIC in kinds:
        prob_rp = torch.clamp(_spec_prob(p, wif)[0], 0.0, 1.0)
        by_eval(ROUGH_PLASTIC,
                torch.where((u_comp < prob_rp)[..., None], wo_rc, wo_d),
                _roughplastic_eval, _roughplastic_pdf)
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
    sw = p.spec_weight
    if PHONG in kinds:
        cos_a = torch.pow(torch.clamp_min(u2[..., 0], 1e-12),
                          1.0 / (p.alpha + 1))
        sin_a = torch.sqrt(torch.clamp_min(1 - cos_a ** 2, 0.0))
        phi = 2 * math.pi * u2[..., 1]
        lobe = torch.stack([sin_a * torch.cos(phi), sin_a * torch.sin(phi),
                            cos_a], -1)
        wr = _reflect_local(wif)
        s_ax, t_ax = m.build_frame(wr)
        by_eval(PHONG,
                torch.where((u_comp < sw)[..., None],
                            m.to_world(lobe, s_ax, t_ax, wr), wo_d),
                _phong_eval, _phong_pdf)
    if WARD in kinds:
        h_w = _ward_sample_h(p, u2)
        wo_ws = 2.0 * m.dot(wif, h_w)[..., None] * h_w - wif
        by_eval(WARD, torch.where((u_comp < sw)[..., None], wo_ws, wo_d),
                _ward_eval, _ward_pdf)
    if ROUGH_DIELECTRIC in kinds:
        wo_rd, w_rd, pdf_rd, valid_rd, eta_rd = _roughdielectric_sample(
            p, wi, u2, u_comp)
        pick(ROUGH_DIELECTRIC, wo_rd, w_rd, pdf_rd, valid_rd, eta_rd,
             delta_k=False)
    if DIFFTRANS in kinds:
        # the cosine hemisphere on the side OPPOSITE wi (difftrans.cpp)
        pick(DIFFTRANS,
             _zflip(wo_d, torch.where(wi[..., 2] > 0, -1.0, 1.0)),
             p.reflectance, pdf_d, torch.abs(wi[..., 2]) > 1e-7,
             delta_k=False)
    if HK in kinds:
        # hk.cpp: the unscattered (delta) transmission with the slab
        # transmittance's luminance, else the phase function around the
        # propagation -wi over the whole sphere (reflection and
        # scattered transmission)
        ps_hk = _hk_scatter_prob(p, wi)
        delta_hk = u_comp >= ps_hk
        kind_ph = torch.where(torch.abs(p.alpha_v) < 1e-4, PHASE_ISOTROPIC,
                              PHASE_HG)
        wo_ph, pdf_ph = medium.phase_sample(kind_ph, p.alpha_v, wi, u2)
        pdf_sc = ps_hk * torch.clamp_min(pdf_ph, 1e-12)
        w_sc = _hk_eval(p, wi, wo_ph) / pdf_sc[..., None]
        pd_hk = 1.0 - ps_hk
        w_dt = _hk_delta_t(p, wi) / torch.clamp_min(pd_hk, 1e-9)[..., None]
        pdf_hk = torch.where(delta_hk, pd_hk, pdf_sc)
        pick(HK, torch.where(delta_hk[..., None], -wi, wo_ph),
             torch.where(delta_hk[..., None], w_dt, w_sc), pdf_hk,
             (torch.abs(wi[..., 2]) > 1e-7) & (pdf_hk > 0),
             delta_k=delta_hk)
    if NULL_BSDF in kinds:
        pick(NULL_BSDF, -wi, torch.ones_like(weight), one,
             torch.ones_like(valid))
    # un-flip back to the true frame (the sign-handling rows were never
    # flipped: their sign is 1)
    wo = _zflip(wo, sign)
    if OPACITY in kinds:
        wo = torch.where(pass_m[..., None], -wi, wo)
        weight = torch.where(pass_m[..., None], 1.0, weight)
        pdf_out = torch.where(pass_m, 1.0 - op_m, pdf_out * op_m)
        eta = torch.where(pass_m, 1.0, eta)
        valid = valid | pass_m
        is_delta = is_delta | pass_m
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
