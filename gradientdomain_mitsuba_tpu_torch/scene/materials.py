"""Material (BSDF) table: plugin nodes -> SoA parameter arrays + enum.

TPU-native replacement for Mitsuba's BSDF plugin instantiation
(src/bsdfs/*.cpp): instead of virtual dispatch per surface interaction, the
wavefront shader does one branch-free enum dispatch over this table.
Conductor presets replace the data/ior/*.spd database for common metals.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

# BSDF kind enum (order is ABI for the dispatch kernels in ops/bsdf.py)
DIFFUSE = 0
CONDUCTOR = 1          # smooth mirror-metal
DIELECTRIC = 2         # smooth glass
ROUGH_CONDUCTOR = 3
PLASTIC = 4            # smooth coat over diffuse
ROUGH_PLASTIC = 5
ROUGH_DIELECTRIC = 6
THIN_DIELECTRIC = 7
ROUGH_DIFFUSE = 8      # Oren-Nayar
PHONG = 9
WARD = 10
NULL_BSDF = 11
BLEND = 12             # weight-blend of two child rows (blendbsdf.cpp);
#                        mixturebsdf folds into a binary tree of these
COATING = 13           # dielectric layer over a child row (coating.cpp /
#                        roughcoating.cpp): alpha_v stores the LAYER's
#                        microfacet roughness (0 = smooth delta lobe),
#                        dist its distribution; refraction into the layer
#                        is smooth in both variants (as in the reference,
#                        which approximates the rough boundary's
#                        refraction by the smooth one)
DIFFTRANS = 14         # diffuse transmitter (difftrans.cpp)
HK = 15                # Hanrahan-Krueger thin-slab single scattering
#                        (hk.cpp): reflectance stores sigmaS,
#                        transmittance sigmaA, alpha the slab thickness,
#                        alpha_v the HG asymmetry g
IRAWAN = 16            # woven cloth (irawan.cpp): reflectance kd,
#                        specular ks, alpha/alpha_v the repeatU/repeatV,
#                        dist the weave preset id (ops/irawan.py)

KIND_NAMES = {
    "diffuse": DIFFUSE, "conductor": CONDUCTOR, "dielectric": DIELECTRIC,
    "roughconductor": ROUGH_CONDUCTOR, "plastic": PLASTIC,
    "roughplastic": ROUGH_PLASTIC, "roughdielectric": ROUGH_DIELECTRIC,
    "thindielectric": THIN_DIELECTRIC, "roughdiffuse": ROUGH_DIFFUSE,
    "phong": PHONG, "ward": WARD, "null": NULL_BSDF,
    "difftrans": DIFFTRANS, "hk": HK, "irawan": IRAWAN,
}

# microfacet distribution enum
DIST_BECKMANN = 0
DIST_GGX = 1
DIST_PHONG = 2
DIST_NAMES = {"beckmann": DIST_BECKMANN, "ggx": DIST_GGX,
              "phong": DIST_PHONG, "as": DIST_BECKMANN}

# flags bitfield
FLAG_TWOSIDED = 1

# Named dielectric IORs (subset of Mitsuba's lookupIOR table, util.cpp)
IOR_NAMES = {
    "vacuum": 1.0, "air": 1.000277, "helium": 1.000036,
    "water": 1.3330, "water ice": 1.31, "ethanol": 1.361,
    "fused quartz": 1.458, "pyrex": 1.470, "acrylic glass": 1.49,
    "polypropylene": 1.49, "bk7": 1.5046, "sodium chloride": 1.544,
    "amber": 1.55, "pet": 1.575, "diamond": 2.419,
    "benzene": 1.501, "glycerol": 1.4729, "bromine": 1.661,
}

# Conductor presets: (eta_rgb, k_rgb) — standard tabulated values averaged
# to sRGB primaries (stand-in for data/ior/<name>.eta.spd / .k.spd).
CONDUCTOR_PRESETS = {
    "cu": ((0.200438, 0.924033, 1.102212), (3.912949, 2.447867, 2.142188)),
    "au": ((0.143119, 0.374957, 1.442479), (3.983126, 2.385721, 1.603215)),
    "ag": ((0.155184, 0.116475, 0.138372), (4.828131, 3.122411, 2.146812)),
    "al": ((1.657460, 0.880369, 0.521229), (9.223869, 6.269523, 4.837001)),
    "cr": ((4.361113, 2.910425, 1.650794), (5.196218, 4.222426, 3.746025)),
    "ni": ((2.361108, 1.663935, 1.467325), (4.498536, 3.051379, 2.344902)),
    "w":  ((4.367642, 3.300089, 2.431462), (3.500774, 2.601543, 2.273448)),
    "none": ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0)),  # ideal mirror
}


class Materials(NamedTuple):
    """SoA table over M materials (device arrays after compile).

    `packed` mirrors the scalar/vector fields as one [M, 32] f32 row so the
    per-interaction parameter fetch is a single gather (ops/bsdf.py):
    [0] kind, [1] flags, [2:5] reflectance, [5:8] specular,
    [8:11] transmittance, [11] alpha, [12:15] eta, [15:18] k, [18] dist,
    [19] fdr_int, [20] tex_reflectance, [21] alpha_v, [22] opacity,
    [23] tex_opacity, [24] blend child0, [25] blend child1,
    [26] blend weight, [27] blend weight texture,
    [28] normal-perturb mode (0/1=bump/2=normal), [29] perturb texture,
    [30] perturb scale.
    """
    packed: np.ndarray        # [M, 28] f32 (32 when perturbation bound)
    kind: np.ndarray          # [M] i32
    flags: np.ndarray         # [M] i32 (FLAG_* bits)
    reflectance: np.ndarray   # [M, 3] diffuse albedo / specular tint
    specular: np.ndarray      # [M, 3] specularReflectance scale
    transmittance: np.ndarray  # [M, 3] specularTransmittance scale
    alpha: np.ndarray         # [M] roughness (or Oren-Nayar sigma / phong exp)
    eta: np.ndarray           # [M, 3] conductor n / dielectric eta in [:,0]
    k: np.ndarray             # [M, 3] conductor absorption
    dist: np.ndarray          # [M] i32 microfacet distribution
    tex_reflectance: np.ndarray  # [M] i32 texture id or -1
    fdr_int: np.ndarray       # [M] internal diffuse Fresnel reflectance (plastic)


def _lookup_ior(v, default):
    if v is None:
        return default
    if isinstance(v, str):
        return IOR_NAMES[v.lower()]
    if isinstance(v, np.ndarray):
        return float(np.mean(v))
    return float(v)


def fresnel_diffuse_reflectance(eta: float) -> float:
    """Average Fresnel reflectance for diffuse illumination (Mitsuba's
    fresnelDiffuseReflectance, libcore/util.cpp fast approximation)."""
    if eta < 1.0:
        return (-0.4399 + 0.7099 / eta - 0.3319 / (eta * eta)
                + 0.0636 / (eta * eta * eta))
    inv_eta = 1.0 / eta
    inv_eta2 = inv_eta * inv_eta
    inv_eta3 = inv_eta2 * inv_eta
    inv_eta4 = inv_eta3 * inv_eta
    inv_eta5 = inv_eta4 * inv_eta
    return (0.919317 - 3.4793 * inv_eta + 6.75335 * inv_eta2
            - 7.80989 * inv_eta3 + 4.98554 * inv_eta4 - 1.36881 * inv_eta5)


class MaterialBuilder:
    """Accumulates BSDF plugin nodes into the SoA table, deduplicating by id."""

    def __init__(self):
        self.rows = []
        self.by_node = {}
        self.texture_nodes = []   # texture plugin nodes, resolved later
        # bumpmap/normalmap: material id -> (mode 1|2, tex id, scale);
        # consumed by the shading-normal perturbation in
        # ops/common.fill_intersection (src/bsdfs/{bumpmap,normalmap}.cpp)
        self.perturb = {}

    def default_id(self):
        """Material used for shapes with no BSDF (Mitsuba default: diffuse 0.5)."""
        return self.add_row(kind=DIFFUSE, reflectance=(0.5, 0.5, 0.5))

    def add_row(self, kind, flags=0, reflectance=(0.5, 0.5, 0.5),
                specular=(1, 1, 1), transmittance=(1, 1, 1), alpha=0.1,
                eta=(1.5046, 1.5046, 1.5046), k=(0, 0, 0), dist=DIST_BECKMANN,
                tex_reflectance=-1, fdr_int=0.0, alpha_v=None,
                opacity=1.0, tex_opacity=-1, child0=-1, child1=-1,
                blend_w=0.5, tex_blend=-1):
        self.rows.append(dict(
            kind=kind, flags=flags, reflectance=np.asarray(reflectance, np.float32),
            specular=np.asarray(specular, np.float32),
            transmittance=np.asarray(transmittance, np.float32),
            alpha=float(alpha), eta=np.asarray(eta, np.float32),
            k=np.asarray(k, np.float32), dist=dist,
            tex_reflectance=tex_reflectance, fdr_int=float(fdr_int),
            alpha_v=float(alpha if alpha_v is None else alpha_v),
            opacity=float(opacity), tex_opacity=tex_opacity,
            child0=int(child0), child1=int(child1),
            blend_w=float(blend_w), tex_blend=int(tex_blend)))
        return len(self.rows) - 1

    def _row_roughness(self, rid):
        """Host-side shift-classification roughness of a built row
        (mirrors ops/bsdf.roughness)."""
        r = self.rows[rid]
        kind = r["kind"]
        if kind in (CONDUCTOR, DIELECTRIC, THIN_DIELECTRIC):
            return 0.0
        if kind in (ROUGH_CONDUCTOR, ROUGH_DIELECTRIC, ROUGH_PLASTIC,
                    WARD, BLEND, COATING):
            return r["alpha"]
        return np.inf

    def add_blend(self, c0, c1, weight, tex_blend=-1):
        """BLEND row over two existing rows.  The row's alpha stores the
        MIN of the children's classification roughness so the shift
        machinery treats a part-specular blend as specular."""
        rough = min(self._row_roughness(c0), self._row_roughness(c1))
        return self.add_row(kind=BLEND, alpha=min(rough, 1e30),
                            child0=c0, child1=c1, blend_w=weight,
                            tex_blend=tex_blend)

    def add_texture(self, node) -> int:
        self.texture_nodes.append(node)
        return len(self.texture_nodes) - 1

    def from_plugin(self, node) -> int:
        """BSDF plugin node -> material id (cached per node object; the
        map also PINS the node so id() reuse after GC cannot alias two
        distinct BSDFs to one row)."""
        key = id(node)
        if key in self.by_node:
            return self.by_node[key][0]
        mid = self._build(node, flags=0)
        self.by_node[key] = (mid, node)
        return mid

    def _spectrum_or_texture(self, node, names, default):
        """Returns (rgb, tex_id). `names` is a list of accepted prop aliases."""
        from .ir import spectrum_value
        for n in names:
            v = node.props.get(n)
            if v is None:
                continue
            if hasattr(v, "kind"):  # nested texture plugin
                return np.asarray(default, np.float32), self.add_texture(v)
            return spectrum_value(v), -1
        # unnamed texture child
        for c in node.children:
            if c.kind == "texture":
                return np.asarray(default, np.float32), self.add_texture(c)
        return np.asarray(default, np.float32), -1

    def _build(self, node, flags) -> int:
        t = node.type
        if t == "twosided":
            inner = node.child("bsdf") or next(
                (v for v in node.props.values() if hasattr(v, "kind")
                 and v.kind == "bsdf"), None)
            if inner is None:
                raise ValueError("twosided BSDF without nested BSDF")
            return self._build(inner, flags | FLAG_TWOSIDED)
        if t == "mask":
            # mask.cpp: opacity-weighted mix of the nested BSDF and a
            # delta pass-through.  The nested row is COPIED so a <ref>'d
            # inner BSDF used bare elsewhere keeps opacity 1.
            inner = node.child("bsdf") or next(
                (v for v in node.props.values() if hasattr(v, "kind")
                 and v.kind == "bsdf"), None)
            if inner is None:
                raise ValueError("mask BSDF without nested BSDF")
            rid = self._build(inner, flags)
            import copy as _copy
            row = _copy.deepcopy(self.rows[rid])
            op, optex = self._spectrum_or_texture(
                node, ["opacity"], (0.5, 0.5, 0.5))
            row["opacity"] = float(np.mean(op))
            row["tex_opacity"] = optex
            self.rows.append(row)
            return len(self.rows) - 1
        if t in ("blendbsdf", "mixturebsdf"):
            kids = node.children_of("bsdf") + [
                v for v in node.props.values()
                if hasattr(v, "kind") and v.kind == "bsdf"]
            if len(kids) < 2:
                raise ValueError(f"'{t}' needs >= 2 nested BSDFs")
            rids = [self._build(c, flags) for c in kids]
            if t == "blendbsdf":
                # blendbsdf.cpp: weight w blends child0 (1-w) with child1
                wprop = node.props.get("weight", 0.5)
                if hasattr(wprop, "kind"):  # textured weight
                    return self.add_blend(rids[0], rids[1], 0.5,
                                          tex_blend=self.add_texture(wprop))
                w = float(np.mean(np.asarray(wprop, np.float32)))
                return self.add_blend(rids[0], rids[1], w)
            # mixturebsdf.cpp: N weighted children -> fold into a binary
            # tree of BLEND rows (left fold; weights normalized)
            wstr = node.get("weights")
            ws = ([float(x) for x in str(wstr).replace(",", " ").split()]
                  if wstr is not None else [1.0] * len(rids))
            if len(ws) != len(rids):
                raise ValueError("mixturebsdf: weights/children mismatch")
            tot = sum(ws) or 1.0
            ws = [w / tot for w in ws]
            acc, wacc = rids[0], ws[0]
            for rid, w in zip(rids[1:], ws[1:]):
                denom = wacc + w
                acc = self.add_blend(acc, rid, w / max(denom, 1e-9))
                wacc = denom
            return acc
        if t in ("coating", "roughcoating"):
            # dielectric layer over the nested BSDF (coating.cpp /
            # roughcoating.cpp).  roughcoating gives the layer boundary a
            # microfacet reflection lobe (alpha/distribution); refraction
            # into the layer stays smooth, as in the reference
            inner = node.child("bsdf") or next(
                (v for v in node.props.values() if hasattr(v, "kind")
                 and v.kind == "bsdf"), None)
            if inner is None:
                raise ValueError(f"'{t}' without nested BSDF")
            rid = self._build(inner, flags)
            ext_ior = _lookup_ior(node.get("extIOR"), 1.000277)
            int_ior = _lookup_ior(node.get("intIOR"), 1.5046)
            from .ir import spectrum_value as _sv
            sigma_a = _sv(node.get("sigmaA"), (0.0,) * 3)
            thickness = float(node.get("thickness", 1.0))
            spec = _sv(node.get("specularReflectance"), (1.0,) * 3)
            layer_alpha = (float(node.get("alpha", 0.1))
                           if t == "roughcoating" else 0.0)
            dist = DIST_NAMES.get(node.get("distribution", "beckmann"),
                                  DIST_BECKMANN)
            # shift-classification roughness: the INNER lobe's for a
            # smooth layer (reconnection keeps working on coated-diffuse;
            # a delta-lobe bounce under a diffuse classification just
            # fails its shift cleanly; any_specular() still sees the
            # delta layer), min(inner, layer) for a rough layer
            class_rough = min(self._row_roughness(rid), 1e30)
            if layer_alpha > 0.0:
                class_rough = min(class_rough, layer_alpha)
            return self.add_row(
                kind=COATING, flags=flags,
                alpha=class_rough, alpha_v=layer_alpha, dist=dist,
                eta=(int_ior / ext_ior,) * 3,
                specular=spec,
                transmittance=np.asarray(sigma_a, np.float32) * thickness,
                reflectance=self.rows[rid]["reflectance"],
                child0=rid, child1=rid)
        if t in ("bumpmap", "normalmap"):
            # perturbation handled geometrically
            # (ops/common.fill_intersection); the nested BSDF is the
            # scattering model.
            inner = node.child("bsdf") or next(
                (v for v in node.props.values() if hasattr(v, "kind")
                 and v.kind == "bsdf"), None)
            if inner is None:
                raise ValueError(f"BSDF wrapper '{t}' without nested BSDF")
            rid = self._build(inner, flags)
            if t in ("bumpmap", "normalmap"):
                tex = next((v for v in node.props.values()
                            if hasattr(v, "kind") and v.kind == "texture"),
                           None) or node.child("texture")
                if tex is not None:
                    import copy as _copy
                    row = _copy.deepcopy(self.rows[rid])
                    self.rows.append(row)
                    rid = len(self.rows) - 1
                    self.perturb[rid] = (
                        1 if t == "bumpmap" else 2, self.add_texture(tex),
                        float(node.get("scale", 1.0)))
            return rid
        if t not in KIND_NAMES:
            raise ValueError(f"unsupported BSDF type '{t}'")
        kind = KIND_NAMES[t]

        ext_ior = _lookup_ior(node.get("extIOR"), 1.000277)
        int_ior = _lookup_ior(node.get("intIOR"), 1.5046)
        rel_eta = int_ior / ext_ior
        alpha = float(node.get("alpha", 0.1))
        dist = DIST_NAMES.get(node.get("distribution", "beckmann"),
                              DIST_BECKMANN)
        from .ir import spectrum_value
        spec = spectrum_value(node.get("specularReflectance"), (1, 1, 1))
        trans = spectrum_value(node.get("specularTransmittance"), (1, 1, 1))

        if kind in (DIFFUSE, ROUGH_DIFFUSE):
            refl, tex = self._spectrum_or_texture(
                node, ["reflectance", "diffuseReflectance"], (0.5, 0.5, 0.5))
            sigma = float(node.get("alpha", 0.2)) if kind == ROUGH_DIFFUSE else 0.0
            return self.add_row(kind=kind, flags=flags, reflectance=refl,
                                alpha=sigma, tex_reflectance=tex)
        if kind in (CONDUCTOR, ROUGH_CONDUCTOR):
            mat = node.get("material", "cu")
            if isinstance(mat, str) and mat.lower() in CONDUCTOR_PRESETS:
                eta, k = CONDUCTOR_PRESETS[mat.lower()]
            else:
                eta, k = CONDUCTOR_PRESETS["cu"]
            if node.get("eta") is not None:
                eta = spectrum_value(node.get("eta"))
            if node.get("k") is not None:
                k = spectrum_value(node.get("k"))
            return self.add_row(kind=kind, flags=flags, specular=spec,
                                alpha=alpha, eta=eta, k=k, dist=dist)
        if kind in (DIELECTRIC, ROUGH_DIELECTRIC, THIN_DIELECTRIC):
            return self.add_row(kind=kind, flags=flags, specular=spec,
                                transmittance=trans, alpha=alpha,
                                eta=(rel_eta,) * 3, dist=dist)
        if kind in (PLASTIC, ROUGH_PLASTIC):
            refl, tex = self._spectrum_or_texture(
                node, ["diffuseReflectance", "reflectance"], (0.5, 0.5, 0.5))
            return self.add_row(
                kind=kind, flags=flags, reflectance=refl, specular=spec,
                alpha=alpha, eta=(rel_eta,) * 3, dist=dist,
                tex_reflectance=tex,
                fdr_int=fresnel_diffuse_reflectance(1.0 / rel_eta))
        if kind == WARD:
            # ward.cpp (classic 'ward' variant): anisotropic Gaussian
            # specular lobe + Lambertian diffuse
            refl, tex = self._spectrum_or_texture(
                node, ["diffuseReflectance"], (0.5, 0.5, 0.5))
            au = float(node.get("alphaU", node.get("alpha", 0.1)))
            av = float(node.get("alphaV", node.get("alpha", 0.1)))
            return self.add_row(kind=kind, flags=flags, reflectance=refl,
                                specular=spectrum_value(
                                    node.get("specularReflectance"),
                                    (0.2, 0.2, 0.2)),
                                alpha=au, alpha_v=av, tex_reflectance=tex)
        if kind == PHONG:
            refl, tex = self._spectrum_or_texture(
                node, ["diffuseReflectance"], (0.5, 0.5, 0.5))
            return self.add_row(kind=kind, flags=flags, reflectance=refl,
                                specular=spectrum_value(
                                    node.get("specularReflectance"),
                                    (0.2, 0.2, 0.2)),
                                alpha=float(node.get("exponent", 30.0)),
                                tex_reflectance=tex)
        if kind == DIFFTRANS:
            # difftrans.cpp: Lambertian transmission through the surface;
            # 'transmittance' plays the role of the albedo
            refl, tex = self._spectrum_or_texture(
                node, ["transmittance"], (0.5, 0.5, 0.5))
            return self.add_row(kind=kind, flags=flags, reflectance=refl,
                                tex_reflectance=tex)
        if kind == HK:
            # hk.cpp: sigmaS/sigmaA (or sigmaT + albedo), thickness,
            # nested phase function (hg / isotropic).  The named-material
            # preset database is not carried over — explicit coefficients
            # only (documented deviation).
            sig_t = node.get("sigmaT")
            if sig_t is not None:
                st_ = spectrum_value(sig_t)
                alb_ = spectrum_value(node.get("albedo"), (0.8,) * 3)
                sig_s = st_ * alb_
                sig_a = st_ - sig_s
            else:
                sig_s = spectrum_value(node.get("sigmaS"), (1.0,) * 3)
                sig_a = spectrum_value(node.get("sigmaA"), (0.05,) * 3)
            thickness = float(node.get("thickness", 1.0))
            g_hg = 0.0
            ph = node.child("phase") or next(
                (v for v in node.props.values() if hasattr(v, "kind")
                 and v.kind == "phase"), None)
            if ph is not None and ph.type == "hg":
                g_hg = float(ph.get("g", 0.8))
            return self.add_row(kind=kind, flags=flags,
                                reflectance=sig_s, transmittance=sig_a,
                                alpha=thickness, alpha_v=g_hg)
        if kind == IRAWAN:
            # irawan.cpp: the weave pattern by file name (matched to the
            # built-in presets of ops/irawan.py), repeatU / V, kd and ks
            # (the preset's colors unless given) times their multipliers
            from ..ops import irawan as irw
            pid = irw.preset_from_name(str(node.get("filename", "plain")))
            kd = spectrum_value(node.get("kd"), irw.PRESET_KD[pid]) * \
                float(node.get("kdMultiplier", 1.0))
            ks = spectrum_value(node.get("ks"), irw.PRESET_KS[pid]) * \
                float(node.get("ksMultiplier", 1.0))
            return self.add_row(
                kind=kind, flags=flags, reflectance=kd, specular=ks,
                alpha=float(node.get("repeatU", 10.0)),
                alpha_v=float(node.get("repeatV", 10.0)),
                dist=pid, eta=(1.345, 1.345, 1.345))
        if kind == NULL_BSDF:
            return self.add_row(kind=kind, flags=flags,
                                reflectance=(0, 0, 0))
        raise ValueError(f"unhandled BSDF kind {t}")

    def finalize(self) -> Materials:
        if not self.rows:
            self.default_id()
        g = lambda k: np.stack([np.asarray(r[k]) for r in self.rows])
        M = len(self.rows)
        # 32 columns (with perturbation cols 28-30) ONLY when a bumpmap/
        # normalmap exists: ops/common.fill_intersection uses the STATIC
        # packed width as the compile-time gate for the perturbation code
        ncols = 32 if self.perturb else 28
        packed = np.zeros((M, ncols), np.float32)
        if self.perturb:
            packed[:, 29] = -1.0  # no perturbation texture
        packed[:, 0] = g("kind")
        packed[:, 1] = g("flags")
        packed[:, 2:5] = g("reflectance")
        packed[:, 5:8] = g("specular")
        packed[:, 8:11] = g("transmittance")
        packed[:, 11] = g("alpha")
        packed[:, 12:15] = g("eta")
        packed[:, 15:18] = g("k")
        packed[:, 18] = g("dist")
        packed[:, 19] = g("fdr_int")
        packed[:, 20] = g("tex_reflectance")
        packed[:, 21] = g("alpha_v")
        packed[:, 22] = g("opacity")
        packed[:, 23] = g("tex_opacity")
        packed[:, 24] = g("child0")
        packed[:, 25] = g("child1")
        packed[:, 26] = g("blend_w")
        packed[:, 27] = g("tex_blend")
        # bumpmap/normalmap perturbation columns
        for rid, (mode, tex, scale) in self.perturb.items():
            packed[rid, 28] = mode
            packed[rid, 29] = tex
            packed[rid, 30] = scale
        return Materials(
            packed=packed,
            kind=g("kind").astype(np.int32),
            flags=g("flags").astype(np.int32),
            reflectance=g("reflectance").astype(np.float32),
            specular=g("specular").astype(np.float32),
            transmittance=g("transmittance").astype(np.float32),
            alpha=g("alpha").astype(np.float32),
            eta=g("eta").astype(np.float32),
            k=g("k").astype(np.float32),
            dist=g("dist").astype(np.int32),
            tex_reflectance=g("tex_reflectance").astype(np.int32),
            fdr_int=g("fdr_int").astype(np.float32),
        )
