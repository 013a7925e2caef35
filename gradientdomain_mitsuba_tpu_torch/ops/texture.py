"""Texture tables and their evaluation: bitmap (trilinear mipmapped,
wrap) + checkerboard + grid.

Counterpart of gradientdomain_mitsuba_tpu/ops/texture.py (Mitsuba's
src/textures/{bitmap,checkerboard,gridtexture}.cpp + mipmap.h): the
TextureTable the scene loader builds on the host (every bitmap's mip
pyramid packed into one padded atlas stack [T, Hmax, Wmax, 3]) and the
lookups on the device (gathers + bilinear weights; trilinear filtering
lerps between the two levels that straddle the primary hit's footprint).

The anisotropic (EWA-class) filter takes fixed Gaussian-weighted
trilinear taps along the primary hit's footprint ellipse
(_aniso_sample); vertexcolors and wireframe read the hit's barycentric
payload (ops/common.fill_intersection), and a caller without one gets
their flat color0, as in the reference; the mask's opacity and the
blendbsdf's weight resolve their textures by luminance.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.spectrum import luminance

TEX_BITMAP = 0
TEX_CHECKERBOARD = 1
TEX_GRID = 2
TEX_VERTEXCOLOR = 3   # src/textures/vertexcolors.cpp: barycentric blend
TEX_WIREFRAME = 4     # src/textures/wireframe.cpp: world edge distance


class TextureTable(NamedTuple):
    kind: np.ndarray       # [T] i32
    color0: np.ndarray     # [T, 3] checkerboard color0 / bitmap scale
    color1: np.ndarray     # [T, 3]
    uv_scale: np.ndarray   # [T, 2]
    uv_offset: np.ndarray  # [T, 2]
    image: np.ndarray      # [T, Hmax, Wmax, 3] atlas incl. mip levels
    img_size: np.ndarray   # [T, 2] (h, w) of level 0
    lvl_off: np.ndarray    # [T, L, 2] (y, x) atlas offset per level
    lvl_size: np.ndarray   # [T, L, 2] (h, w) per level
    n_levels: np.ndarray   # [T] i32
    grid_width: np.ndarray  # [T] gridtexture line width
    filter_ewa: np.ndarray  # [T] i32: anisotropic (EWA-class) filtering
    #                         (bitmap filterType, Mitsuba default "ewa")


def _lvl_dummy(t=1):
    return (np.zeros((t, 1, 2), np.int32), np.ones((t, 1, 2), np.int32),
            np.ones(t, np.int32))


def empty_table() -> TextureTable:
    lo, ls, nl = _lvl_dummy()
    return TextureTable(
        kind=np.zeros(1, np.int32),
        color0=np.ones((1, 3), np.float32),
        color1=np.ones((1, 3), np.float32),
        uv_scale=np.ones((1, 2), np.float32),
        uv_offset=np.zeros((1, 2), np.float32),
        image=np.ones((1, 1, 1, 3), np.float32),
        img_size=np.ones((1, 2), np.int32),
        lvl_off=lo, lvl_size=ls, n_levels=nl,
        grid_width=np.full(1, 0.01, np.float32),
        filter_ewa=np.zeros(1, np.int32))


def _downsample2(img):
    """2x box downsample with replicate padding for odd sizes."""
    h, w = img.shape[:2]
    if h > 1 and h % 2:
        img = np.concatenate([img, img[-1:]], axis=0)
    if w > 1 and w % 2:
        img = np.concatenate([img, img[:, -1:]], axis=1)
    h, w = img.shape[:2]
    if h > 1:
        img = 0.5 * (img[0::2] + img[1::2])
    if w > 1:
        img = 0.5 * (img[:, 0::2] + img[:, 1::2])
    return img


def _build_pyramid(img):
    """[level 0 image, ...] down to 1x1 (box-filtered, mipmap.h E*Box)."""
    levels = [img]
    while levels[-1].shape[0] > 1 or levels[-1].shape[1] > 1:
        levels.append(_downsample2(levels[-1]))
    return levels


def _pack_pyramid(levels):
    """Pack a mip chain into one 2D slab: level 0 at (0, 0), levels >= 1
    stacked vertically at x = w0.  Returns (slab, offsets, sizes)."""
    h0, w0 = levels[0].shape[:2]
    side_h = sum(l.shape[0] for l in levels[1:])
    H = max(h0, side_h)
    W = w0 + (levels[1].shape[1] if len(levels) > 1 else 0)
    slab = np.zeros((H, W, 3), np.float32)
    slab[:h0, :w0] = levels[0]
    offs, sizes = [(0, 0)], [(h0, w0)]
    y = 0
    for l in levels[1:]:
        lh, lw = l.shape[:2]
        slab[y:y + lh, w0:w0 + lw] = l
        offs.append((y, w0))
        sizes.append((lh, lw))
        y += lh
    return slab, offs, sizes


def build_table(nodes, base_dir) -> TextureTable:
    """Texture plugin nodes -> stacked table (host side)."""
    import os
    from ..scene.ir import spectrum_value
    if not nodes:
        return empty_table()
    kinds, c0s, c1s, scales, offsets = [], [], [], [], []
    slabs, lvl_offs, lvl_sizes, sizes0 = [], [], [], []
    grid_widths = {}
    ewas = []
    for node in nodes:
        us = float(node.get("uscale", 1.0))
        vs = float(node.get("vscale", 1.0))
        uo = float(node.get("uoffset", 0.0))
        vo = float(node.get("voffset", 0.0))
        scales.append((us, vs))
        offsets.append((uo, vo))
        mul = np.ones(3, np.float32)
        if node.type == "scale":
            # scale wrapper (src/textures/scale.cpp): multiply the
            # nested texture; fold the factor into the color/scale
            # columns at build time
            mul = spectrum_value(node.get("value"), (1.0,) * 3)
            nested = [ch for ch in node.children if ch.kind == "texture"]
            if nested:
                node = nested[0]
        ewas.append(1 if (node.type == "bitmap" and str(
            node.get("filterType", "ewa")).lower() == "ewa") else 0)
        if node.type == "bitmap":
            kinds.append(TEX_BITMAP)
            c0s.append(mul)  # bitmap scale
            c1s.append(np.zeros(3, np.float32))
            path = os.path.join(base_dir, node.get("filename"))
            if path.lower().endswith(".exr"):
                from ..utils import exr
                img = exr.read_rgb(path)
            else:
                from PIL import Image
                raw = np.asarray(Image.open(path).convert("RGB"),
                                 np.float32) / 255.0
                gamma = float(node.get("gamma", -1.0))
                if gamma == -1.0:
                    img = np.where(raw <= 0.04045, raw / 12.92,
                                   ((raw + 0.055) / 1.055) ** 2.4)
                else:
                    img = raw ** gamma
            img = img.astype(np.float32)
        else:
            if node.type == "checkerboard":
                kinds.append(TEX_CHECKERBOARD)
                c0s.append(mul * spectrum_value(node.get("color0"),
                                                (0.4,) * 3))
                c1s.append(mul * spectrum_value(node.get("color1"),
                                                (0.2,) * 3))
            elif node.type == "gridtexture":
                kinds.append(TEX_GRID)
                # color0 = background, color1 = grid lines; lineWidth
                # rides the unused color1 alpha... stored in offsets? no:
                # keep it in color0's companion scalar table via c1 w
                c0s.append(mul * spectrum_value(node.get("color0"),
                                                (0.4,) * 3))
                c1s.append(mul * spectrum_value(node.get("color1"),
                                                (0.2,) * 3))
                grid_widths[len(kinds) - 1] = float(
                    node.get("lineWidth", 0.01))
            elif node.type in ("vertexcolors", "curvature"):
                # per-hit barycentric color arrives via the Intersection
                # bary payload; color0 folds in a scale-wrapper factor.
                # curvature (curvature.cpp) bakes its per-vertex estimate
                # into the same channel at mesh load (scene.compile_scene)
                # and folds its own `scale` knob here.
                kinds.append(TEX_VERTEXCOLOR)
                c0s.append(mul * (float(node.get("scale", 1.0))
                                  if node.type == "curvature" else 1.0))
                c1s.append(np.zeros(3, np.float32))
            elif node.type == "wireframe":
                kinds.append(TEX_WIREFRAME)
                c0s.append(mul * spectrum_value(node.get("interiorColor"),
                                                (0.5,) * 3))
                c1s.append(mul * spectrum_value(node.get("edgeColor"),
                                                (0.1,) * 3))
                # 0.0 = "auto": compile_scene patches in 0.1x the scene
                # mean edge length (wireframe.cpp default)
                grid_widths[len(kinds) - 1] = float(
                    node.get("lineWidth", 0.0))
            else:
                # unsupported texture type: constant grey stand-in
                kinds.append(TEX_CHECKERBOARD)
                c0s.append(np.full(3, 0.5, np.float32))
                c1s.append(np.full(3, 0.5, np.float32))
            img = np.ones((1, 1, 3), np.float32)
        slab, offs, szs = _pack_pyramid(_build_pyramid(img))
        slabs.append(slab)
        lvl_offs.append(offs)
        lvl_sizes.append(szs)
        sizes0.append((img.shape[0], img.shape[1]))

    hmax = max(s.shape[0] for s in slabs)
    wmax = max(s.shape[1] for s in slabs)
    L = max(len(o) for o in lvl_offs)
    T = len(slabs)
    stack = np.zeros((T, hmax, wmax, 3), np.float32)
    lo = np.zeros((T, L, 2), np.int32)
    ls = np.ones((T, L, 2), np.int32)
    nl = np.zeros(T, np.int32)
    for i, slab in enumerate(slabs):
        stack[i, :slab.shape[0], :slab.shape[1]] = slab
        n = len(lvl_offs[i])
        lo[i, :n] = lvl_offs[i]
        ls[i, :n] = lvl_sizes[i]
        # out-of-range rows repeat the coarsest level (clamped gathers)
        lo[i, n:] = lvl_offs[i][-1]
        ls[i, n:] = lvl_sizes[i][-1]
        nl[i] = n
    return TextureTable(
        kind=np.asarray(kinds, np.int32),
        color0=np.stack(c0s).astype(np.float32),
        color1=np.stack(c1s).astype(np.float32),
        uv_scale=np.asarray(scales, np.float32),
        uv_offset=np.asarray(offsets, np.float32),
        image=stack, img_size=np.asarray(sizes0, np.int32),
        lvl_off=lo, lvl_size=ls, n_levels=nl,
        grid_width=np.asarray(
            [grid_widths.get(i, 0.01) for i in range(T)], np.float32),
        filter_ewa=np.asarray(ewas, np.int32))


def _bilinear(tex: TextureTable, tid, lvl, u, v):
    """Bilinear tap at mip level lvl (wrap addressing, v flipped: uv
    origin bottom-left, image row 0 at top — Mitsuba bitmap convention).
    Float and integer wraps are floor-mods (torch.remainder), as jnp's."""
    off = tex.lvl_off[tid, lvl]
    size = tex.lvl_size[tid, lvl]
    h = size[..., 0].to(torch.float32)
    w = size[..., 1].to(torch.float32)
    x = torch.remainder(u, 1.0) * w - 0.5
    y = torch.remainder(1.0 - v, 1.0) * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    hi = size[..., 0]
    wi_ = size[..., 1]
    x0i = torch.remainder(x0.to(torch.int32), wi_)
    x1i = torch.remainder(x0i + 1, wi_)
    y0i = torch.remainder(y0.to(torch.int32), hi)
    y1i = torch.remainder(y0i + 1, hi)
    oy = off[..., 0]
    ox = off[..., 1]

    def tap(yy, xx):
        return tex.image[tid, (oy + yy).long(), (ox + xx).long()]

    return (tap(y0i, x0i) * (1 - fx) * (1 - fy) +
            tap(y0i, x1i) * fx * (1 - fy) +
            tap(y1i, x0i) * (1 - fx) * fy + tap(y1i, x1i) * fx * fy)


N_ANISO_TAPS = 8   # the reference's fixed tap count
MAX_ANISO = 8.0


def _levels(tex, tid, lod):
    """The two mip levels straddling lod (clamped to the texture's
    levels) and the lerp weight of the upper one."""
    top = tex.n_levels[tid] - 1
    lod = torch.clamp(lod, min=torch.zeros_like(lod),
                      max=top.to(torch.float32))
    l0 = torch.floor(lod).to(torch.int32)
    l1 = torch.minimum(l0 + 1, top)
    return l0.long(), l1.long(), (lod - l0.to(torch.float32))[..., None]


def _trilinear(tex, tid, levels, u, v):
    l0, l1, fl = levels
    return (_bilinear(tex, tid, l0, u, v) * (1 - fl) +
            _bilinear(tex, tid, l1, u, v) * fl)


def _aniso_sample(tex, tid, u, v, jac):
    """Anisotropic (EWA-class) filtering, the reference's bounded form of
    mipmap.h's EWA lookup: the mip level from the footprint ellipse's
    MINOR axis (widened to at least major / MAX_ANISO), N_ANISO_TAPS
    Gaussian-weighted trilinear taps spread along the MAJOR axis.

    jac: [..., 2, 2], columns the ellipse's two axes in scaled uv."""
    h0 = tex.img_size[tid, 0].to(torch.float32)
    w0 = tex.img_size[tid, 1].to(torch.float32)
    wh = torch.stack([w0, h0], -1)
    # axis lengths in texel units
    ax = jac[..., 0] * wh
    ay = jac[..., 1] * wh
    la = torch.sqrt(torch.sum(ax * ax, -1) + 1e-20)
    lb = torch.sqrt(torch.sum(ay * ay, -1) + 1e-20)
    major_uv = torch.where((lb > la)[..., None], jac[..., 1], jac[..., 0])
    l_maj = torch.maximum(la, lb)
    l_min = torch.maximum(torch.minimum(la, lb), l_maj / MAX_ANISO)
    levels = _levels(tex, tid, torch.log2(torch.clamp_min(l_min, 1e-6)))

    acc = 0.0
    wsum = 0.0
    for i in range(N_ANISO_TAPS):
        t = (i + 0.5) / N_ANISO_TAPS - 0.5          # in (-0.5, 0.5)
        w = float(np.exp(-2.0 * (2.0 * t) ** 2))     # Gaussian falloff
        acc = acc + w * _trilinear(tex, tid, levels,
                                   u + major_uv[..., 0] * t,
                                   v + major_uv[..., 1] * t)
        wsum = wsum + w
    return acc / wsum


def eval_texture(tex: TextureTable, tex_id, uv, uv_footprint=None,
                 bary=None):
    """Evaluate textures for a batch: tex_id [N] (>= 0), uv [N, 2].

    uv_footprint (optional): the UV-space footprint area [N] of a
    primary hit (trilinear level selection), or a tuple (area [N],
    jacobian [N, 2, 2]) whose columns are the footprint ellipse's axes
    in uv, which textures flagged filter_ewa filter anisotropically;
    None is the finest level, the behavior for secondary bounces.
    bary: the hit's barycentric payload ([N, >= 4]: vertex color, edge
    distance) for vertexcolors and wireframe; without it they evaluate
    to their flat color0."""
    uv_jac = None
    if isinstance(uv_footprint, tuple):
        uv_footprint, uv_jac = uv_footprint
    tid = torch.clamp_min(tex_id, 0).long()
    scale = tex.uv_scale[tid]
    off = tex.uv_offset[tid]
    u = uv[..., 0] * scale[..., 0] + off[..., 0]
    v = uv[..., 1] * scale[..., 1] + off[..., 1]
    c0 = tex.color0[tid]
    c1 = tex.color1[tid]

    # checkerboard (Mitsuba: floor(u)+floor(v) parity over [0,1] cells)
    iu = torch.floor(u * 2.0).to(torch.int32)
    iv = torch.floor(v * 2.0).to(torch.int32)
    even = torch.remainder(iu + iv, 2) == 0
    checker = torch.where(even[..., None], c0, c1)

    if uv_footprint is None:
        bmp = _bilinear(tex, tid, torch.zeros_like(tid), u, v)
    else:
        # lod = 0.5 log2(texels covered): footprint in scaled-uv space
        # times the level-0 texel density
        h0 = tex.img_size[tid, 0].to(torch.float32)
        w0 = tex.img_size[tid, 1].to(torch.float32)
        texels = uv_footprint * scale[..., 0] * scale[..., 1] * h0 * w0
        lod = 0.5 * torch.log2(torch.clamp_min(texels, 1e-20))
        bmp = _trilinear(tex, tid, _levels(tex, tid, lod), u, v)
        if uv_jac is not None:
            # ellipse axes into SCALED uv: row 0 (du) by uscale, row 1
            # (dv) by vscale
            aniso = _aniso_sample(tex, tid, u, v,
                                  uv_jac * scale[..., :, None])
            bmp = torch.where((tex.filter_ewa[tid] > 0)[..., None], aniso,
                              bmp)
    bmp = bmp * c0

    # gridtexture (src/textures/gridtexture.cpp): lines of color1 at
    # integer uv boundaries over a color0 background
    lw = tex.grid_width[tid]
    fu = torch.remainder(u, 1.0)
    fv = torch.remainder(v, 1.0)
    on_line = (fu < lw) | (fu > 1.0 - lw) | (fv < lw) | (fv > 1.0 - lw)
    grid = torch.where(on_line[..., None], c1, c0)

    kind = tex.kind[tid]
    out = torch.where((kind == TEX_CHECKERBOARD)[..., None], checker,
                      torch.where((kind == TEX_GRID)[..., None], grid, bmp))
    if bary is None:
        flat = (kind == TEX_VERTEXCOLOR) | (kind == TEX_WIREFRAME)
        return torch.where(flat[..., None], c0, out)
    # vertexcolors: the interpolated vertex color; wireframe: color1
    # within lineWidth (world units) of the nearest triangle edge
    wire = torch.where((bary[..., 3] < lw)[..., None], c1, c0)
    out = torch.where((kind == TEX_VERTEXCOLOR)[..., None],
                      bary[..., 0:3] * c0, out)
    return torch.where((kind == TEX_WIREFRAME)[..., None], wire, out)


def _albedo(row, tex_id, val):
    return torch.where((tex_id >= 0)[..., None], val, row[..., 2:5])


def _opacity(row, tex_id, val):
    return torch.where(tex_id >= 0, luminance(val), row[..., 22])


def _blend_weight(row, tex_id, val):
    return torch.clamp(torch.where(tex_id >= 0, luminance(val),
                                   row[..., 26]), 0.0, 1.0)


# what a material row's texture resolves: (packed column of its texture
# id, the value from (row, texture id, texture value))
RESOLVE = {"albedo": (20, _albedo), "opacity": (23, _opacity),
           "blend_weight": (27, _blend_weight)}


def resolve(scene, lookups, uv_footprint=None):
    """Texture-resolved material values for lookups [(what, mid, uv,
    bary)] (what a key of RESOLVE; bary None or given for all), with ONE
    eval_texture call over all of them, concatenated along the first
    axis: each lane computes what it computes alone, and the host issues
    the lookup's operations once.  uv_footprint applies to every lane
    (so a primary hit's albedo is looked up alone)."""
    if not lookups:
        return []
    packed = scene.materials.packed
    rows = [packed[mid.long()] for _, mid, _, _ in lookups]
    tex_ids = [row[..., RESOLVE[what][0]].to(torch.int32)
               for (what, _, _, _), row in zip(lookups, rows)]
    bary = [b for _, _, _, b in lookups]
    if len(lookups) == 1:
        vals = [eval_texture(scene.textures, tex_ids[0], lookups[0][2],
                             uv_footprint, bary=bary[0])]
    else:
        val = eval_texture(scene.textures, torch.cat(tex_ids),
                           torch.cat([uv for _, _, uv, _ in lookups]),
                           uv_footprint,
                           bary=None if bary[0] is None else torch.cat(bary))
        vals = torch.split(val, [t.shape[0] for t in tex_ids])
    return [RESOLVE[what][1](row, tex_id, val) for (what, _, _, _), row,
            tex_id, val in zip(lookups, rows, tex_ids, vals)]


def resolve_albedo(scene, mid, uv, uv_footprint=None, bary=None):
    """Material reflectance with the texture override where one is bound
    (packed column 20), else the row's (columns 2:5)."""
    return resolve(scene, [("albedo", mid, uv, bary)], uv_footprint)[0]


def resolve_opacity(scene, mid, uv, bary=None):
    """The mask's opacity: the luminance of its opacity texture where one
    is bound (packed column 23), else the row's constant (column 22),
    mask.cpp's semantics."""
    return resolve(scene, [("opacity", mid, uv, bary)])[0]


def resolve_blend_weight(scene, mid, uv, bary=None):
    """blendbsdf's weight: the luminance of its weight texture where one
    is bound (packed column 27), else the row's scalar (column 26),
    clamped to [0, 1] (blendbsdf.cpp)."""
    return resolve(scene, [("blend_weight", mid, uv, bary)])[0]
