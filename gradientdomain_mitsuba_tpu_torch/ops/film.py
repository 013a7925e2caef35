"""Film accumulation: dense grid adds and a deterministic scatter.

Counterpart of gradientdomain_mitsuba_tpu/ops/film.py (ImageBlock::put +
Film::put, src/librender/imageblock.cpp, src/rfilters/*.cpp).

Where every sample belongs to a known pixel (the wavefront renders one
sample per pixel in row-major order), filtering is a small set of dense
shifted adds (splat_grid, add_grid_shifted): the eye images of every
integrator and G-PT's / G-BDPT's eye gradients.  Samples at arbitrary
positions (BDPT's light image and G-BDPT's image-space gradient pairs) go
through splat_unfiltered, a scatter written as a stable sort by flat
pixel index followed by a segment sum.  The reference's filtered scatter
(splat) has no caller in the port and is not ported.  Neither path uses
index_add_ or atomics, so every film is bit-identical from run to run on
the GPU.  Gradient buffers use unfiltered lattice adds (gpt_wr.cpp
semantics).
"""
from __future__ import annotations

import math

import torch

FILTERS = {"box": 0, "tent": 1, "gaussian": 2, "mitchell": 3,
           "catmullrom": 4, "lanczos": 5}
# filter radius in pixels (Mitsuba defaults)
RADII = {0: 0.5, 1: 1.0, 2: 2.0, 3: 2.0, 4: 2.0, 5: 3.0}


def filter_weight(kind: int, x):
    """1D filter weight at offset x (pixels)."""
    ax = torch.abs(x)
    if kind == 0:      # box
        return torch.where(ax <= 0.5, 1.0, 0.0)
    if kind == 1:      # tent
        return torch.clamp_min(1.0 - ax, 0.0)
    if kind == 2:      # gaussian, stddev 0.5, radius 2 (gaussian.cpp)
        sigma = 0.5
        a = torch.exp(-0.5 * (x / sigma) ** 2)
        b = float(math.exp(-0.5 * (2.0 / sigma) ** 2))
        return torch.clamp_min(a - b, 0.0)
    if kind in (3, 4):  # mitchell-netravali (B,C) / catmull-rom
        B, C = (1 / 3, 1 / 3) if kind == 3 else (0.0, 0.5)
        ax2, ax3 = ax * ax, ax * ax * ax
        w1 = ((12 - 9 * B - 6 * C) * ax3 + (-18 + 12 * B + 6 * C) * ax2 +
              (6 - 2 * B)) / 6
        w2 = ((-B - 6 * C) * ax3 + (6 * B + 30 * C) * ax2 +
              (-12 * B - 48 * C) * ax + (8 * B + 24 * C)) / 6
        return torch.where(ax < 1, w1, torch.where(ax < 2, w2, 0.0))
    if kind == 5:      # lanczos sinc, 3 lobes
        def sinc(v):
            v = torch.abs(v) * math.pi
            return torch.where(v < 1e-5, 1.0,
                               torch.sin(v) / torch.clamp_min(v, 1e-5))
        return torch.where(ax < 3.0, sinc(ax) * sinc(ax / 3.0), 0.0)
    raise ValueError(kind)


def scatter_add(fb, py, px, value):
    """fb[py, px] += value for every sample, deterministically.

    fb: [H, W, C]; py, px: [N] integer pixel coordinates inside the film;
    value: [N, C].  The samples are stably sorted by flat pixel index and
    each pixel's run is summed by torch.segment_reduce (a fixed order per
    pixel); the sums are then added at distinct pixels.  The same
    function as an atomic scatter-add, up to summation order, and the
    same bits on every run.  Returns a new fb."""
    H, W, C = fb.shape
    flat = (py.to(torch.int64) * W + px.to(torch.int64)).reshape(-1)
    value = value.reshape(-1, C)
    if flat.shape[0] == 0:
        return fb.clone()
    key, order = torch.sort(flat, stable=True)
    pix, counts = torch.unique_consecutive(key, return_counts=True)
    sums = torch.segment_reduce(value[order], "sum", lengths=counts,
                                axis=0)
    out = fb.reshape(H * W, C).clone()
    out[pix] += sums
    return out.reshape(H, W, C)


def splat_unfiltered(fb, pos, value):
    """Raw box splat WITHOUT weight tracking (gradient / light-image
    buffers, where each sample belongs to one lattice cell and
    normalization is by sample count).  The reference's edge rules: the
    position is truncated to int32 and clipped to the film, and samples
    outside the film add value * 0 at the clipped pixel."""
    H, W = fb.shape[0], fb.shape[1]
    px = torch.clamp(pos[..., 0].to(torch.int32), 0, W - 1)
    py = torch.clamp(pos[..., 1].to(torch.int32), 0, H - 1)
    inside = ((pos[..., 0] >= 0) & (pos[..., 0] < W) &
              (pos[..., 1] >= 0) & (pos[..., 1] < H))
    return scatter_add(fb, py, px, value * inside[..., None])


def develop(fb, wb):
    """Normalize by accumulated filter weights (Film::develop)."""
    return fb / torch.clamp_min(wb, 1e-12)[..., None]


def _tap_radius(filter_kind: int) -> int:
    return int(math.ceil(RADII[filter_kind] - 0.5 + 1e-6))


def splat_grid(fb, wb, jitter, value, filter_kind: int, row0: int = 0):
    """Filtered accumulation of row-major grid samples.

    fb: [H, W, C]; wb: [H, W]; value: [S, rows*W, C] (S sample-batches);
    jitter: [S, rows*W, 2] in-pixel offsets in [0,1).  The sample grid
    starts at film row `row0`.  Returns new (fb, wb); the inputs are not
    modified.
    """
    H, W = fb.shape[0], fb.shape[1]
    S, NW, C = value.shape
    rows = NW // W
    img = value.reshape(S, rows, W, C)
    jx = jitter[..., 0].reshape(S, rows, W)
    jy = jitter[..., 1].reshape(S, rows, W)
    K = _tap_radius(filter_kind)
    fb = fb.clone()
    wb = wb.clone()

    if K == 0:  # box: the sample always lands in its own pixel
        fb[row0:row0 + rows] += img.sum(0)
        wb[row0:row0 + rows] += float(S)
        return fb, wb

    accv = torch.zeros((rows + 2 * K, W + 2 * K, C), dtype=value.dtype,
                       device=value.device)
    accw = torch.zeros((rows + 2 * K, W + 2 * K), dtype=value.dtype,
                       device=value.device)
    for oy in range(-K, K + 1):
        wy = filter_weight(filter_kind, oy + 0.5 - jy)
        for ox in range(-K, K + 1):
            w = wy * filter_weight(filter_kind, ox + 0.5 - jx)
            accv[oy + K:oy + K + rows, ox + K:ox + K + W] += \
                (img * w[..., None]).sum(0)
            accw[oy + K:oy + K + rows, ox + K:ox + K + W] += w.sum(0)
    # fold the accumulator back into the film; taps falling outside the
    # film (row/column halos) are dropped, matching the scatter splat's
    # inside-film check
    y0 = row0 - K
    pad_top = max(0, -y0)
    pad_bot = max(0, (row0 + rows + K) - H)
    src_v = accv[pad_top:accv.shape[0] - pad_bot, K:accv.shape[1] - K]
    src_w = accw[pad_top:accw.shape[0] - pad_bot, K:accw.shape[1] - K]
    dst0 = max(y0, 0)
    fb[dst0:dst0 + src_v.shape[0]] += src_v
    wb[dst0:dst0 + src_w.shape[0]] += src_w
    return fb, wb


def add_grid_shifted(fb, value, dx: int, dy: int, row0: int = 0):
    """Unfiltered lattice add of row-major grid samples at an integer
    pixel offset (dx, dy) — the gradient-buffer path (dense, no scatter).
    value: [S, rows*W, C].  Returns a new fb."""
    H, W = fb.shape[0], fb.shape[1]
    S, NW, C = value.shape
    rows = NW // W
    img = value.reshape(S, rows, W, C).sum(0)
    y0 = row0 + dy
    src_top = max(0, -y0)
    src_bot = max(0, y0 + rows - H)
    if src_top + src_bot >= rows:
        return fb
    img_c = img[src_top:rows - src_bot]
    dst_y = y0 + src_top
    fb = fb.clone()
    rows_c = slice(dst_y, dst_y + img_c.shape[0])
    if dx > 0:
        fb[rows_c, dx:] += img_c[:, :W - dx]
    elif dx < 0:
        fb[rows_c, :W + dx] += img_c[:, -dx:]
    else:
        fb[rows_c, :] += img_c
    return fb
