"""Host-side elastic tile queue: idempotent render-tile redispatch.

Counterpart of gradientdomain_mitsuba_tpu/parallel/tile_queue.py (the
failure-recovery gap in Mitsuba's scheduler: src/libcore/sched_remote.cpp
aborts the whole job when a remote worker drops).  Every tile is a pure
function of (scene, seed, tile rows, sample range), so a failed dispatch
is simply re-enqueued and rendered again with no side effects to undo.

The film is split into row blocks.  Each block renders on the tracer's
device into local buffers with a filter-radius halo (the row-sharded
renderer's per-shard program, tiles.render_rows_gpt); the host combines
the tiles' results in tile-index order, so the final image is
bit-identical whatever order the tiles completed in and however often
any tile was retried.

`fail_hook(tile_idx, attempt)` lets tests inject faults (raise to
simulate a lost device or a dropped result).
"""
from __future__ import annotations

import numpy as np

from .tiles import halo_rows, render_rows_gpt, row_ids


class TileRenderError(RuntimeError):
    """A tile failed more than max_retries times."""


def render_tiles_queued(tracer, scene, seed, n_samples, tile_rows=32,
                        max_retries=3, fail_hook=None, progress=None):
    """Queued G-PT render with elastic redispatch.

    Returns the same sample-normalized buffers as GPTracer.render, as
    numpy arrays.  fail_hook(tile_idx, attempt) may raise to inject a
    fault; the tile is then re-enqueued (attempt+1) until max_retries is
    exceeded.
    """
    st = tracer.settings
    H, W = st.height, st.width
    B = halo_rows(tracer.filter_kind)
    n_tiles = -(-H // tile_rows)

    queue = [(idx, 0) for idx in range(n_tiles)]
    results = {}
    while queue:
        idx, attempt = queue.pop(0)
        try:
            if fail_hook is not None:
                fail_hook(idx, attempt)
            out = render_rows_gpt(tracer, scene, seed,
                                  row_ids(tracer, idx * tile_rows, tile_rows),
                                  tile_rows, B, n_samples)
            results[idx] = {k: v.cpu().numpy() for k, v in out.items()}
            if progress is not None:
                progress(len(results), n_tiles)
        except Exception as e:  # noqa: BLE001 — any tile fault is retryable
            if attempt + 1 > max_retries:
                raise TileRenderError(
                    f"tile {idx} failed {attempt + 1} times: {e}") from e
            queue.append((idx, attempt + 1))

    # combine in tile-index order: deterministic whatever the completion
    # order (halo rows of adjacent tiles overlap-add)
    Hp = n_tiles * tile_rows
    acc = {k: np.zeros((Hp + 2 * B, W) + v.shape[2:], v.dtype)
           for k, v in results[0].items()}
    for idx in range(n_tiles):
        r0 = idx * tile_rows
        for k, v in results[idx].items():
            acc[k][r0:r0 + tile_rows + 2 * B] += v

    out = {k: v[B:B + H] for k, v in acc.items()}
    w = np.maximum(out.pop("wsum"), 1e-12)[..., None]
    return {
        "primal": out["primal"] / w,
        "very_direct": out["very_direct"] / w,
        "dx": out["dx"] / n_samples,
        "dy": out["dy"] / n_samples,
    }
