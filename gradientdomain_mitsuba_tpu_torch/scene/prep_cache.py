"""Geometry prep pipeline: BVH, clusters, padded layout, linear-MT table.

Counterpart of gradientdomain_mitsuba_tpu/scene/prep_cache.py, numpy only.
Everything that depends ONLY on the triangle soup and the cluster target
is built here in one shot, in the same order and layout as the
reference, so both packages hand identical tables to their traversal
kernels.  The reference's on-disk cache (``.gdmt_cache/``, used above
100k triangles) is not ported yet: every scene is built afresh.
"""
from __future__ import annotations

import time

import numpy as np

from . import bvh as bvh_mod


def build_geometry(p0, p1, p2, target: int, times=None) -> dict:
    """Triangle soup [T,3]x3 -> everything the traversal kernels need.

    Returns a dict of numpy arrays + scalars:
      tree_c0min/c0max/c1min/c1max [N,3], tree_c0/c1 [N] (leaf codes
      REMAPPED into the padded layout), tree_depth, order [T],
      window, c_off/c_cnt [K], c_min/c_max [K,3],
      psel [Tp] (padded slot -> bvh-order idx, clamped), valid_slot [Tp],
      v0/e1/e2 [Tp,3], orig_id [Tp], tri9 [K,16,window],
      mt_slabs [K,8,4*window] or dummy, linC [10,4*Tp] or dummy,
      cbounds [K,6].
    """
    times = times if times is not None else {}
    T = len(p0)

    t0 = time.time()
    tree = bvh_mod.build(p0, p1, p2)
    times["bvh_build"] = time.time() - t0

    t0 = time.time()
    order = tree.prim_order
    c_off, c_cnt, c_min, c_max = bvh_mod.extract_clusters(tree, target)
    window = int(c_cnt.max()) if len(c_cnt) else 1
    window = max(128, -(-window // 128) * 128)  # reference's lane-aligned layout
    K = len(c_off)
    times["clusters"] = time.time() - t0

    # CLUSTER-MAJOR padded layout: cluster k owns prim slots
    # [k*window, k*window + count_k); window tails are degenerate padding.
    t0 = time.time()
    Tp = K * window
    sl = np.arange(window, dtype=np.int64)
    full = c_off.astype(np.int64)[:, None] + sl[None, :]        # [K, W]
    valid2 = sl[None, :] < c_cnt.astype(np.int64)[:, None]      # [K, W]
    valid_slot = valid2.ravel()
    psel = np.where(valid2, full, 0).ravel()                    # clamped
    new_of_bvh = np.empty(T, np.int64)                          # bvh -> slot
    slot2 = (np.arange(K, dtype=np.int64)[:, None] * window + sl[None, :])
    new_of_bvh[full[valid2]] = slot2[valid2]

    def lay(a, fill=0.0):
        out = a[order][psel]
        out[~valid_slot] = fill
        return out

    v0 = lay(p0).astype(np.float32)
    e1 = lay(p1 - p0).astype(np.float32)
    e2 = lay(p2 - p0).astype(np.float32)
    orig_id = np.where(valid_slot, order[psel], -1).astype(np.int32)

    # remap BVH leaf codes into the padded layout (leaf ranges stay
    # contiguous inside their cluster)
    LEAF_BITS = bvh_mod.LEAF_BITS

    def remap_codes(codes):
        codes = codes.copy()
        leaf = codes < 0
        raw = -codes[leaf].astype(np.int64) - 1
        offs = raw >> LEAF_BITS
        cnts = raw & ((1 << LEAF_BITS) - 1)
        new_offs = np.where(cnts > 0, new_of_bvh[np.minimum(offs, T - 1)],
                            0).astype(np.int64)
        codes[leaf] = (-((new_offs << LEAF_BITS) | cnts) - 1).astype(
            np.int32)
        return codes

    tree_c0 = remap_codes(tree.child0)
    tree_c1 = remap_codes(tree.child1)
    times["layout"] = time.time() - t0

    # [K, 16, window] cluster-major slabs (reference's v2 traversal layout)
    # (rows 0-8 = v0/e1/e2 xyz; 16-row padding = 8-sublane DMA granule)
    t0 = time.time()
    tri9 = np.zeros((K, 16, window), np.float32)
    tri9[:, :9] = (np.stack([v0.T, e1.T, e2.T])
                   .reshape(9, K, window).transpose(1, 0, 2))

    from ..ops.intersect import build_linear_mt, build_mt_slabs
    from ..ops.common import BRUTE_FORCE_MAX_TRIS
    if T <= BRUTE_FORCE_MAX_TRIS:
        # small scene: single-level matmul sweep over the whole soup
        linC = build_linear_mt(v0, e1, e2)
        mt_slabs = np.zeros((1, 8, 4), np.float32)
    else:
        # large scene: per-cluster slabs (ROADMAP Queue 2 kernels)
        linC_full = build_linear_mt(v0, e1, e2)
        mt_slabs = build_mt_slabs(linC_full, window)
        linC = np.zeros((10, 4), np.float32)
    cbounds = np.concatenate([c_min, c_max], axis=1).astype(np.float32)
    times["slabs"] = time.time() - t0

    return dict(
        tree_c0min=tree.child0_min, tree_c0max=tree.child0_max,
        tree_c1min=tree.child1_min, tree_c1max=tree.child1_max,
        tree_c0=tree_c0, tree_c1=tree_c1,
        tree_depth=np.int32(tree.depth),
        order=order.astype(np.int32),
        window=np.int32(window),
        c_off=c_off, c_cnt=c_cnt, c_min=c_min, c_max=c_max,
        psel=psel.astype(np.int64), valid_slot=valid_slot,
        v0=v0, e1=e1, e2=e2, orig_id=orig_id,
        tri9=tri9, mt_slabs=mt_slabs, linC=linC, cbounds=cbounds)
