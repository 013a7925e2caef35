"""BVH construction (host-side, numpy) for the wavefront traversal kernels.

TPU-native replacement for Mitsuba's SAH kd-tree builder
(src/librender/skdtree.cpp + include/mitsuba/render/{gkdtree,sahkdtree3}.h).
A BVH fits the TPU better than a kd-tree: bounded memory, short-stack
wavefront traversal with no mailboxing, and prims can be reordered so leaf
prims are contiguous (coalesced HBM reads in the Pallas kernel).

Builder: top-down binned SAH (16 bins, greedy, median fallback).  Output is
a flat SoA node array:

  child0_min/max, child1_min/max  [N, 3] — the two children's bounds
  child0/child1                   [N]    — >=0: internal node index;
                                           <0: leaf, encoding -(offset<<LEAF_BITS | count)-1
  prim_order                      [T]    — permutation mapping leaf slots to
                                           original triangle ids
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

N_BINS = 16
MAX_LEAF = 4
LEAF_BITS = 5  # up to 31 prims per leaf in the encoding
TRAVERSAL_COST = 1.0
INTERSECT_COST = 1.0


@dataclass
class BVH:
    child0_min: np.ndarray
    child0_max: np.ndarray
    child1_min: np.ndarray
    child1_max: np.ndarray
    child0: np.ndarray      # i32 [N]
    child1: np.ndarray      # i32 [N]
    prim_order: np.ndarray  # i32 [T]
    scene_min: np.ndarray   # f32 [3]
    scene_max: np.ndarray   # f32 [3]
    depth: int

    @property
    def num_nodes(self):
        return len(self.child0)


def encode_leaf(offset: int, count: int) -> int:
    return -int((offset << LEAF_BITS) | count) - 1


def build(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray,
          use_native: bool = True) -> BVH:
    """Build from triangle vertices [T, 3] each.  Uses the native C++
    builder (native/bvh_builder.cpp) when available — identical layout and
    cost model — and falls back to the numpy implementation."""
    if use_native:
        out = _build_native(v0, v1, v2)
        if out is not None:
            return out
    return build_python(v0, v1, v2)


def _build_native(v0, v1, v2):
    from ..native import get_lib
    import ctypes
    lib = get_lib("bvh_builder")
    if lib is None:
        return None
    T = len(v0)
    cap = max(2 * T, 16)
    c0min = np.empty((cap, 3), np.float32)
    c0max = np.empty((cap, 3), np.float32)
    c1min = np.empty((cap, 3), np.float32)
    c1max = np.empty((cap, 3), np.float32)
    c0 = np.empty(cap, np.int32)
    c1 = np.empty(cap, np.int32)
    order = np.arange(T, dtype=np.int32)
    depth = np.zeros(1, np.int32)
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    a = lambda x: x.ctypes.data_as(fp)
    ai = lambda x: x.ctypes.data_as(ip)
    v0c = np.ascontiguousarray(v0, np.float32)
    v1c = np.ascontiguousarray(v1, np.float32)
    v2c = np.ascontiguousarray(v2, np.float32)
    n = lib.bvh_build(a(v0c), a(v1c), a(v2c), ctypes.c_int(T),
                      a(c0min), a(c0max), a(c1min), a(c1max),
                      ai(c0), ai(c1), ai(order), ai(depth))
    if n <= 0:
        return None
    lo = np.minimum(np.minimum(v0c, v1c), v2c)
    hi = np.maximum(np.maximum(v0c, v1c), v2c)
    return BVH(
        child0_min=c0min[:n].copy(), child0_max=c0max[:n].copy(),
        child1_min=c1min[:n].copy(), child1_max=c1max[:n].copy(),
        child0=c0[:n].copy(), child1=c1[:n].copy(),
        prim_order=order, scene_min=lo.min(0), scene_max=hi.max(0),
        depth=int(depth[0]))


def build_python(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray) -> BVH:
    """Pure-numpy reference builder (same layout/cost model)."""
    T = len(v0)
    lo = np.minimum(np.minimum(v0, v1), v2).astype(np.float32)
    hi = np.maximum(np.maximum(v0, v1), v2).astype(np.float32)
    centroid = ((lo + hi) * 0.5).astype(np.float32)

    # growable node arrays
    cap = max(2 * T, 16)
    c0min = np.empty((cap, 3), np.float32); c0max = np.empty((cap, 3), np.float32)
    c1min = np.empty((cap, 3), np.float32); c1max = np.empty((cap, 3), np.float32)
    c0 = np.empty(cap, np.int32); c1 = np.empty(cap, np.int32)
    n_nodes = 0
    order = np.arange(T, dtype=np.int32)
    max_depth = [0]

    def node_bounds(ids):
        return lo[ids].min(0), hi[ids].max(0)

    def new_node():
        nonlocal n_nodes
        idx = n_nodes
        n_nodes += 1
        return idx

    # iterative build with an explicit stack: (node_idx, start, end, depth)
    # each stack entry owns order[start:end]
    root = new_node()
    stack = [(root, 0, T, 1)]

    def make_leaf_range(start, end):
        # split oversize ranges into chained nodes if count > MAX_LEAF handled
        # by caller; here count <= (1<<LEAF_BITS)-1
        return encode_leaf(start, end - start)

    while stack:
        node, start, end, depth = stack.pop()
        max_depth[0] = max(max_depth[0], depth)
        ids = order[start:end]
        count = end - start

        split_axis, split_pos = -1, -1
        if count > MAX_LEAF:
            cmin = centroid[ids].min(0)
            cmax = centroid[ids].max(0)
            ext = cmax - cmin
            axis = int(np.argmax(ext))
            if ext[axis] > 1e-12:
                # binned SAH along the widest centroid axis
                scale = N_BINS * (1.0 - 1e-6) / ext[axis]
                bin_idx = ((centroid[ids, axis] - cmin[axis]) * scale).astype(np.int32)
                bin_idx = np.clip(bin_idx, 0, N_BINS - 1)
                bin_cnt = np.bincount(bin_idx, minlength=N_BINS)
                bin_lo = np.full((N_BINS, 3), np.inf, np.float32)
                bin_hi = np.full((N_BINS, 3), -np.inf, np.float32)
                for b in range(N_BINS):
                    sel = bin_idx == b
                    if sel.any():
                        bin_lo[b] = lo[ids[sel]].min(0)
                        bin_hi[b] = hi[ids[sel]].max(0)
                # prefix/suffix accumulation
                lcnt = np.cumsum(bin_cnt)[:-1]
                rcnt = count - lcnt
                llo = np.minimum.accumulate(bin_lo, 0)[:-1]
                lhi = np.maximum.accumulate(bin_hi, 0)[:-1]
                rlo = np.minimum.accumulate(bin_lo[::-1], 0)[::-1][1:]
                rhi = np.maximum.accumulate(bin_hi[::-1], 0)[::-1][1:]

                def area(a_lo, a_hi):
                    d = np.maximum(a_hi - a_lo, 0)
                    return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]

                sah = (lcnt * area(llo, lhi) + rcnt * area(rlo, rhi))
                sah = np.where((lcnt == 0) | (rcnt == 0), np.inf, sah)
                best = int(np.argmin(sah))
                parent_d = np.maximum(hi[ids].max(0) - lo[ids].min(0), 0)
                parent_area = 2 * (parent_d[0] * parent_d[1] +
                                   parent_d[1] * parent_d[2] +
                                   parent_d[2] * parent_d[0])
                leaf_cost = INTERSECT_COST * count
                split_cost = TRAVERSAL_COST + INTERSECT_COST * sah[best] / max(
                    parent_area / 2, 1e-20)
                if np.isfinite(sah[best]) and (split_cost < leaf_cost or
                                               count > (1 << LEAF_BITS) - 1):
                    split_axis = axis
                    in_left = bin_idx <= best
                    nl = int(in_left.sum())
                    if 0 < nl < count:
                        perm = np.concatenate([ids[in_left], ids[~in_left]])
                        order[start:end] = perm
                        split_pos = start + nl
            if split_axis < 0:
                # forced median split (degenerate centroids / SAH failure) —
                # guarantees every leaf holds <= MAX_LEAF prims
                axis = int(np.argmax(ext)) if ext.max() > 0 else 0
                key = np.argsort(centroid[ids, axis], kind="stable")
                order[start:end] = ids[key]
                split_pos = start + count // 2
                split_axis = axis

        if split_pos < 0:
            # convert to leaf by storing it in the PARENT's child slot —
            # but we already allocated this node; make it a degenerate
            # internal node with one leaf child and one empty child.
            half = max(count // 2, 1) if count > 1 else 1
            b0lo, b0hi = node_bounds(order[start:start + half])
            c0min[node], c0max[node] = b0lo, b0hi
            c0[node] = make_leaf_range(start, start + half)
            if count - half > 0:
                b1lo, b1hi = node_bounds(order[start + half:end])
                c1min[node], c1max[node] = b1lo, b1hi
                c1[node] = make_leaf_range(start + half, end)
            else:
                c1min[node] = np.inf; c1max[node] = -np.inf
                c1[node] = encode_leaf(0, 0)
            continue

        lids = order[start:split_pos]
        rids = order[split_pos:end]
        b0lo, b0hi = node_bounds(lids)
        b1lo, b1hi = node_bounds(rids)
        c0min[node], c0max[node] = b0lo, b0hi
        c1min[node], c1max[node] = b1lo, b1hi

        if len(lids) <= MAX_LEAF:
            c0[node] = make_leaf_range(start, split_pos)
        else:
            if n_nodes >= cap:
                raise RuntimeError("BVH node capacity exceeded")
            ch = new_node()
            c0[node] = ch
            stack.append((ch, start, split_pos, depth + 1))
        if len(rids) <= MAX_LEAF:
            c1[node] = make_leaf_range(split_pos, end)
        else:
            ch = new_node()
            c1[node] = ch
            stack.append((ch, split_pos, end, depth + 1))

    smin, smax = lo.min(0), hi.max(0)
    return BVH(
        child0_min=c0min[:n_nodes].copy(), child0_max=c0max[:n_nodes].copy(),
        child1_min=c1min[:n_nodes].copy(), child1_max=c1max[:n_nodes].copy(),
        child0=c0[:n_nodes].copy(), child1=c1[:n_nodes].copy(),
        prim_order=order, scene_min=smin, scene_max=smax,
        depth=max_depth[0])


def _leaf_se(codes):
    """Vectorized (start, end) of leaf codes (end=start for empty leaves,
    start pushed to +inf so min() reductions ignore them)."""
    raw = -codes.astype(np.int64) - 1
    off = raw >> LEAF_BITS
    cnt = raw & ((1 << LEAF_BITS) - 1)
    s = np.where(cnt > 0, off, np.int64(1) << 60)
    e = np.where(cnt > 0, off + cnt, np.int64(0))
    return s, e


def subtree_ranges(tree: BVH):
    """(start [N], end [N]) prim range covered by each node's subtree.

    Iterative bottom-up sweep (O(depth) vectorized rounds) — the Python
    recursion this replaces was O(N) calls per query and dominated the
    scene build beyond ~1M tris."""
    c0 = tree.child0
    c1 = tree.child1
    n = len(c0)
    start = np.full(n, np.int64(1) << 60)
    end = np.zeros(n, np.int64)
    resolved = np.zeros(n, bool)
    l0s, l0e = _leaf_se(c0)
    l1s, l1e = _leaf_se(c1)
    i0 = np.maximum(c0, 0)
    i1 = np.maximum(c1, 0)
    for _ in range(max(tree.depth + 2, 2)):
        if resolved.all():
            break
        r0 = (c0 < 0) | resolved[i0]
        r1 = (c1 < 0) | resolved[i1]
        now = ~resolved & r0 & r1
        if not now.any():
            break
        s0 = np.where(c0 < 0, l0s, start[i0])
        e0 = np.where(c0 < 0, l0e, end[i0])
        s1 = np.where(c1 < 0, l1s, start[i1])
        e1 = np.where(c1 < 0, l1e, end[i1])
        start[now] = np.minimum(s0, s1)[now]
        end[now] = np.maximum(e0, e1)[now]
        resolved |= now
    assert resolved.all(), "BVH contains an unreachable cycle?"
    return start, end


def extract_clusters(tree: BVH, target: int):
    """Cut the BVH into clusters of <= target contiguous prims.

    Returns (offsets [K], counts [K], bbox_min [K,3], bbox_max [K,3]) in
    BVH prim order.  The clustered traversal (ops/intersect.py) tests rays
    against cluster bounds densely (pure VPU work) and then fetches each
    hit cluster's prim window as ONE contiguous block — the TPU-native
    answer to per-lane pointer chasing."""
    offsets, counts, bmins, bmaxs = [], [], [], []
    sub_s, sub_e = subtree_ranges(tree)

    def leaf_range(code):
        raw = -int(code) - 1
        return raw >> LEAF_BITS, raw & ((1 << LEAF_BITS) - 1)

    def code_range(code):
        if code < 0:
            return leaf_range(code)
        s = int(sub_s[code])
        e = int(sub_e[code])
        if e <= s:
            return 0, 0
        return s, e - s

    def emit(code, bmin, bmax):
        start, cnt = code_range(code)
        if cnt == 0:
            return
        offsets.append(start)
        counts.append(cnt)
        bmins.append(bmin)
        bmaxs.append(bmax)

    root_lo = np.minimum(tree.child0_min[0], tree.child1_min[0])
    root_hi = np.maximum(tree.child0_max[0], tree.child1_max[0])
    stack = [(0, root_lo, root_hi)]
    while stack:
        node, bmin, bmax = stack.pop()
        start, cnt = code_range(node)
        if cnt <= target:
            emit(node, bmin, bmax)
            continue
        for code, lo, hi in (
                (tree.child0[node], tree.child0_min[node],
                 tree.child0_max[node]),
                (tree.child1[node], tree.child1_min[node],
                 tree.child1_max[node])):
            if code >= 0:
                stack.append((int(code), lo, hi))
            else:
                emit(code, lo, hi)
    return (np.asarray(offsets, np.int32), np.asarray(counts, np.int32),
            np.asarray(bmins, np.float32), np.asarray(bmaxs, np.float32))
