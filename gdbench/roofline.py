"""The least time a traversal call could take on the card: a frozen count
of the work its rays need, at the card's published peaks (peaks.json).

A clustered traversal (the scene's triangles in clusters of `window`
slots, clusters in superclusters of 128) needs, for a closest-hit call,
the triangles of every (ray, cluster) pair whose cluster box the ray
enters before its final hit t (maxt where it misses), and for an any-hit
call, those pairs against maxt for the rays that are not occluded and one
cluster for each occluded ray.  Each such pair costs `window` ray /
triangle tests of FLOPS_LINEAR_MT float32 operations; each cluster that
any pair needs is read once (22 floats a slot and its 24-byte box), each
ray is read once and each result written once (48 bytes a closest-hit
ray, 33 an any-hit ray).  The bound is the larger of operations over the
float32 peak and bytes over the memory bandwidth.  The count reads the
scene's cluster boxes (cbounds [K, 6]: min xyz, max xyz) and nothing of
how a kernel walks them, so any kernel on these tables is held to the
same work.
"""
from __future__ import annotations

import json
import os

import torch

SUPER = 128              # clusters per supercluster
RAY_CHUNK = 65536
PAIR_CHUNK = 131072
F32_MAX = 3.0e38
FLOPS_LINEAR_MT = 44     # 3 dots of 6 (1 mul + 5 fma), the t dot (1 mul +
#                          2 fma + add), rcp, 3 mul, add
SLAB_FLOATS = 22


def peaks():
    with open(os.path.join(os.path.dirname(__file__), "peaks.json")) as f:
        p = json.load(f)
    return p["f32_flops_per_s"], p["hbm_bytes_per_s"]


def bound_ms(flops, nbytes):
    """(ms, "operations" or "bytes"): the least time of the work."""
    f32, hbm = peaks()
    ops_ms, bytes_ms = flops / f32 * 1e3, nbytes / hbm * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms,
                                                              "bytes")


def super_bounds(cbounds):
    """[S, 6] supercluster boxes: unions of SUPER consecutive clusters
    (padding clusters carry inverted boxes that never widen a union)."""
    K = cbounds.shape[0]
    Kp = -(-K // SUPER) * SUPER
    cb = cbounds
    if Kp != K:
        pad = cbounds.new_full((Kp - K, 6), F32_MAX)
        pad[:, 3:6] = -F32_MAX
        cb = torch.cat([cbounds, pad])
    return torch.cat([cb[:, 0:3].reshape(-1, SUPER, 3).amin(1),
                      cb[:, 3:6].reshape(-1, SUPER, 3).amax(1)], 1)


def member_slabs(cbounds):
    """[S, 8, SUPER] member boxes: row 0 the cluster id (-1 past K), rows
    1-3 box min, rows 4-6 box max, row 7 zeros."""
    K = cbounds.shape[0]
    Kp = -(-K // SUPER) * SUPER
    ids = torch.arange(Kp, device=cbounds.device)
    cb = torch.cat([cbounds, cbounds.new_zeros((Kp - K, 6))])
    rows = torch.cat([torch.where(ids < K, ids, -1).to(cbounds.dtype)[:, None],
                      cb, cbounds.new_zeros((Kp, 1))], 1)
    return rows.reshape(-1, SUPER, 8).transpose(1, 2).contiguous()


def _box(o, inv, lo, hi, mint, bound):
    t0 = (lo - o) * inv
    t1 = (hi - o) * inv
    tn = torch.minimum(t0, t1).amax(-1)
    tf = torch.maximum(t0, t1).amin(-1)
    return (tn <= tf) & (tf >= mint) & (tn <= bound) & (bound >= mint)


def candidates(o, d, mint, bound, scb, mb):
    """(ray [P], cluster [P]) pairs whose member box passes against
    bound, for one chunk of rays."""
    inv = torch.where(d.abs() > 1e-12, 1.0 / d, 1e30)
    sup = _box(o[:, None], inv[:, None], scb[None, :, 0:3], scb[None, :, 3:6],
               mint[:, None], bound[:, None])
    r1, s1 = sup.nonzero(as_tuple=True)
    rays, ks = [], []
    for a in range(0, r1.shape[0], PAIR_CHUNK):
        r = r1[a:a + PAIR_CHUNK]
        m = mb[s1[a:a + PAIR_CHUNK]]
        ok = (m[:, 0] >= 0) & _box(
            o[r, None], inv[r, None], m[:, 1:4].transpose(1, 2),
            m[:, 4:7].transpose(1, 2), mint[r, None], bound[r, None])
        p, j = ok.nonzero(as_tuple=True)
        rays.append(r[p])
        ks.append(m[p, 0, j].long())
    if not rays:
        e = torch.zeros(0, dtype=torch.int64, device=o.device)
        return e, e
    return torch.cat(rays), torch.cat(ks)


def traversal_bound(rays, hit_valid, hit_t, hit_prim, occ, cbounds, window):
    """Bound of one call.  rays: (o, d, mint, maxt); hit_*: the closest
    hits of these rays; occ: the any-hit answers ([N] bool) for an
    any-hit call, None for a closest-hit call.  Returns (ms, bound_by)."""
    o, d, mint, maxt = rays
    if occ is None:
        bound = torch.where(hit_valid, hit_t, maxt)
    else:
        bound = torch.where(occ, -1.0, maxt)
    scb, mb = super_bounds(cbounds), member_slabs(cbounds)
    seen = torch.zeros(cbounds.shape[0], dtype=torch.bool, device=o.device)
    pairs = 0
    for a in range(0, o.shape[0], RAY_CHUNK):
        sl = slice(a, a + RAY_CHUNK)
        _, k = candidates(o[sl], d[sl], mint[sl], bound[sl], scb, mb)
        pairs += k.shape[0]
        seen[k] = True
    if occ is not None:
        found = occ & hit_valid
        pairs += int(found.sum())
        seen[(hit_prim[found] // window).long()] = True
    n = o.shape[0]
    flops = pairs * window * FLOPS_LINEAR_MT
    nbytes = (n * (33 if occ is not None else 48) +
              int(seen.sum()) * (SLAB_FLOATS * window * 4 + 24))
    return bound_ms(flops, nbytes)
