"""Plain ray-triangle queries for the reference renderer.

A two-level box hierarchy of the reference's own, built from the raw
triangles: triangles sorted by the Morton code of their centroids,
grouped into leaves of LEAF consecutive triangles, leaves grouped into
nodes of FANOUT consecutive leaves.  A query tests every ray against
every node box, the passing (ray, node) pairs against the node's leaf
boxes, and the passing (ray, leaf) pairs against every triangle of the
leaf with the textbook Moeller-Trumbore test: a hit has
u >= 0, v >= 0, u + v <= 1 and mint < t < maxt.  Closest hits keep the
smallest t, ties to the lowest triangle index; rays whose maxt is not
above mint are not traced.  No running t culls: every pair that passes
against maxt is tested.

All arithmetic runs in the dtype given, so the same code computes the
reference (float32) and its lower-precision control (bfloat16).
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

LEAF = 64
FANOUT = 64
BIG = 3.0e38
NONE = torch.iinfo(torch.int64).max


def _morton(c):
    """30-bit Morton codes of points c [T, 3] in [0, 1]^3."""
    q = np.clip((c * 1023.0).astype(np.int64), 0, 1023)
    out = np.zeros(len(c), np.int64)
    for bit in range(10):
        for axis in range(3):
            out |= ((q[:, axis] >> bit) & 1) << (3 * bit + axis)
    return out


class Accel:
    def __init__(self, p0, p1, p2, device, dtype=torch.float32):
        """p0, p1, p2: [T, 3] float32 numpy vertices."""
        self.device, self.dtype = device, dtype
        T = len(p0)
        cen = (p0 + p1 + p2) / 3.0
        lo, hi = cen.min(0), cen.max(0)
        order = np.argsort(_morton((cen - lo) / np.maximum(hi - lo, 1e-30)),
                           kind="stable")
        K = -(-T // LEAF)
        Kp = -(-K // FANOUT) * FANOUT
        pad = Kp * LEAF - T
        tri = np.stack([p0, p1, p2], 1)[order]            # [T, 3, 3]
        tri = np.concatenate([tri, np.full((pad, 3, 3), np.nan, np.float32)])
        prim = np.concatenate([order, np.full(pad, -1)]).reshape(Kp, LEAF)
        tri = tri.reshape(Kp, LEAF, 3, 3)
        # a box of padding alone is NaN, which no ray passes
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            leaf_lo = np.nanmin(tri, axis=(1, 2))          # [Kp, 3]
            leaf_hi = np.nanmax(tri, axis=(1, 2))
            node_lo = np.nanmin(leaf_lo.reshape(-1, FANOUT, 3), axis=1)
            node_hi = np.nanmax(leaf_hi.reshape(-1, FANOUT, 3), axis=1)

        def dev(a):
            return torch.as_tensor(np.ascontiguousarray(a)).to(device)

        self.v0 = dev(tri[:, :, 0]).to(dtype)              # [Kp, LEAF, 3]
        self.e1 = dev(tri[:, :, 1] - tri[:, :, 0]).to(dtype)
        self.e2 = dev(tri[:, :, 2] - tri[:, :, 0]).to(dtype)
        self.prim = dev(prim)                              # [Kp, LEAF] i64
        self.leaf_lo = dev(leaf_lo).to(dtype).reshape(-1, FANOUT, 3)
        self.leaf_hi = dev(leaf_hi).to(dtype).reshape(-1, FANOUT, 3)
        self.node_lo = dev(node_lo).to(dtype)              # [S, 3]
        self.node_hi = dev(node_hi).to(dtype)
        cuda = torch.device(device).type == "cuda"
        self.ray_chunk = 16384 if cuda else 2048
        self.pair_chunk = 32768 if cuda else 2048

    # -- pieces ----------------------------------------------------------
    @staticmethod
    def _box(o, inv, lo, hi, mint, maxt):
        t0 = (lo - o) * inv
        t1 = (hi - o) * inv
        tn = torch.minimum(t0, t1).amax(-1)
        tf = torch.maximum(t0, t1).amin(-1)
        return (tn <= tf) & (tf >= mint) & (tn <= maxt)

    def _pairs(self, o, d, mint, maxt):
        """(ray, leaf) pairs whose boxes pass, for one chunk of rays."""
        inv = torch.where(d.abs() > 1e-12, 1.0 / d,
                          torch.full_like(d, 1e30))
        hit = self._box(o[:, None], inv[:, None], self.node_lo[None],
                        self.node_hi[None], mint[:, None], maxt[:, None])
        r1, n1 = hit.nonzero(as_tuple=True)
        rays, leaves = [], []
        for a in range(0, r1.shape[0], self.pair_chunk):
            r = r1[a:a + self.pair_chunk]
            n = n1[a:a + self.pair_chunk]
            ok = self._box(o[r, None], inv[r, None], self.leaf_lo[n],
                           self.leaf_hi[n], mint[r, None], maxt[r, None])
            p, j = ok.nonzero(as_tuple=True)
            rays.append(r[p])
            leaves.append(n[p] * FANOUT + j)
        if not rays:
            e = torch.zeros(0, dtype=torch.int64, device=o.device)
            return e, e
        return torch.cat(rays), torch.cat(leaves)

    def _mt(self, o, d, mint, maxt, r, k):
        """Moeller-Trumbore of ray r[q] against every triangle of leaf
        k[q]: (t, u, v, ok), each [Q, LEAF]."""
        v0, e1, e2 = self.v0[k], self.e1[k], self.e2[k]
        dq = d[r, None].expand_as(e2)
        pvec = torch.linalg.cross(dq, e2, dim=-1)
        det = (e1 * pvec).sum(-1)
        inv = 1.0 / det
        tvec = o[r, None] - v0
        u = (tvec * pvec).sum(-1) * inv
        qvec = torch.linalg.cross(tvec, e1, dim=-1)
        v = (dq * qvec).sum(-1) * inv
        t = (e2 * qvec).sum(-1) * inv
        ok = ((det != 0) & (u >= 0) & (v >= 0) & (u + v <= 1) &
              (t > mint[r, None]) & (t < maxt[r, None]))
        return t, u, v, ok

    # -- queries -----------------------------------------------------------
    def closest(self, o, d, mint, maxt):
        """Returns (valid [N] bool, t [N], prim [N] i64, u [N], v [N])."""
        dt = self.dtype
        o, d, mint, maxt = (x.to(dt) for x in (o, d, mint, maxt))
        N = o.shape[0]
        t_out = torch.full((N,), BIG, dtype=dt, device=o.device)
        prim_out = torch.full((N,), -1, dtype=torch.int64, device=o.device)
        u_out = torch.zeros(N, dtype=dt, device=o.device)
        v_out = torch.zeros(N, dtype=dt, device=o.device)
        live = (maxt > mint).nonzero(as_tuple=True)[0]
        for a in range(0, live.shape[0], self.ray_chunk):
            ids = live[a:a + self.ray_chunk]
            oc, dc, mc, xc = o[ids], d[ids], mint[ids], maxt[ids]
            r, k = self._pairs(oc, dc, mc, xc)
            parts = []
            for b in range(0, r.shape[0], self.pair_chunk):
                rq, kq = r[b:b + self.pair_chunk], k[b:b + self.pair_chunk]
                t, u, v, ok = self._mt(oc, dc, mc, xc, rq, kq)
                t = torch.where(ok, t, torch.full_like(t, BIG))
                pr = torch.where(ok, self.prim[kq], NONE)
                # each pair's best lane: smallest t, then lowest triangle
                tq = t.amin(1)
                lane = torch.where(t == tq[:, None], pr,
                                   NONE).argmin(1)[:, None]
                parts.append((rq, tq, pr.gather(1, lane)[:, 0],
                              u.gather(1, lane)[:, 0],
                              v.gather(1, lane)[:, 0]))
            n = ids.shape[0]
            best_t = torch.full((n,), BIG, dtype=dt, device=o.device)
            best_p = torch.full((n,), NONE, dtype=torch.int64,
                                device=o.device)
            best_u = torch.zeros(n, dtype=dt, device=o.device)
            best_v = torch.zeros(n, dtype=dt, device=o.device)
            if parts:
                rq, tq, pq, uq, vq = (torch.cat(c) for c in zip(*parts))
                best_t = best_t.scatter_reduce(0, rq, tq, "amin")
                at_min = (tq == best_t[rq]) & (pq != NONE)
                best_p = best_p.scatter_reduce(
                    0, rq, torch.where(at_min, pq, NONE), "amin")
                win = at_min & (pq == best_p[rq])
                best_u[rq[win]] = uq[win]
                best_v[rq[win]] = vq[win]
            best_p = torch.where(best_p == NONE, -1, best_p)
            t_out[ids], prim_out[ids] = best_t, best_p
            u_out[ids], v_out[ids] = best_u, best_v
        valid = prim_out >= 0
        return valid, t_out, prim_out, u_out, v_out

    def occluded(self, o, d, mint, maxt):
        """Any hit with mint < t < maxt: [N] bool."""
        dt = self.dtype
        o, d, mint, maxt = (x.to(dt) for x in (o, d, mint, maxt))
        N = o.shape[0]
        out = torch.zeros(N, dtype=torch.bool, device=o.device)
        live = (maxt > mint).nonzero(as_tuple=True)[0]
        for a in range(0, live.shape[0], self.ray_chunk):
            ids = live[a:a + self.ray_chunk]
            oc, dc, mc, xc = o[ids], d[ids], mint[ids], maxt[ids]
            r, k = self._pairs(oc, dc, mc, xc)
            hit = torch.zeros(ids.shape[0], dtype=torch.bool,
                              device=o.device)
            for b in range(0, r.shape[0], self.pair_chunk):
                rq, kq = r[b:b + self.pair_chunk], k[b:b + self.pair_chunk]
                ok = self._mt(oc, dc, mc, xc, rq, kq)[3].any(1)
                hit[rq[ok]] = True
            out[ids] = hit
        return out
