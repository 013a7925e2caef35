"""Closest-hit / any-hit traversal of the clustered triangle soup.

Counterpart of gradientdomain_mitsuba_tpu/ops/pallas_trace.py for its
three traversal kernels, each with its plain PyTorch version:

  v7 (`_v7_kernel` with the XLA-side `_v7_phase1` / `_v7_expand` culling
     rounds; the default large-scene kernel): csrc/trace.cu, persistent
     warps, each walking one ray's superclusters and then their members
     near to far with early exit, over SoA box tables built once per
     cbounds (TraversalKernel.box_tables, which v4 and v2 read too;
     make_pair_intersector / make_pair_occluder);
  v4 (`_mt_kernel` with `_super_worklists`; GDMT_KERNEL=v4): the same
     function over the same tables (slabs and SoA box tables),
     csrc/trace_block.cu: a block of 64 rays shares one near-to-far
     supercluster worklist, its warps sweep lanes across triangles, and a
     cluster's slab is read once per block for every ray of the block
     that enters it (BlockKernel "mt", make_mt_intersector /
     make_mt_occluder), with the optional ray sort around it (sort_rays,
     GDMT_RAY_SORT);
  v2 (`_traverse_kernel`; the reference's make_pallas_intersector /
     make_pallas_occluder): pairwise Moeller-Trumbore over `tri9` slabs,
     csrc/trace_block.cu: the same block walk over the same box tables,
     with the tri9 rows and the pairwise test in place of the linear-MT
     coefficients (BlockKernel "tri9", make_tri9_intersector /
     make_tri9_occluder).

The scene loader lays triangles out cluster-major: cluster k owns prim
slots [k*W, (k+1)*W) of the window-padded soup, its linear-MT
coefficients sit in the 8-row slab mt_slabs[k] (ops/intersect.
build_mt_slabs), its v0/e1/e2 rows in tri9[k] (tri9_from_soup) and its
bounds in cbounds[k] = (min xyz, max xyz).  SUPER_FACTOR consecutive
clusters form a supercluster.  A ray tests the supercluster boxes, then
the member boxes of each pending supercluster, then every triangle of
each pending member; a hit's prim is k*W + lane, the row of tri_shade.
The box tests are the reference's expressions:

  inv = where(|d| > 1e-12, 1/d, 1e30)
  tn = max_axes min((lo - o)*inv, (hi - o)*inv), tf = max..min likewise
  pending = tn <= tf & tf >= mint & tn <= t & t >= mint   (member id >= 0)

with t the ray's bound.  The triangle test of v7 and v4 is divide-first
linear MT for both queries: inv = 1/det, u = u_num*inv, v = v_num*inv,
t = t_num*inv, ok = u >= 0 & v >= 0 & u + v <= 1 & t > mint & t < maxt.
v2's is ops/intersect._mt.  A miss is t = 3e38 (F32_MAX), u = v = 0,
prim = -1.  Among equal minimal t the lowest prim wins, whatever order a
kernel visits clusters in (the reference keeps the first hit in its
visit order instead: a documented deviation).

Environment switches: GDMT_KERNEL is read by ops/common.
choose_intersector as the reference reads it ("pairs", the default,
takes v7; any other value v4), GDMT_RAY_SORT here (RAY_SORT, default
off), as pallas_trace.py reads it.  GDMT_SUPER_FACTOR, GDMT_RBLK and
GDMT_PAIR_* are TPU tiling knobs and are not ported: SUPER_FACTOR is
fixed at 128 and the CUDA kernels choose their own blocking.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from .. import native
from . import intersect as isec

SUPER_FACTOR = 128        # clusters per supercluster
# widest cluster window taken (a warp lane then sweeps 128 triangles of
# each pending cluster).  The loader's window is 128 for every repo scene
# and grows in steps of 128 only under a larger GDMT_CLUSTER_TARGET.
MAX_WINDOW = 4096
F32_MAX = isec.F32_MAX

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
_SRC = os.path.join(_CSRC, "trace.cu")
_BLOCK_SRC = os.path.join(_CSRC, "trace_block.cu")
# superclusters the CUDA kernels take: the block kernels sort a block's
# pending superclusters in shared memory (16 bytes an entry, 64 KB at
# 4096), the pair kernels keep each warp's S keys there (4 bytes each:
# 128 KB a block of 8 warps at 4096).  The wrappers raise above it; the
# plain versions take any S.
MAX_SUPERS = 4096
# the v4 wrappers' default ray sort: the reference's RAY_SORT, off unless
# GDMT_RAY_SORT is set to something other than "0"
RAY_SORT = os.environ.get("GDMT_RAY_SORT", "0") != "0"

# plain version: rays per chunk of the supercluster test, (ray, super)
# pairs per chunk of the member test, (ray, cluster) pairs per chunk of
# the triangle sweep.  At W = 128 a sweep chunk gathers 8192 x 11 KB of
# slab rows (90 MB); the forest's tables take 1.45 GB of the card beside
# it.
RAY_CHUNK = 8192
SUPER_PAIR_CHUNK = 16384
PAIR_CHUNK = 8192


def _check_pair_super_factor():
    """The pair kernels walk SUPER_FACTOR == 128 members per
    supercluster (four 32-lane ballots in csrc/trace.cu, as the
    reference's v7 records pack four 32-bit member masks)."""
    if SUPER_FACTOR != 128:
        raise ValueError(f"SUPER_FACTOR={SUPER_FACTOR}: the pair kernels "
                         "require 128 members per supercluster")


def _check_window(window: int):
    if window <= 0 or window % 128 or window > MAX_WINDOW:
        raise ValueError(f"cluster window {window} is not a multiple of "
                         f"128 in [128, {MAX_WINDOW}]")


def _super_bounds(cbounds):
    """[S, 6] supercluster bounds: union of SUPER_FACTOR consecutive
    clusters (padding clusters get inverted boxes that never extend the
    union)."""
    K = cbounds.shape[0]
    SC = SUPER_FACTOR
    Kp = -(-K // SC) * SC
    cb = cbounds
    if Kp != K:
        pad = cbounds.new_full((Kp - K, 6), F32_MAX)
        pad[:, 3:6] = -F32_MAX
        cb = torch.cat([cbounds, pad], dim=0)
    return torch.cat([cb[:, 0:3].reshape(-1, SC, 3).amin(1),
                      cb[:, 3:6].reshape(-1, SC, 3).amax(1)], dim=1)


def _member_slabs(cbounds):
    """[S, 8, SC] member bounds per supercluster: row 0 = member cluster
    id (f32; -1 marks padding past K), rows 1-3 = bbox min, rows 4-6 =
    bbox max, row 7 = zeros."""
    K = cbounds.shape[0]
    SC = SUPER_FACTOR
    Kp = -(-K // SC) * SC
    ids = torch.arange(Kp, device=cbounds.device)
    cb = torch.cat([cbounds, cbounds.new_zeros((Kp - K, 6))], dim=0)
    rows = torch.cat([torch.where(ids < K, ids, -1).to(cbounds.dtype)[:, None],
                      cb, cbounds.new_zeros((Kp, 1))], dim=1)     # [Kp, 8]
    return rows.reshape(-1, SC, 8).transpose(1, 2).contiguous()


def _inv_dir(d):
    return torch.where(d.abs() > 1e-12, 1.0 / d, 1e30)


def _box_pending(o, inv, lo, hi, mint, bound):
    """The reference's ray/box test.  o, inv [..., 3] and lo, hi [..., 3]
    broadcast against each other; mint, bound broadcast against the
    result."""
    t0 = (lo - o) * inv
    t1 = (hi - o) * inv
    tn = torch.minimum(t0, t1).amax(-1)
    tf = torch.maximum(t0, t1).amin(-1)
    return (tn <= tf) & (tf >= mint) & (tn <= bound) & (bound >= mint)


def _features(o, d):
    """Ray features of the slab split, each product rounded once:
    fa = (o x d, d) for det|u|v, fb = o for t (its constant feature is 1).
    The kernels form the same values with _rn intrinsics."""
    ox, oy, oz = o.unbind(-1)
    dx, dy, dz = d.unbind(-1)
    fa = torch.stack([oy * dz - oz * dy, oz * dx - ox * dz,
                      ox * dy - oy * dx, dx, dy, dz], dim=-1)
    return fa, o


def _dot(f, c):
    """sum_k f[:, k] * c[:, k, :] as the kernels' fmaf chain in feature
    order: s = f0*c0, then s = fma(f_k, c_k, s).  Each fused step is
    emulated in float64 (a product of two floats is exact there) and
    rounded once to float32; it differs from a true fma only when the
    float64 sum rounds onto a float32 tie (about one step in 2^29)."""
    s = f[:, 0:1] * c[:, 0]
    for k in range(1, f.shape[1]):
        s = (f[:, k:k + 1].double() * c[:, k].double() + s.double()).float()
    return s


def _candidates(o, d, mint, maxt, scb, mb):
    """(ray, cluster) pairs whose member box passes against maxt, for
    one chunk of rays, from the supercluster bounds scb [S, 6] and the
    member slabs mb [S, 8, SC]: returns (ray index [P] i64, cluster id
    [P] i64)."""
    inv = _inv_dir(d)
    sup = _box_pending(o[:, None], inv[:, None], scb[None, :, 0:3],
                       scb[None, :, 3:6], mint[:, None], maxt[:, None])
    r1, s1 = sup.nonzero(as_tuple=True)
    rays, ks = [], []
    for a in range(0, r1.shape[0], SUPER_PAIR_CHUNK):
        r = r1[a:a + SUPER_PAIR_CHUNK]
        m = mb[s1[a:a + SUPER_PAIR_CHUNK]]                   # [P, 8, SC]
        pend = (m[:, 0] >= 0) & _box_pending(
            o[r, None], inv[r, None], m[:, 1:4].transpose(1, 2),
            m[:, 4:7].transpose(1, 2), mint[r, None], maxt[r, None])
        p, j = pend.nonzero(as_tuple=True)
        rays.append(r[p])
        ks.append(m[p, 0, j].long())
    if not rays:
        empty = torch.zeros(0, dtype=torch.int64, device=o.device)
        return empty, empty
    return torch.cat(rays), torch.cat(ks)


def _best_lane(ok, t, u, v):
    """Per pair (row): the minimal hit t (F32_MAX for none), its lowest
    lane among equal t, and that lane's u, v."""
    W = t.shape[1]
    tt = torch.where(ok, t, F32_MAX)
    tbest = tt.amin(1)
    lanes = torch.arange(W, device=tt.device)
    lane = torch.where(tt == tbest[:, None], lanes, W).amin(1)
    pick = torch.clamp_max(lane, W - 1)[:, None]
    return (tbest, lane, u.gather(1, pick)[:, 0], v.gather(1, pick)[:, 0])


def _sweep_pairs(fa, fb, mint, maxt, slabs, window, ray, k):
    """Divide-first linear-MT test of every triangle of cluster k[p]
    against ray[p], bounded by (mint, maxt).  Returns the per-pair best
    (t [P] with F32_MAX for none, lane [P], u [P], v [P])."""
    W = window
    sa = slabs[:, 0:6, 0:3 * W][k]                  # [P, 6, 3W]
    sb = slabs[:, 0:4, 3 * W:][k]                   # [P, 4, W]
    f = fa[ray]
    det = _dot(f, sa[:, :, 0:W])
    un = _dot(f, sa[:, :, W:2 * W])
    vn = _dot(f, sa[:, :, 2 * W:3 * W])
    tn = _dot(fb[ray], sb[:, 0:3]) + sb[:, 3]
    inv = 1.0 / det
    u = un * inv
    v = vn * inv
    t = tn * inv
    ok = ((u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) &
          (t > mint[ray, None]) & (t < maxt[ray, None]))
    return _best_lane(ok, t, u, v)


def _sweep_tri9(o, d, mint, maxt, tri9, ray, k):
    """Pairwise Moeller-Trumbore (ops/intersect._mt) of every triangle of
    cluster k[p] against ray[p], from the tri9 rows.  Returns the per-pair
    best as _sweep_pairs does."""
    rows = tri9[k, 0:9].transpose(1, 2)             # [P, W, 9]
    t, u, v, ok = isec._mt(o[ray, None], d[ray, None], rows[..., 0:3],
                           rows[..., 3:6], rows[..., 6:9], mint[ray, None],
                           maxt[ray, None])
    return _best_lane(ok, t, u, v)


def _walk_plain(o, d, mint, maxt, cbounds, window, any_hit, sweep):
    """The plain traversal shared by the three kernels' plain versions.

    It keeps no running t: every cluster whose box passes against maxt
    is swept (sweep(ray, k) -> per-pair best), a superset of what the
    kernels sweep, so it shares no traversal order with them.  Work is
    chunked over rays and over (ray, cluster) pairs.  Returns a Hit
    (closest) or occluded [N] bool (any hit)."""
    _check_pair_super_factor()
    _check_window(window)
    N = o.shape[0]
    W = window
    dev = o.device
    scb = _super_bounds(cbounds)
    mb = _member_slabs(cbounds)
    t_out = torch.full((N,), F32_MAX, device=dev)
    u_out = torch.zeros(N, device=dev)
    v_out = torch.zeros(N, device=dev)
    p_out = torch.full((N,), -1, dtype=torch.int32, device=dev)
    occ = torch.zeros(N, dtype=torch.bool, device=dev)
    for a in range(0, N, RAY_CHUNK):
        sl = slice(a, min(a + RAY_CHUNK, N))
        ray, k = _candidates(o[sl], d[sl], mint[sl], maxt[sl], scb, mb)
        ray = ray + a
        parts = [sweep(ray[b:b + PAIR_CHUNK], k[b:b + PAIR_CHUNK])
                 for b in range(0, ray.shape[0], PAIR_CHUNK)]
        if not parts:
            continue
        tp, lane, up, vp = (torch.cat(x) for x in zip(*parts))
        hit = tp < F32_MAX
        if any_hit:
            occ[ray[hit]] = True
            continue
        # per ray: minimal t, then the lowest prim among equal minimal t
        prim = k * W + lane
        t_out.scatter_reduce_(0, ray, tp, "amin")
        best = hit & (tp == t_out[ray])
        big = torch.iinfo(torch.int64).max
        pmin = torch.full((N,), big, dtype=torch.int64, device=dev)
        pmin.scatter_reduce_(0, ray[best], prim[best], "amin")
        win = best & (prim == pmin[ray])
        u_out[ray[win]] = up[win]
        v_out[ray[win]] = vp[win]
        p_out[ray[win]] = prim[win].to(torch.int32)
    if any_hit:
        return occ
    return isec.Hit(t=t_out, u=u_out, v=v_out, prim=p_out, valid=p_out >= 0)


def pair_plain(o, d, mint, maxt, slabs, cbounds, window, any_hit=False):
    """Plain PyTorch version of the v7 pair kernels and of the v4 block
    kernels (the CPU path and the kernels' oracle on the card): the
    divide-first linear-MT test over mt_slabs (_walk_plain)."""
    fa, fb = _features(o, d)
    return _walk_plain(
        o, d, mint, maxt, cbounds, window, any_hit,
        lambda ray, k: _sweep_pairs(fa, fb, mint, maxt, slabs, window, ray,
                                    k))


def tri9_plain(o, d, mint, maxt, tri9, cbounds, window, any_hit=False):
    """Plain PyTorch version of the v2 block kernels: the pairwise
    Moeller-Trumbore test (ops/intersect._mt) over the tri9 rows of every
    (ray, cluster) pair that _candidates keeps (_walk_plain).  The
    reference's v2 culls per cluster against its block's rays; super ->
    member culling keeps every cluster a ray enters (a member box lies
    inside its supercluster's), so it computes the same function."""
    return _walk_plain(
        o, d, mint, maxt, cbounds, window, any_hit,
        lambda ray, k: _sweep_tri9(o, d, mint, maxt, tri9, ray, k))


def tri9_from_soup(tris, window):
    """[K, 16, W] tri9 slabs of a cluster-major window-padded soup (the
    loader's recipe, scene/prep_cache.py): rows 0-8 = v0, e1, e2 xyz of
    the cluster's W slots, rows 9-15 zero.  `tris` holds v0/e1/e2 [K*W, 3]
    tensors of either device (a TriSoup)."""
    v0 = tris.v0
    K = v0.shape[0] // window
    rows = torch.cat([v0, tris.e1, tris.e2], dim=1)            # [Tp, 9]
    tri9 = v0.new_zeros((K, 16, window))
    tri9[:, :9] = rows.T.reshape(9, K, window).transpose(0, 1)
    return tri9


def _part1by2(x):
    """Spread the low 10 bits of x so there are 2 zero bits between each
    (Morton interleave helper)."""
    x = x & 0x3ff
    x = (x | (x << 16)) & 0x30000ff
    x = (x | (x << 8)) & 0x300f00f
    x = (x | (x << 4)) & 0x30c30c3
    x = (x | (x << 2)) & 0x9249249
    return x


def ray_sort_keys(o, d, bmin, bmax):
    """Coherence key of each ray: (direction octant << 21) |
    morton7(origin quantised to 128 cells per axis of [bmin, bmax])."""
    extent = torch.clamp_min(bmax - bmin, 1e-6)
    q = torch.clamp((o - bmin[None]) / extent[None] * 127.0, 0.0,
                    127.0).to(torch.int32)
    morton = (_part1by2(q[:, 0]) | (_part1by2(q[:, 1]) << 1) |
              (_part1by2(q[:, 2]) << 2))
    octant = ((d[:, 0] < 0).to(torch.int32) * 4 +
              (d[:, 1] < 0).to(torch.int32) * 2 +
              (d[:, 2] < 0).to(torch.int32))
    return (octant << 21) | morton


def sort_rays(o, d, mint, maxt, bmin, bmax):
    """Counterpart of the reference's sort_rays: the rays sorted by
    ray_sort_keys, ascending (stable), and `inv`, the original index of
    each sorted ray.  Results come back in the original order with
    out[inv] = sorted_out.  torch.sort and gathers replace the payload
    that the TPU version carries through its sort network."""
    _, inv = torch.sort(ray_sort_keys(o, d, bmin, bmax), stable=True)
    return o[inv], d[inv], mint[inv], maxt[inv], inv


def load_library():
    """Build (first call only) and load the pair kernels' library."""
    p, i = ctypes.c_void_p, ctypes.c_int
    return native.load_cuda("trace", _SRC, {
        "pair_closest": [p] * 7 + [i] * 4 + [p] * 7,
        "pair_occluded": [p] * 7 + [i] * 4 + [p] * 4})


def load_block_library():
    """Build (first call only) and load the v4 / v2 block kernels'
    library (csrc/trace_block.cu)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    closest = [p] * 7 + [i] * 4 + [p] * 6      # ... t, u, v, prim, stats
    occluded = [p] * 7 + [i] * 4 + [p] * 3     # ... occ, stats
    return native.load_cuda("trace_block", _BLOCK_SRC, {
        "mt_closest": closest, "mt_occluded": occluded,
        "tri9_closest": closest, "tri9_occluded": occluded})


def _check(o, d, mint, maxt, table, table_rows, table_cols, cbounds,
           window, n_clusters):
    """Validate what the kernels take: f32 contiguous tensors of matching
    shapes on one device (the per-cluster table [>= K, rows, cols]), and
    int32 prims and rays."""
    N = o.shape[0]
    K = n_clusters
    native.check_tensors(o, {
        "o": (o, (N, 3)), "d": (d, (N, 3)), "mint": (mint, (N,)),
        "maxt": (maxt, (N,)), "cbounds": (cbounds, (K, 6)),
        "table": (table, (table.shape[0], table_rows, table_cols))})
    if table.shape[0] < K:
        raise ValueError(f"{table.shape[0]} cluster slabs for {K} clusters")
    if table.data_ptr() % 16:
        raise ValueError("the cluster table must start 16-byte aligned")
    if K * window >= 2 ** 31 or N >= 2 ** 31:
        raise ValueError("prims or rays exceed the kernels' int32 range")


def _build_box_tables(cbounds):
    sb = _super_bounds(cbounds)
    if sb.shape[0] > MAX_SUPERS:
        raise ValueError(f"{sb.shape[0]} superclusters: the CUDA traversal "
                         f"kernels take at most {MAX_SUPERS}")
    return sb.T.contiguous(), _member_slabs(cbounds)


class TraversalKernel:
    """What the traversal wrappers share: a closest-hit or any-hit
    kernel with its launch count, called as (o, d, mint, maxt, table,
    cbounds).  A CPU tensor runs the plain version and does not count; a
    CUDA tensor launches the kernel or raises.  Every kernel reads the
    slab table and the SoA box tables (_kernel_tables).  Subclasses give
    the variant, the plain version, the library, the kernel's trailing
    pointers (_extra) and how many visit counters it has (n_stats)."""

    variant = ""

    def __init__(self, any_hit: bool, window: int, n_clusters: int):
        _check_pair_super_factor()
        _check_window(window)
        self.any_hit = any_hit
        self.window = int(window)
        self.n_clusters = int(n_clusters)
        self.launches = 0
        self._boxes = (None, None)   # (cbounds, its box tables)

    @property
    def name(self):
        return f"{self.variant}_{'occluded' if self.any_hit else 'closest'}"

    def box_tables(self, cbounds):
        """The SoA box tables of the v7, v4 and v2 kernels: supercluster
        bounds sbounds [6, S] (_super_bounds(cbounds) as rows min x, y, z,
        max x, y, z) and member bounds [S, 8, SUPER_FACTOR]
        (_member_slabs), so a warp reads each row as coalesced lines.
        Built once per cbounds table (a scene's cbounds is never changed
        in place); raises above MAX_SUPERS superclusters."""
        if self._boxes[0] is not cbounds:
            self._boxes = (cbounds, _build_box_tables(cbounds))
        return self._boxes[1]

    def _kernel_tables(self, cbounds):
        """The box tables the launch passes after the slab table, and S."""
        sb, members = self.box_tables(cbounds)
        return (sb, members), sb.shape[1]

    def count_visits(self, o, d, mint, maxt, table, cbounds):
        """One launch of the counting instantiation on CUDA tensors: the
        same walk as the main path's kernel, also counting it.  Returns
        (result, *counts) summed over the rays.  v7: clusters swept,
        superclusters whose members were tested; v4 and v2: (ray,
        128-triangle tile) sweeps, (block, cluster) slab reads, worklist
        entries some ray of the block entered."""
        if o.device.type != "cuda":
            raise ValueError("visit counts come from the CUDA kernel")
        _check(o, d, mint, maxt, table, *self._table_shape(), cbounds,
               self.window, self.n_clusters)
        stats = torch.zeros(self.n_stats, dtype=torch.int64,
                            device=o.device)
        out = self._launch(o, d, mint, maxt, table, cbounds, stats)
        return (out, *stats.tolist())

    def __call__(self, o, d, mint, maxt, table, cbounds):
        if o.device.type == "cpu":
            return self.plain(o, d, mint, maxt, table, cbounds)
        if o.device.type != "cuda":
            raise ValueError(f"no {self.name} kernel for device {o.device}")
        _check(o, d, mint, maxt, table, *self._table_shape(), cbounds,
               self.window, self.n_clusters)
        return self._launch(o, d, mint, maxt, table, cbounds)

    def _launch(self, o, d, mint, maxt, table, cbounds, stats=None):
        fn = getattr(self._library(), self.name)
        N = o.shape[0]
        with torch.cuda.device(o.device):
            tables, S = self._kernel_tables(cbounds)
            if self.any_hit:
                outs = (torch.empty(N, dtype=torch.bool, device=o.device),)
            else:
                t = torch.empty(N, dtype=torch.float32, device=o.device)
                outs = (t, torch.empty_like(t), torch.empty_like(t),
                        torch.empty(N, dtype=torch.int32, device=o.device))
            extra = self._extra(o.device, stats)
            stream = torch.cuda.current_stream(o.device).cuda_stream
            err = fn(*(x.data_ptr() for x in (o, d, mint, maxt, table,
                                               *tables)),
                     N, self.n_clusters, S, self.window,
                     *(x.data_ptr() for x in outs),
                     *(None if x is None else x.data_ptr() for x in extra),
                     stream)
        if err != 0:
            raise RuntimeError(f"{self.name} launch failed: CUDA error "
                               f"{err}")
        self.launches += 1
        if self.any_hit:
            return outs[0]
        t, u, v, prim = outs
        return isec.Hit(t=t, u=u, v=v, prim=prim, valid=prim >= 0)


class PairKernel(TraversalKernel):
    """One v7 pair traversal (closest hit or any hit), csrc/trace.cu.

    Call signature (o, d, mint, maxt, mt_slabs, cbounds), as the
    reference's make_pair_intersector / make_pair_occluder; plain
    version pair_plain."""

    variant = "pair"
    n_stats = 2

    def plain(self, o, d, mint, maxt, table, cbounds):
        return pair_plain(o, d, mint, maxt, table, cbounds, self.window,
                          self.any_hit)

    def _table_shape(self):
        return 8, 4 * self.window

    def _library(self):
        return load_library()

    def _extra(self, dev, stats):
        """The zeroed ray counter of the persistent warps and the
        optional visit counters (None: a null pointer)."""
        return [torch.zeros(1, dtype=torch.int32, device=dev), stats]


class BlockKernel(TraversalKernel):
    """One block traversal of csrc/trace_block.cu with its launch count:
    variant "mt" (the reference's v4, over mt_slabs; plain version
    pair_plain) or "tri9" (v2, over tri9 slabs; plain version
    tri9_plain), the one block walk (lanes across triangles, each slab
    read once per block of 64 rays) with either slab's test.  Call
    signature (o, d, mint, maxt, table, cbounds) with table = mt_slabs or
    tri9.  Both read the SoA box_tables the pair kernels read, and both
    count their walk (count_visits).  With ray_sort (v4 only; default
    GDMT_RAY_SORT) the rays are sorted by sort_rays before the launch and
    the results put back in the callers' order; the results are the same
    either way."""

    n_stats = 3

    def __init__(self, variant: str, any_hit: bool, window: int,
                 n_clusters: int, ray_sort: bool | None = None):
        if variant not in ("mt", "tri9"):
            raise ValueError(f"unknown block traversal {variant!r}")
        super().__init__(any_hit, window, n_clusters)
        self.variant = variant
        if ray_sort is None:
            ray_sort = RAY_SORT and variant == "mt"
        self.ray_sort = bool(ray_sort)

    def plain(self, o, d, mint, maxt, table, cbounds):
        fn = pair_plain if self.variant == "mt" else tri9_plain
        return fn(o, d, mint, maxt, table, cbounds, self.window,
                  self.any_hit)

    def _table_shape(self):
        if self.variant == "mt":
            return 8, 4 * self.window
        return 16, self.window

    def _library(self):
        return load_block_library()

    def _extra(self, dev, stats):
        """The optional visit counters (None: a null pointer)."""
        return [stats]

    def _launch(self, o, d, mint, maxt, table, cbounds, stats=None):
        if not self.ray_sort:
            return super()._launch(o, d, mint, maxt, table, cbounds, stats)
        return sorted_call(
            lambda *rays: super(BlockKernel, self)._launch(*rays, table,
                                                           cbounds, stats),
            self.any_hit, o, d, mint, maxt, cbounds[:, 0:3].amin(0),
            cbounds[:, 3:6].amax(0))


def sorted_call(fn, any_hit, o, d, mint, maxt, bmin, bmax):
    """fn(o, d, mint, maxt) -> Hit (or occluded [N] with any_hit) run on
    the rays sorted by sort_rays, with its results put back in the
    callers' order."""
    so, sd, smi, sma, inv = sort_rays(o, d, mint, maxt, bmin, bmax)
    out = fn(so, sd, smi, sma)
    if any_hit:
        return torch.empty_like(out).index_put_((inv,), out)
    back = [torch.empty_like(x).index_put_((inv,), x)
            for x in (out.t, out.u, out.v, out.prim)]
    return isec.Hit(*back, valid=back[3] >= 0)


def make_pair_intersector(window: int, n_clusters: int) -> PairKernel:
    """v7 closest hit: (o, d, mint, maxt, mt_slabs, cbounds) -> Hit."""
    return PairKernel(any_hit=False, window=window, n_clusters=n_clusters)


def make_pair_occluder(window: int, n_clusters: int) -> PairKernel:
    """v7 any hit: (o, d, mint, maxt, mt_slabs, cbounds) -> bool [N]."""
    return PairKernel(any_hit=True, window=window, n_clusters=n_clusters)


def make_mt_intersector(window: int, n_clusters: int,
                        ray_sort: bool | None = None) -> BlockKernel:
    """v4 closest hit: (o, d, mint, maxt, mt_slabs, cbounds) -> Hit."""
    return BlockKernel("mt", False, window, n_clusters, ray_sort)


def make_mt_occluder(window: int, n_clusters: int,
                     ray_sort: bool | None = None) -> BlockKernel:
    """v4 any hit: (o, d, mint, maxt, mt_slabs, cbounds) -> bool [N]."""
    return BlockKernel("mt", True, window, n_clusters, ray_sort)


def make_tri9_intersector(window: int, n_clusters: int) -> BlockKernel:
    """v2 closest hit: (o, d, mint, maxt, tri9, cbounds) -> Hit."""
    return BlockKernel("tri9", False, window, n_clusters)


def make_tri9_occluder(window: int, n_clusters: int) -> BlockKernel:
    """v2 any hit: (o, d, mint, maxt, tri9, cbounds) -> bool [N]."""
    return BlockKernel("tri9", True, window, n_clusters)


def random_cluster_soup(K, window, seed, n_rays):
    """A synthetic input of the pair traversal, for its tests and the
    smoke run: K clusters of up to `window` small random triangles around
    random centres, laid out cluster-major with zero padding columns as
    the scene loader does.  Returns numpy (o, d, mint, maxt, mt_slabs,
    cbounds, linC, tri9): rays aimed through the cloud, every 5th lane
    dead (maxt = -1), the full [10, 4*K*W] table of the whole-soup sweep
    and the [K, 16, W] tri9 slabs of the v2 kernels."""
    rs = np.random.RandomState(seed)
    W = window
    counts = rs.randint(W // 2, W + 1, size=K)
    centres = rs.uniform(-10, 10, (K, 3))
    v0 = np.zeros((K * W, 3), np.float32)
    e1 = np.zeros_like(v0)
    e2 = np.zeros_like(v0)
    cb = np.zeros((K, 6), np.float32)
    for k in range(K):
        n = counts[k]
        p0 = np.float32(centres[k] + rs.normal(0, 1.0, (n, 3)))
        p1 = np.float32(p0 + rs.normal(0, 0.4, (n, 3)))
        p2 = np.float32(p0 + rs.normal(0, 0.4, (n, 3)))
        sl = slice(k * W, k * W + n)
        v0[sl], e1[sl], e2[sl] = p0, p1 - p0, p2 - p0
        pts = np.concatenate([p0, p1, p2])
        cb[k] = np.concatenate([pts.min(0), pts.max(0)])
    linC = isec.build_linear_mt(v0, e1, e2)
    slabs = isec.build_mt_slabs(linC, W)
    o = np.float32(rs.uniform(-14, 14, (n_rays, 3)))
    target = np.float32(rs.uniform(-10, 10, (n_rays, 3)))
    d = target - o
    d = np.float32(d / np.linalg.norm(d, axis=-1, keepdims=True))
    mint = np.full(n_rays, 1e-4, np.float32)
    maxt = np.full(n_rays, 3e38, np.float32)
    maxt[::5] = -1.0
    tri9 = tri9_from_soup(isec.TriSoup(*map(torch.from_numpy, (v0, e1, e2)),
                                       orig_id=None), W).numpy()
    return o, d, mint, maxt, slabs, cb, linC, tri9
