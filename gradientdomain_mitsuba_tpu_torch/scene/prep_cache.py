"""Geometry prep pipeline + disk cache: BVH, clusters, padded layout,
linear-MT table.

Counterpart of gradientdomain_mitsuba_tpu/scene/prep_cache.py, numpy only.
Everything that depends ONLY on the triangle soup and the cluster target
is built here in one shot, in the same order and layout as the
reference, so both packages hand identical tables to their traversal
kernels.

Cache layout, as the reference's: one directory of raw ``.npy`` files
per key (a blake2b hash of the geometry inputs) under
``<repo>/.gdmt_cache/geom/`` (override with GDMT_GEOM_CACHE, read at
each call; disable with GDMT_GEOM_CACHE=0), loaded with
``mmap_mode="r"`` (read-only: ``bridge.to_torch`` copies every array)
and marked whole by a ``.complete`` file.  A write goes to a temp
directory that ``os.replace`` moves into place, so a reader never sees
a torn entry; a writer that loses a race keeps the other writer's copy.
An entry that fails to load (no ``.complete``, a truncated file) is
rebuilt and replaced.  A failed write (read-only file system, full
disk) leaves the render uncached.  Only scenes of at least
CACHE_MIN_TRIS triangles are cached: test scenes prep in milliseconds
and would only churn the directory.

The version tag is the port's own (GEOM_CACHE_VERSION), so the two
packages never read each other's entries.  Hence the port has no
conversion of the 16-row ``mt_slabs`` entries the reference's loader
still accepts from before its round 5: no such entry carries the
port's tag.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import tempfile
import time

import numpy as np

from ..utils import stats
from . import bvh as bvh_mod

# Bump whenever the BVH builder, cluster extraction, padded layout, slab
# packing, or linear-MT coefficient format changes semantically.
GEOM_CACHE_VERSION = "torch-r4-2"  # the reference's r4-2 layout

CACHE_MIN_TRIS = 100_000


def _cache_dir():
    env = os.environ.get("GDMT_GEOM_CACHE")
    if env == "0":
        return None
    if env:
        return env
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(root, ".gdmt_cache", "geom")


def geometry_key(p0, p1, p2, target: int) -> str:
    h = hashlib.blake2b(digest_size=20)
    h.update(GEOM_CACHE_VERSION.encode())
    h.update(str(int(target)).encode())
    for a in (p0, p1, p2):
        arr = np.ascontiguousarray(a, np.float32)
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    return h.hexdigest()


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


def hash_arrays(*arrays, extra: str = "") -> str:
    """blake2b over a tuple of numpy arrays (+ an extra string tag)."""
    h = hashlib.blake2b(digest_size=20)
    h.update(GEOM_CACHE_VERSION.encode())
    h.update(extra.encode())
    for a in arrays:
        if a is None:
            h.update(b"<none>")
            continue
        arr = np.ascontiguousarray(a)
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    return h.hexdigest()


def load_or_build_array(key: str, build_fn, n_items: int, times=None,
                        tag: str = "aux"):
    """Disk-cached single array: load <cache>/<tag>-<key>.npy (mmap) or
    build_fn() + save.  n_items gates caching like CACHE_MIN_TRIS;
    times[tag + "_cache"] gets "hit" or "miss" (nothing when uncached)."""
    times = times if times is not None else {}
    cdir = _cache_dir()
    if cdir is None or n_items < CACHE_MIN_TRIS:
        return build_fn()
    path = os.path.join(cdir, f"{tag}-{key}.npy")
    if os.path.exists(path):
        try:
            with stats.span("cache_read"):
                out = np.load(path, mmap_mode="r", allow_pickle=False)
            times[tag + "_cache"] = "hit"
            return out
        except (OSError, ValueError, EOFError):
            pass  # torn file: rebuilt and replaced below
    times[tag + "_cache"] = "miss"
    arr = build_fn()
    try:
        with stats.span("cache_write"):
            os.makedirs(cdir, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=cdir, suffix=".npy.tmp")
            try:
                with os.fdopen(fd, "wb") as f:
                    np.save(f, np.ascontiguousarray(arr))
                os.replace(tmp, path)
            except BaseException:
                if os.path.exists(tmp):
                    os.unlink(tmp)
                raise
    except OSError:
        pass  # read-only fs / out of space: render proceeds uncached
    return arr


def _load_entry(path):
    """Every array of a complete cache entry (mmaps), or None when the
    entry is missing, unmarked or torn."""
    if not os.path.exists(os.path.join(path, ".complete")):
        return None
    try:
        return {fn[:-4]: np.load(os.path.join(path, fn), mmap_mode="r",
                                 allow_pickle=False)
                for fn in os.listdir(path) if fn.endswith(".npy")}
    except (OSError, ValueError, EOFError):
        return None


def _write_entry(cdir, path, out):
    """Write `out` as the entry at `path`: a temp directory moved into
    place.  A torn entry already there is moved aside and removed; a
    complete one (a concurrent writer's) is kept."""
    os.makedirs(cdir, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=cdir, suffix=".tmp")
    try:
        for k, v in out.items():
            # np.asarray keeps the 0-d scalars (window, tree_depth) 0-d;
            # the reference's np.ascontiguousarray stores them as [1]
            np.save(os.path.join(tmp, k + ".npy"), np.asarray(v))
        with open(os.path.join(tmp, ".complete"), "w") as f:
            f.write(GEOM_CACHE_VERSION)
        if os.path.exists(path) and _load_entry(path) is None:
            torn = tempfile.mkdtemp(dir=cdir, suffix=".torn")
            os.replace(path, os.path.join(torn, "entry"))
            shutil.rmtree(torn, ignore_errors=True)
        if os.path.exists(path):  # lost a concurrent race: keep theirs
            shutil.rmtree(tmp)
        else:
            os.replace(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def load_or_build(p0, p1, p2, target: int, times=None) -> dict:
    """Disk-cached build_geometry.  `times` (optional dict) receives the
    phase breakdown plus cache bookkeeping ('cache': 'hit'/'miss'/'off',
    'cache_io' seconds, 'geom_key')."""
    times = times if times is not None else {}
    T = len(p0)
    cdir = _cache_dir()
    if cdir is None or T < CACHE_MIN_TRIS:
        times["cache"] = "off"
        with stats.span("bvh_build"):
            return build_geometry(p0, p1, p2, target, times)

    t0 = time.time()
    with stats.span("cache_key"):
        key = geometry_key(p0, p1, p2, target)
    times["geom_key"] = key
    path = os.path.join(cdir, key)
    times["cache_key"] = time.time() - t0
    t0 = time.time()
    with stats.span("cache_read"):
        out = _load_entry(path)
    if out is not None:
        times["cache"] = "hit"
        times["cache_io"] = time.time() - t0
        return out

    times["cache"] = "miss"
    with stats.span("bvh_build"):
        out = build_geometry(p0, p1, p2, target, times)
    t0 = time.time()
    try:
        with stats.span("cache_write"):
            _write_entry(cdir, path, out)
    except OSError:
        pass  # read-only fs / out of space: render proceeds uncached
    times["cache_io"] = time.time() - t0
    return out
