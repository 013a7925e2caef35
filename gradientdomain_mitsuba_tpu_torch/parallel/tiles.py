"""Row-sharded tile rendering over torch.distributed.

Counterpart of gradientdomain_mitsuba_tpu/parallel/tiles.py (Mitsuba's
scheduler + cluster rendering, src/libcore/sched.cpp, sched_remote.cpp).
The port runs one rank per device, and the rank is the shard: the film
is padded to a multiple of the world size and rank r renders rows
[r * rows, r * rows + rows) plus a B-row halo above and below, where
B = ceil(2 * filter radius).  The scene is replicated (every rank loads
it).  The gradient-domain coupling at tile boundaries (G-PT's dy pairs
straddle the row split, and wide reconstruction filters splat across it)
is handled by adding each halo into the neighbouring rank's rows
(_halo_exchange_add: point-to-point sends, no wraparound).  G-BDPT's
light image lands at arbitrary pixels, so every rank keeps full-film
light buffers, merged with one all_reduce.  The tile renderers gather
the film on every rank (_gather_host) and return the same numpy
buffers; render_final_sharded, a G-PT frame with its reconstruction,
keeps every buffer on the devices and gathers the blocks on rank 0's
device alone, which solves the whole frame, as Mitsuba's master
receives every block and runs the reconstruction.

Every collective call runs inside a `collective` span (device events)
of the program's trace and adds to its counters `collectives` and
`collective_bytes` (the bytes of this rank's input).

NCCL carries the collectives between CUDA devices and gloo between CPU
processes (parallel/multihost.init picks the backend).  Without an
initialized process group make_mesh gives a world of one on the
caller's device, and no collective is issued.
"""
from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..ops import film as film_ops
from ..utils import stats

# the normalized G-PT buffers a frame returns beside its final image
BUFFERS = ("primal", "very_direct", "dx", "dy")


class Mesh(NamedTuple):
    """The ranks a film is sharded over: `size` ranks, this process's
    `rank`, and the device its shard lives on."""
    size: int
    rank: int
    device: torch.device


def _group_device():
    """The device of this rank in the default group: the current CUDA
    device under NCCL, the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def make_mesh(n_devices=None, device=None):
    """The world of the default process group (one rank per device), or
    a world of one on `device` (default "cuda", resolved through
    config.get_device) when no group is initialized.  Raises when
    n_devices is given and is not the world size."""
    if dist.is_available() and dist.is_initialized():
        size, rank = dist.get_world_size(), dist.get_rank()
        dev = torch.device(device) if device is not None else \
            _group_device()
        mesh = Mesh(size, rank, dev)
    else:
        from ..config import get_device
        mesh = Mesh(1, 0, get_device(device or "cuda"))
    if n_devices is not None and n_devices != mesh.size:
        raise ValueError(
            f"n_devices={n_devices} but the world has {mesh.size} "
            "rank(s): the port runs one rank per device "
            "(parallel/multihost.init)")
    return mesh


def padded_rows(H, n_dev):
    return -(-H // n_dev) * n_dev


def halo_rows(filter_kind):
    """B: the halo rows a shard keeps above and below its rows."""
    return max(int(math.ceil(2 * film_ops.RADII[filter_kind])), 1)


@contextlib.contextmanager
def collective(*tensors):
    """The trace of one collective call: a `collective` span with device
    events, one `collectives` count and `collective_bytes` of the
    tensors this rank puts in."""
    with stats.span("collective", device=True):
        stats.count("collectives")
        stats.count("collective_bytes",
                    sum(t.numel() * t.element_size() for t in tensors))
        yield


def _pass_along(mesh, x, to):
    """Send x to rank + to (to = -1: up, +1: down) and return what
    rank - to sent the same way, zeros where that rank does not exist."""
    got = torch.zeros_like(x, memory_format=torch.contiguous_format)
    ops = []
    if 0 <= mesh.rank + to < mesh.size:
        ops.append(dist.P2POp(dist.isend, x.contiguous(), mesh.rank + to))
    if 0 <= mesh.rank - to < mesh.size:
        ops.append(dist.P2POp(dist.irecv, got, mesh.rank - to))
    if ops:
        with collective(x):
            for req in dist.batch_isend_irecv(ops):
                req.wait()
    return got


def _halo_exchange_add(fb, B, mesh):
    """fb: [rows_local + 2B, W, ...] accumulated with halo borders.
    Sends the top halo to the previous rank and the bottom halo to the
    next rank, adds what they send into the first and last B interior
    rows, and returns the interior [rows_local, W, ...]."""
    inner = fb[B:fb.shape[0] - B].clone()
    if mesh.size == 1:
        return inner
    # my top rows belong to rank - 1's bottom interior, my bottom rows
    # to rank + 1's top interior
    inner[inner.shape[0] - B:] += _pass_along(mesh, fb[:B], -1)
    inner[:B] += _pass_along(mesh, fb[fb.shape[0] - B:], 1)
    return inner


def _gather_host(v, H, mesh):
    """Every rank's row block of a row-sharded buffer, gathered on every
    rank (all_gather over equal padded blocks), cropped to the film's H
    rows, as a host numpy array."""
    if mesh.size > 1:
        parts = [torch.empty_like(v) for _ in range(mesh.size)]
        with collective(v):
            dist.all_gather(parts, v.contiguous())
        v = torch.cat(parts)
    return v[:H].cpu().numpy()


def _gather_root(v, H, mesh):
    """Every rank's [k, rows, ...] block of row-sharded buffers, gathered
    on rank 0's device (one gather) and cropped to the film's H rows;
    None on the other ranks."""
    if mesh.size > 1:
        parts = ([torch.empty_like(v) for _ in range(mesh.size)]
                 if mesh.rank == 0 else None)
        with collective(v):
            dist.gather(v.contiguous(), parts, dst=0)
        if parts is None:
            return None
        v = torch.cat(parts, 1)
    return v[:, :H]


def _all_reduce_sum(v, mesh):
    if mesh.size > 1:
        with collective(v):
            dist.all_reduce(v, op=dist.ReduceOp.SUM)
    return v


def _reduce_root(v, mesh):
    """The sum of v over the ranks on rank 0 (integer counts: exact)."""
    if mesh.size > 1:
        with collective(v):
            dist.reduce(v, dst=0, op=dist.ReduceOp.SUM)
    return v


def _shard(tracer, mesh):
    """(H, rows, B, row0) of this rank's shard: the film's height, the
    rows a rank renders, the halo and the shard's first film row."""
    H = tracer.settings.height
    rows = padded_rows(H, mesh.size) // mesh.size
    return H, rows, halo_rows(tracer.filter_kind), mesh.rank * rows


def row_ids(tracer, row0, rows):
    """The pixel ids of film rows [row0, row0 + rows) that lie on the
    film.  Rows past its height (the last shard's or tile's padding) get
    no lanes: their camera and light subpaths do not exist in the
    single-device render, and neither do their filter weights."""
    st = tracer.settings
    n = max(0, min(rows, st.height - row0)) * st.width
    return row0 * st.width + torch.arange(n, dtype=torch.int64,
                                          device=tracer.device)


def _zero_eye(Hl, W, device):
    def zero3():
        return torch.zeros((Hl, W, 3), device=device)

    return dict(primal=zero3(), dx=zero3(), dy=zero3(), very_direct=zero3(),
                wsum=torch.zeros((Hl, W), device=device))


def _add_eye(bufs, pos, primal, very, grad, filter_kind, B):
    """One pass's eye samples into local eye buffers whose row B is the
    lanes' first row.  The samples are grid-aligned (each lane is one
    pixel of the rows, at pixel + jitter), so the filtered images are
    dense adds of the jitter and the gradient pairs lattice adds at
    fixed offsets, as GBDPTracer.render_chunk does (no scatter)."""
    jit = (pos % 1.0)[None]
    fb, wb = film_ops.splat_grid(bufs["primal"], bufs["wsum"], jit,
                                 primal[None], filter_kind, row0=B)
    vd, _ = film_ops.splat_grid(bufs["very_direct"], torch.zeros_like(wb),
                                jit, very[None], filter_kind, row0=B)
    dx = film_ops.add_grid_shifted(bufs["dx"], grad[0][None], 0, 0, row0=B)
    dx = film_ops.add_grid_shifted(dx, -grad[1][None], -1, 0, row0=B)
    dy = film_ops.add_grid_shifted(bufs["dy"], grad[2][None], 0, 0, row0=B)
    dy = film_ops.add_grid_shifted(dy, -grad[3][None], 0, -1, row0=B)
    return dict(primal=fb, dx=dx, dy=dy, very_direct=vd, wsum=wb)


def render_rows_gpt(tracer, scene, seed, ids, rows, B, n_samples):
    """n_samples G-PT samples of the pixels `ids` (row_ids of `rows` film
    rows) into local (rows + 2B, W) buffers (B halo rows top and bottom)
    on the tracer's device: one trace_pass a sample, its film adds at
    local row offset B, and no host read inside the loop.  Pure: the
    same inputs give the same bits (the tile queue retries on that)."""
    bufs = _zero_eye(rows + 2 * B, tracer.settings.width, tracer.device)
    for i in range(n_samples if len(ids) else 0):
        pos, primal, very, grad = tracer.trace_pass(scene, seed, i,
                                                    pixel_id=ids)
        bufs = _add_eye(bufs, pos, primal, very, grad, tracer.filter_kind,
                        B)
    return bufs


def _render_shard_gpt(tracer, scene, mesh, seed, n_samples):
    """This rank's rows of a G-PT film on its device: rendered
    (render_rows_gpt, inside a `shard_render` span), the neighbours'
    halos added (one exchange each way for all five buffers: the adds are
    elementwise) and sample-normalized as GPTracer._normalize does.
    Returns primal, very_direct, dx, dy as [rows, W, 3]."""
    from ..models.gpt import GPTracer
    H, rows, B, row0 = _shard(tracer, mesh)
    with stats.span("shard_render", device=True, rank=mesh.rank):
        bufs = render_rows_gpt(tracer, scene, seed,
                               row_ids(tracer, row0, rows), rows, B,
                               n_samples)
    packed = torch.cat([bufs[k] for k in BUFFERS] +
                       [bufs["wsum"][..., None]], -1)
    inner = _halo_exchange_add(packed, B, mesh)
    out = dict(zip(BUFFERS + ("wsum",), inner.split(3, -1)))
    out["wsum"] = out["wsum"][..., 0]
    return GPTracer._normalize(out, n_samples)


def render_tiles_gpt(tracer, scene, mesh, seed, n_samples: int):
    """Row-sharded G-PT render over the mesh.

    Returns the global (gathered) buffers dict as numpy arrays on every
    rank, sample-normalized like GPTracer.render.  The per-shard work is
    render_final_sharded's (_render_shard_gpt)."""
    bufs = _render_shard_gpt(tracer, scene, mesh, seed, n_samples)
    H = tracer.settings.height
    return {k: _gather_host(v.contiguous(), H, mesh)
            for k, v in bufs.items()}


def render_final_sharded(tracer, scene, mesh, seed, spp, alpha=0.2,
                         mode="L1", l1_outer=8, l1_inner=40, l2_iters=100):
    """One final G-PT frame over the mesh, GPTracer.render_final's
    counterpart: each rank renders its rows (_render_shard_gpt), one
    gather brings every rank's buffers to rank 0's device, and rank 0
    solves the whole frame with models/poisson.reconstruct, bit for bit
    the single-device solve of those buffers.  Nothing goes through the
    host.

    A solve sharded over the rows would pace every CG step by the
    slowest rank's host (two row exchanges and two global sums a step,
    ~1,300 collectives a frame): on four H100s it took 66-148 ms an IRLS
    iteration for 2,073,600 pixels a card, where rank 0 alone takes
    ~110 ms for the whole 3840 x 2160 frame.

    Returns (final image [H, W, 3], buffers dict) on rank 0, full-frame
    tensors on its device, with count_rays the summed ray count as
    "rays" (a 0-d int64 tensor); None on the other ranks."""
    from ..models import poisson
    H = tracer.settings.height
    with stats.span("render", device=True):
        tracer.ray_tally = (torch.zeros((), dtype=torch.int64,
                                        device=tracer.device)
                            if tracer.count_rays else None)
        try:
            b = _render_shard_gpt(tracer, scene, mesh, seed, spp)
            rays = tracer.ray_tally
        finally:
            tracer.ray_tally = None
        full = _gather_root(torch.stack([b[k] for k in BUFFERS]), H, mesh)
        if rays is not None:
            rays = _reduce_root(rays, mesh)
        if full is None:
            return None
        out = dict(zip(BUFFERS, full.unbind(0)))
        final = poisson.reconstruct(out, alpha, mode, l2_iters, l1_outer,
                                    l1_inner)
    if rays is not None:
        out["rays"] = rays
    return final, out


def render_tiles_gbdpt(tracer, scene, mesh, seed, n_samples: int):
    """Row-sharded G-BDPT render over the mesh.

    The eye images (primal / very-direct and the camera-pixel gradient
    pairs) work as in render_tiles_gpt.  The light image and the t=1
    gradient pairs land at arbitrary film positions: every rank
    accumulates full-film light / dxt1 / dyt1 buffers through the
    deterministic scatter, one all_reduce(SUM) merges them (the splats
    are additive), and each rank keeps its own rows."""
    from ..models.gpt import OFFSETS

    H, rows, B, row0 = _shard(tracer, mesh)
    W, dev = tracer.settings.width, tracer.device
    ids = row_ids(tracer, row0, rows)
    offs = torch.tensor(OFFSETS, dtype=torch.float32, device=dev)
    bufs = _zero_eye(rows + 2 * B, W, dev)
    light, dxt1, dyt1 = torch.zeros((3, H, W, 3), device=dev)
    for i in range(n_samples if len(ids) else 0):
        (pos, primal, very, grad, spos, sval, t1p,
         t1g) = tracer.trace_pass(scene, seed, i, pixel_id=ids)
        bufs = _add_eye(bufs, pos, primal, very, grad, tracer.filter_kind,
                        B)
        # global film coordinates, the pairs in the eye pairs' forward /
        # backward lattice convention
        light = film_ops.splat_unfiltered(light, spos, sval)
        dxt1 = film_ops.splat_unfiltered(
            dxt1, torch.cat([t1p, t1p + offs[1]]),
            torch.cat([t1g[0], -t1g[1]]))
        dyt1 = film_ops.splat_unfiltered(
            dyt1, torch.cat([t1p, t1p + offs[3]]),
            torch.cat([t1g[2], -t1g[3]]))
    out = {k: _halo_exchange_add(v, B, mesh) for k, v in bufs.items()}
    # the full-film buffers: one sum over the ranks, then this rank's
    # rows (the last rank's padding rows are zero)
    full = _all_reduce_sum(torch.stack([light, dxt1, dyt1]), mesh)
    full = torch.nn.functional.pad(
        full, (0, 0, 0, 0, 0, rows * mesh.size - H))[:, row0:row0 + rows]
    out["light"] = full[0]
    out["dx"] = out["dx"] + full[1]
    out["dy"] = out["dy"] + full[2]
    out = {k: _gather_host(v, H, mesh) for k, v in out.items()}
    w = np.maximum(out.pop("wsum"), 1e-12)[..., None]
    return {
        # the light image merges into primal (it takes part in the
        # Poisson solve through the t=1 image-space gradient shifts:
        # GBDPTracer.finalize)
        "primal": out["primal"] / w + out["light"] / n_samples,
        "very_direct": out["very_direct"] / w,
        "dx": out["dx"] / n_samples,
        "dy": out["dy"] / n_samples,
    }


def render_tiles_path(tracer, scene, mesh, seed, n_samples: int):
    """Row-sharded plain path tracing (one buffer): multi-device `path`.
    Returns the normalized image [H, W, 3] as numpy on every rank."""
    H, rows, B, row0 = _shard(tracer, mesh)
    ids = row_ids(tracer, row0, rows)
    W, dev = tracer.settings.width, tracer.device
    fb = torch.zeros((rows + 2 * B, W, 3), device=dev)
    wb = torch.zeros((rows + 2 * B, W), device=dev)
    for i in range(n_samples if len(ids) else 0):
        pos, L = tracer.trace_pass(scene, seed, i, pixel_id=ids)
        fb, wb = film_ops.splat_grid(fb, wb, (pos % 1.0)[None], L[None],
                                     tracer.filter_kind, row0=B)
    fb = _gather_host(_halo_exchange_add(fb, B, mesh), H, mesh)
    wb = _gather_host(_halo_exchange_add(wb, B, mesh), H, mesh)
    return fb / np.maximum(wb, 1e-12)[..., None]
