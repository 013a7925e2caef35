"""Closest-hit / any-hit sweeps over the whole triangle soup.

Counterpart of gradientdomain_mitsuba_tpu/ops/pallas_sweep.py: the two
Pallas kernels _sweep_kernel and _occl_kernel become the hand-written
CUDA kernels of csrc/sweep.cu (see the note there for the design).  The
kernels read a packed table (pack_linear_mt) built once per linC: one
80-byte record for each column that can hit, holding the 19 coefficients
build_linear_mt can make non-zero and the column index.

A CPU tensor goes to the plain PyTorch version (ops/intersect.py
intersect_matmul / occluded_matmul).  A CUDA tensor launches the kernel or
raises: there is no fallback.  The kernels are compiled with nvcc at
first use (sm_90a, plain C interface, bound with ctypes) into the
package's git-ignored _build/ directory.
"""
from __future__ import annotations

import ctypes
import os

import torch

from .. import native
from . import intersect as isec

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "sweep.cu")

# rows of linC each column group may hold non-zero (build_linear_mt:
# det = -n . d, u and v from o x d and d, t from o and the constant),
# in the record's order: det, u, v, t
STRUCTURE = ((0, (3, 4, 5)), (1, (0, 1, 2, 3, 4, 5)),
             (2, (0, 1, 2, 3, 4, 5)), (3, (6, 7, 8, 9)))
RECORD_FLOATS = 20   # 19 coefficients + the column index as int bits
# records the kernels stage whole into one block's shared memory (160 KB)
MAX_RECORDS = 2048


def load_library():
    """Build (first call only) and load the sweep kernels' library."""
    p, i = ctypes.c_void_p, ctypes.c_int
    return native.load_cuda("sweep", _SRC, {
        "sweep_closest": [p, p, p, p, p, i, i, p, p, p, p, p],
        "sweep_occluded": [p, p, p, p, p, i, i, p, p]})


def pack_linear_mt(linC):
    """The kernels' packed table of a linear-MT table linC [10, 4T]:
    [n, 20] f32 on linC's device, one record per column whose det
    coefficients are not all zero, in increasing column order: det rows
    3:6, u rows 0:6, v rows 0:6, t rows 6:10, then the column index (int32
    bits).  A column whose det coefficients are all zero gives det = 0
    for every ray, so it can never hit and is left out.  Raises ValueError
    where a coefficient outside that structure is non-zero: the kernels
    would ignore it."""
    T = linC.shape[1] // 4
    C = linC.reshape(10, 4, T)
    structural = torch.zeros((10, 4), dtype=torch.bool, device=linC.device)
    for g, rows in STRUCTURE:
        structural[list(rows), g] = True
    stray = (C != 0) & ~structural[:, :, None]
    if bool(stray.any()):
        k, g, j = (int(x) for x in stray.nonzero()[0])
        raise ValueError(
            f"linC is not a linear Moeller-Trumbore table: row {k} of "
            f"column group {g} is non-zero (column {j})")
    cols = C[3:6, 0].ne(0).any(0).nonzero()[:, 0]
    rows = [C[list(r), g][:, cols] for g, r in STRUCTURE]
    ids = cols.to(torch.int32).view(torch.float32)[None]
    return torch.cat(rows + [ids]).t().contiguous()


def _check(o, d, mint, maxt, linC):
    """Validate what the kernel takes: CUDA f32 contiguous tensors of
    matching shapes on one device."""
    N = o.shape[0]
    native.check_tensors(o, {
        "o": (o, (N, 3)), "d": (d, (N, 3)), "mint": (mint, (N,)),
        "maxt": (maxt, (N,)), "linC": (linC, (10, linC.shape[-1]))})
    if linC.shape[1] % 4:
        raise ValueError(f"linC width {linC.shape[1]} is not 4*T")
    if N >= 2 ** 31:
        raise ValueError(f"{N} rays exceed the kernel's int32 index")


class SweepKernel:
    """One sweep (closest hit or any hit) with its launch count.

    Call signature (o, d, mint, maxt, linC), as intersect_matmul /
    occluded_matmul.  `launches` counts kernel launches only: a CPU call
    runs the plain version and does not count."""

    def __init__(self, any_hit: bool, n_tris: int):
        self.any_hit = any_hit
        self.n_tris = int(n_tris)
        self.launches = 0
        self._packed = (None, None)   # (linC, its packed table)

    @property
    def name(self):
        return "sweep_occluded" if self.any_hit else "sweep_closest"

    def plain(self, o, d, mint, maxt, linC):
        fn = isec.occluded_matmul if self.any_hit else isec.intersect_matmul
        return fn(o, d, mint, maxt, linC)

    def packed(self, linC):
        """pack_linear_mt(linC), built once per table (a scene's linC is
        never changed in place)."""
        if self._packed[0] is not linC:
            self._packed = (linC, pack_linear_mt(linC))
        return self._packed[1]

    def __call__(self, o, d, mint, maxt, linC):
        if o.device.type == "cpu":
            return self.plain(o, d, mint, maxt, linC)
        if o.device.type != "cuda":
            raise ValueError(f"no sweep kernel for device {o.device}")
        _check(o, d, mint, maxt, linC)
        T = linC.shape[1] // 4
        if T < self.n_tris:
            raise ValueError(f"linC holds {T} triangles, scene has "
                             f"{self.n_tris}")
        return self._launch(o, d, mint, maxt, self.packed(linC))

    def _launch(self, o, d, mint, maxt, recs):
        """One kernel launch on the packed table recs [n, 20]."""
        n_rec = recs.shape[0]
        if n_rec > MAX_RECORDS:
            raise ValueError(f"{n_rec} triangles exceed the kernels' "
                             f"{MAX_RECORDS} (one block's shared memory)")
        lib = load_library()
        N = o.shape[0]
        stream = torch.cuda.current_stream(o.device).cuda_stream
        ptrs = [x.data_ptr() for x in (o, d, mint, maxt, recs)]
        with torch.cuda.device(o.device):
            if self.any_hit:
                occ = torch.empty(N, dtype=torch.bool, device=o.device)
                err = lib.sweep_occluded(*ptrs, N, n_rec, occ.data_ptr(),
                                         stream)
                out = occ
            else:
                t = torch.empty(N, dtype=torch.float32, device=o.device)
                u = torch.empty_like(t)
                v = torch.empty_like(t)
                prim = torch.empty(N, dtype=torch.int32, device=o.device)
                err = lib.sweep_closest(*ptrs, N, n_rec, t.data_ptr(),
                                        u.data_ptr(), v.data_ptr(),
                                        prim.data_ptr(), stream)
                valid = prim >= 0
                out = isec.Hit(t=t, u=u, v=v, prim=prim, valid=valid)
        if err != 0:
            raise RuntimeError(f"{self.name} launch failed: CUDA error "
                               f"{err}")
        self.launches += 1
        return out


def make_sweep_intersector(n_tris: int) -> SweepKernel:
    """Closest hit over the whole soup: (o, d, mint, maxt, linC) -> Hit."""
    return SweepKernel(any_hit=False, n_tris=n_tris)


def make_sweep_occluder(n_tris: int) -> SweepKernel:
    """Any hit over the whole soup: (o, d, mint, maxt, linC) -> bool [N]."""
    return SweepKernel(any_hit=True, n_tris=n_tris)
