"""Native (C++/CUDA) libraries built at first use and bound with ctypes.

Counterpart of gradientdomain_mitsuba_tpu/native/__init__.py.  Libraries
are compiled into the git-ignored ``_build/`` directory of this package,
named by a hash of their sources and command line, so a changed source
never loads a stale library.  A build writes to a temporary file and
renames it into place, so concurrent processes never load a torn file.

  bvh_builder — the binned-SAH BVH builder, native/bvh_builder.cpp: a
                byte-identical copy of the reference's source (a CPU
                test holds the two equal).  Both packages take the same
                route (native when it builds, Python otherwise), so both
                lay triangles out in the same order.
  sweep, trace, trace_block, shade, gpt_shade — the CUDA kernels of
                csrc/ (ops/sweep.py, ops/trace.py, ops/shade.py,
                ops/gpt_shade.py),
                compiled by nvcc_command for sm_90a and loaded by
                load_cuda; check_tensors validates what their wrappers
                pass as pointers.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import torch

from ..utils import stats

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG, "_build")
BVH_SOURCE = os.path.join(_PKG, "native", "bvh_builder.cpp")

_LOCK = threading.Lock()
_LIBS = {}


def build_library(name: str, sources, command, deps=()) -> str:
    """Compile `sources` with `command(sources, out_path)` (an argv list)
    into BUILD_DIR unless an identical build is already there (a build
    adds to the trace's kernel_builds counter).  `deps`: files the
    sources include, hashed with them.  Returns the library path; raises
    RuntimeError with the compiler's output if the build fails."""
    h = hashlib.sha1()
    for src in (*sources, *deps):
        with open(src, "rb") as f:
            h.update(f.read())
    h.update(" ".join(command(sources, "OUT")).encode())
    out = os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    stats.count("kernel_builds")
    try:
        res = subprocess.run(command(sources, tmp), capture_output=True,
                             text=True)
        if res.returncode != 0:
            raise RuntimeError(f"building {name} failed:\n{res.stdout}\n"
                               f"{res.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _nvcc():
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME or PATH)")
    return found


def nvcc_command(sources, out, flags=()):
    """nvcc argv for a shared library with a plain C interface (sm_90a),
    with a library's own extra `flags`.  No --use_fast_math: the kernels'
    reciprocals must be IEEE."""
    return [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", *flags, "-shared", "-Xcompiler", "-fPIC",
            *sources, "-o", out]


def load_cuda(name: str, source: str, functions: dict, flags=(), deps=()):
    """Build `source` with nvcc and `flags` (first call only) and load it;
    `deps` are the files it includes.  `functions` maps each exported C
    function to its ctypes argtypes; every one returns an int (the CUDA
    error code).  The build runs outside the lock, so threads loading
    different libraries run their nvcc at the same time (build_library's
    rename keeps a build atomic)."""
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
    with stats.span("kernel_load", lib=name):
        path = build_library(
            name, [source], lambda src, out: nvcc_command(src, out, flags),
            deps=deps)
        with _LOCK:
            if name not in _LIBS:
                lib = ctypes.CDLL(path)
                for fn, argtypes in functions.items():
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = ctypes.c_int
                _LIBS[name] = lib
            return _LIBS[name]


def check_tensors(ref, specs: dict):
    """Validate kernel arguments before their pointers are passed: each
    name -> (tensor, expected shape) must be float32, contiguous, of that
    shape and on `ref`'s device."""
    for name, (x, shape) in specs.items():
        if x.device != ref.device:
            raise ValueError(f"{name} is on {x.device}, not {ref.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                             f"expected {tuple(shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _gxx(sources, out):
    # the reference's own flags (gradientdomain_mitsuba_tpu/native)
    return ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
            *sources, "-o", out]


def get_lib(name: str):
    """The BVH builder library, or None when it cannot be built here (the
    caller then takes the Python builder, as the reference does)."""
    if name != "bvh_builder":
        raise KeyError(name)
    with _LOCK:
        if name not in _LIBS:
            try:
                with stats.span("kernel_load", lib=name):
                    _LIBS[name] = ctypes.CDLL(
                        build_library(name, [BVH_SOURCE], _gxx))
            except (OSError, RuntimeError):
                _LIBS[name] = None
        return _LIBS[name]
