"""Native (C++/CUDA) libraries built at first use and bound with ctypes.

Counterpart of gradientdomain_mitsuba_tpu/native/__init__.py.  Libraries
are compiled into the git-ignored ``_build/`` directory of this package,
named by a hash of their sources and command line, so a changed source
never loads a stale library.  A build writes to a temporary file and
renames it into place, so concurrent processes never load a torn file.

  bvh_builder — the reference's binned-SAH BVH builder, compiled BY PATH
                from gradientdomain_mitsuba_tpu/native/bvh_builder.cpp
                (read as a source file; the reference package is never
                imported).  Both packages take the same route (native
                when it builds, Python otherwise), so both lay triangles
                out in the same order.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG, "_build")
BVH_SOURCE = os.path.join(os.path.dirname(_PKG), "gradientdomain_mitsuba_tpu",
                          "native", "bvh_builder.cpp")

_LOCK = threading.Lock()
_LIBS = {}


def build_library(name: str, sources, command) -> str:
    """Compile `sources` with `command(sources, out_path)` (an argv list)
    into BUILD_DIR unless an identical build is already there.  Returns
    the library path; raises RuntimeError with the compiler's output if
    the build fails."""
    h = hashlib.sha1()
    for src in sources:
        with open(src, "rb") as f:
            h.update(f.read())
    h.update(" ".join(command(sources, "OUT")).encode())
    out = os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
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
                _LIBS[name] = ctypes.CDLL(
                    build_library(name, [BVH_SOURCE], _gxx))
            except (OSError, RuntimeError):
                _LIBS[name] = None
        return _LIBS[name]
