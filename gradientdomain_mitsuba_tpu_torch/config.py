"""Device selection and numeric pins.

Counterpart of gradientdomain_mitsuba_tpu/utils/jaxconfig.py.  The
reference runs every linear-MT matmul at Precision.HIGHEST; on an NVIDIA
card a float32 matmul may run in TF32 (about three decimal digits), which
would move ray-triangle hit tests, so configure() pins full float32.
"""
from __future__ import annotations

import torch


def configure():
    """Pin float32 matmuls and convolutions to full float32 (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def get_device(name: str = "cuda") -> torch.device:
    """The torch.device for `name` ("cuda", "cuda:1", "cpu").  Raises when
    a CUDA device is asked for and none is available: there is no silent
    CPU fallback."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} requested but "
                           "torch.cuda.is_available() is False")
    configure()
    return dev
