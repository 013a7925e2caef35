"""Sampling-record currency as NamedTuples of tensors (SoA).

Counterpart of gradientdomain_mitsuba_tpu/core/records.py (Mitsuba's
Intersection record, include/mitsuba/render/shape.h).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch


class Intersection(NamedTuple):
    """Result of scene intersection for a batch of rays."""
    valid: torch.Tensor       # [...] bool — hit anything?
    t: torch.Tensor           # [...] hit distance
    p: torch.Tensor           # [..., 3] hit position
    ng: torch.Tensor          # [..., 3] geometric normal (unit)
    ns: torch.Tensor          # [..., 3] shading normal (unit)
    uv: torch.Tensor          # [..., 2] texture coords
    prim_id: torch.Tensor     # [...] int32 triangle index (BVH order)
    shape_id: torch.Tensor    # [...] int32 shape index
    bsdf_id: torch.Tensor     # [...] int32 material index (-1 = none)
    emitter_id: torch.Tensor  # [...] int32 area-emitter index (-1 = none)
    # barycentric-attribute payload (vertexcolors/wireframe/cloth); the
    # port does not build it yet, so it stays None
    bary: Any = None


def tree_map(fn, rec, *rest):
    """Apply fn field-wise over NamedTuple records (None fields stay
    None, nested records are mapped in turn) — the counterpart of
    jax.tree.map over a record."""
    out = []
    for vals in zip(rec, *rest):
        if vals[0] is None:
            out.append(None)
        elif hasattr(vals[0], "_fields"):
            out.append(tree_map(fn, *vals))
        else:
            out.append(fn(*vals))
    return type(rec)(*out)
