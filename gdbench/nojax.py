"""The check that no JAX module is loaded in the process.

A module counts by its top-level name, the part before the first dot,
compared whole: `gradientdomain_mitsuba_tpu_torch` (the program) is not
`gradientdomain_mitsuba_tpu` (the JAX package it was ported from)."""
from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "gradientdomain_mitsuba_tpu"})


def loaded(modules=None):
    """Sorted forbidden top-level names among the loaded modules."""
    names = sys.modules if modules is None else modules
    return sorted({n.split(".", 1)[0] for n in names} & FORBIDDEN)
