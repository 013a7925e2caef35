"""Host-side scene intermediate representation.

Two-phase construction mirroring Mitsuba's Properties/ConfigurableObject
pattern (src/libcore/properties.cpp, cobject.cpp): the XML loader produces a
tree of generic `Plugin` nodes (type string + typed property bag + children),
and `scene.compile` interprets them into flat device arrays.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np


@dataclass
class Plugin:
    """One <tag type="..."> element: the universal plugin IR node."""
    kind: str                   # element tag: shape/bsdf/emitter/sensor/...
    type: str                   # plugin name: obj/diffuse/area/perspective/...
    props: Dict[str, Any] = field(default_factory=dict)
    children: List["Plugin"] = field(default_factory=list)
    id: Optional[str] = None

    def child(self, kind: str) -> Optional["Plugin"]:
        for c in self.children:
            if c.kind == kind:
                return c
        return None

    def children_of(self, kind: str) -> List["Plugin"]:
        return [c for c in self.children if c.kind == kind]

    def get(self, name, default=None):
        return self.props.get(name, default)


@dataclass
class SceneDesc:
    """Parsed scene: the root plugin tree plus resolved search paths."""
    integrator: Optional[Plugin]
    sensor: Optional[Plugin]
    shapes: List[Plugin]
    emitters: List[Plugin]          # scene-level (constant/envmap/point/...)
    media: List[Plugin]
    base_dir: str
    version: str = "0.5.0"


def spectrum_value(v, default=None) -> np.ndarray:
    """Coerce a parsed property into an RGB triple (f32[3])."""
    if v is None:
        return None if default is None else np.asarray(default, np.float32)
    if isinstance(v, (int, float)):
        return np.full(3, float(v), np.float32)
    a = np.asarray(v, np.float32)
    if a.ndim == 0:
        return np.full(3, float(a), np.float32)
    if a.shape == (3,):
        return a
    raise ValueError(f"cannot interpret spectrum value {v!r}")
