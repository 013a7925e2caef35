"""Scene state carried across: numpy SceneData -> tensors on a device.

The counterpart of the reference's jax.device_put(scene).  Takes a
SceneData of numpy arrays, from either package's loader (the NamedTuple
layouts are the same), and returns the same NamedTuple tree with every
array a tensor on `device`.  Dtypes are kept: f32 stays f32, i32 stays
i32, bool stays bool.  Numpy scalars become 0-d tensors; None stays None.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils import stats


def _leaf(x, device):
    if isinstance(x, (np.ndarray, np.generic)):
        arr = np.array(x, copy=True)   # writable, contiguous (memmaps too)
        return torch.from_numpy(arr).to(device)
    return x


def _tree(tree, device):
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree(v, device) for v in tree))
    return _leaf(tree, device)


def to_torch(tree, device):
    """Recursively move a NamedTuple tree of numpy arrays to `device`."""
    with stats.span("to_torch"):
        return _tree(tree, torch.device(device))
