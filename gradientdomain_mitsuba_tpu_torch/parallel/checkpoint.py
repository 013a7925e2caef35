"""Checkpoint / resume for long renders.

Counterpart of gradientdomain_mitsuba_tpu/parallel/checkpoint.py.  The
counter-based RNG makes checkpointing exact: the accumulated raw buffers
plus the next sample index fully determine the remaining work, so a
resumed render is bit-identical to an uninterrupted one.  Checkpoints are
.npz files with the reference's keys (__done, __seed, m_<meta>,
b_<buffer>).

Chunk states stay tensors on the tracer's device and are summed there;
they go to numpy only to be written to a checkpoint.
"""
from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch


def _flatten(state: dict):
    return {k: v.detach().cpu().numpy() if torch.is_tensor(v)
            else np.asarray(v) for k, v in state.items()}


def save(path: str, state: dict, done: int, seed: int, meta: dict):
    tmp = path + ".tmp.npz"
    np.savez_compressed(
        tmp, __done=done, __seed=seed,
        **{f"m_{k}": v for k, v in meta.items()},
        **{f"b_{k}": v for k, v in _flatten(state).items()})
    os.replace(tmp, path)


def load(path: str):
    """Returns (state dict of numpy arrays, done, seed, meta) or None if
    absent."""
    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=False) as z:
        state = {k[2:]: z[k] for k in z.files if k.startswith("b_")}
        meta = {k[2:]: z[k] for k in z.files if k.startswith("m_")}
        return state, int(z["__done"]), int(z["__seed"]), meta


def render_accumulate(tracer, scene, seed: int, spp: int, chunk: int = 64,
                      checkpoint_path: Optional[str] = None,
                      resume: bool = False, log=None, progress=None):
    """Drive tracer.render_chunk with optional checkpointing.

    The tracer exposes render_chunk(scene, seed, start, n) -> dict or
    tuple of accumulation buffers (raw sums; a tuple's entries are keyed
    "0", "1", ...) and `device`.  Returns (state dict of device tensors,
    spp)."""
    state = None
    done = 0
    if resume and checkpoint_path:
        ck = load(checkpoint_path)
        if ck is not None:
            state_np, done, ck_seed, meta = ck
            if ck_seed != seed:
                raise ValueError(
                    f"checkpoint seed {ck_seed} != requested {seed}")
            state = {k: torch.from_numpy(v).to(tracer.device)
                     for k, v in state_np.items()}
            if log:
                log(f"[checkpoint] resumed at sample {done}/{spp}")
    while done < spp:
        n = min(chunk, spp - done)
        out = tracer.render_chunk(scene, seed, done, n)
        if not isinstance(out, dict):
            out = {str(i): v for i, v in enumerate(out)}
        state = out if state is None else \
            {k: state[k] + out[k] for k in out}
        done += n
        if progress:
            progress(state, done)
        if checkpoint_path:
            save(checkpoint_path, state, done, seed,
                 {"spp": spp, "time": time.time()})
    return state, spp
