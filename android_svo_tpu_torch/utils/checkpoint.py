"""State checkpointing — port of `android_svo_tpu/utils/checkpoint.py`,
without JAX.

A checkpoint is a directory with `arrays.npz` (`leaf_i`, one array per
state tensor in the order the JAX state's pytree flattens in, which is
`state.field_paths()`) and `meta.json` (`n_leaves` and the caller's
`extra`): the files the JAX package writes, so a checkpoint either package
writes, the other reads.
"""

from __future__ import annotations

import json
import os

import numpy as np

from android_svo_tpu_torch.core import state as st


def save_state(path: str, vo, extra: dict | None = None) -> None:
    """Save a VOState (+ host metadata) to the directory `path`."""
    os.makedirs(path, exist_ok=True)
    flat = list(st.state_to_numpy(vo).values())
    np.savez(os.path.join(path, "arrays.npz"),
             **{f"leaf_{i}": x for i, x in enumerate(flat)})
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({"n_leaves": len(flat), "extra": extra or {}}, f)


def load_state(path: str, vo_like):
    """Restore a state with the layout of `vo_like` (same config and
    shapes) onto its device.  Returns (vo, extra)."""
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    paths = st.field_paths()
    if meta["n_leaves"] != len(paths):
        raise ValueError(f"checkpoint/config mismatch: {meta['n_leaves']} "
                         f"arrays, the state has {len(paths)}")
    with np.load(os.path.join(path, "arrays.npz")) as data:
        arrays = {k: data[f"leaf_{i}"] for i, k in enumerate(paths)}
    for k, a in arrays.items():
        want = tuple(st.get_field(vo_like, k).shape)
        if a.shape != want:
            raise ValueError(f"checkpoint/config mismatch at {k}: "
                             f"{a.shape} vs {want}")
    return (st.state_from_numpy(arrays, device=vo_like.frame_id.device),
            meta["extra"])


def save_handler(path: str, handler) -> None:
    """Checkpoint a FrameHandler (arenas + stage machine)."""
    save_state(path, handler.vo, extra={"stage": handler.stage,
                                        "n_fail": handler._n_fail})


def load_handler(path: str, handler) -> None:
    vo, extra = load_state(path, handler.vo)
    handler.vo = vo
    handler.stage = int(extra["stage"])
    handler._n_fail = int(extra["n_fail"])
