"""Checkpointing.

The reference checkpoints best-accuracy model weights with torch.save each
epoch (demo_sgrace.py:595-610) and ships pretrained .ptx weights for preload
fine-tuning. Here a pytree (model parameters, or a whole train state's
arrays) is flattened and written with ``np.savez``; loading restores the
leaves into the structure of a target tree of the same shape.
"""

from __future__ import annotations

import os
from typing import Any

import jax
import numpy as np


def save_checkpoint(path: str, params: Any) -> None:
    """Save a pytree's leaves in flattening order (torch.save analogue)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    leaves = jax.tree_util.tree_leaves(jax.device_get(params))
    # a file object keeps np.savez from appending ".npz" to the path
    with open(path, "wb") as f:
        np.savez(f, *[np.asarray(x) for x in leaves])


def load_checkpoint(path: str, target: Any) -> Any:
    """Load leaves saved by save_checkpoint into the structure of target."""
    leaves, treedef = jax.tree_util.tree_flatten(target)
    with np.load(path) as z:
        loaded = [z[f"arr_{i}"] for i in range(len(z.files))]
    if len(loaded) != len(leaves):
        raise ValueError(
            f"checkpoint holds {len(loaded)} arrays, target has {len(leaves)}"
        )
    for i, (a, b) in enumerate(zip(loaded, leaves)):
        if a.shape != np.shape(b):
            raise ValueError(
                f"leaf {i}: checkpoint shape {a.shape} != target {np.shape(b)}"
            )
    return jax.tree_util.tree_unflatten(treedef, loaded)
