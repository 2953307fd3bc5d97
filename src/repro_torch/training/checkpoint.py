"""Checkpoints of the port's parameter trees as npz, no other dependency.

Port of the JAX package's ``training/checkpoint.py``: one npz entry per
leaf, keyed by the leaf's path (``['layers'][0]['attn']['wq']``), and the
metadata beside it as ``<path>.meta.json``.  bfloat16 leaves are stored as
float32 (numpy has no bfloat16), which ``restore`` casts back exactly.
"""
from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

from repro_torch.training.tree import leaves_with_paths, tree_unflatten


def _array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def save(path: str, tree: Any, metadata: dict | None = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **{key: _array(leaf) for key, leaf in leaves_with_paths(tree)})
    if metadata is not None:
        with open(path + ".meta.json", "w") as f:
            json.dump(metadata, f)


def restore(path: str, like: Any) -> Any:
    """Restore into the structure of ``like`` (its leaves give each shape,
    dtype and device); raises ``ValueError`` on a shape that differs."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    leaves = []
    with np.load(path) as data:
        for key, leaf in leaves_with_paths(like):
            arr = data[key]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"{key}: checkpoint shape {arr.shape}, expected {tuple(leaf.shape)}")
            leaves.append(torch.from_numpy(arr).to(device=leaf.device, dtype=leaf.dtype))
    return tree_unflatten(like, leaves)


def load_metadata(path: str) -> dict:
    with open(path + ".meta.json") as f:
        return json.load(f)
