"""Checkpoints of the port's parameter trees as npz, no other dependency.

Port of the JAX package's ``training/checkpoint.py``: one npz entry per
leaf, keyed by the leaf's path (``['embed']``, ``['layers'][0]['attn']['wq']``),
and the metadata beside it as ``<path>.meta.json``.  bfloat16 leaves are
stored as float32 (numpy has no bfloat16), which ``restore`` casts back
exactly.

The reference keeps a model's layers stacked by group position:
``['groups'][j][...]`` holds layers j, j + group_size, ... along a leading
``n_groups`` axis, where the port keeps one dict per layer.
``save_params`` and ``restore_params`` write and read a model's
parameters in the reference's layout, so that either package restores the
other's file (``stack_layers`` and ``unstack_layers`` map between the two).
"""
from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.training.tree import leaves_with_paths, tree_map, tree_unflatten


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


def stack_layers(cfg: ArchConfig, params: dict) -> dict:
    """The port's parameters in the reference's layout: ``layers[i]`` with
    i = g * group_size + j goes to index g of ``groups[j]``."""
    out = {name: leaf for name, leaf in params.items() if name != "layers"}
    layers = params["layers"]
    out["groups"] = [
        tree_map(lambda *ls: torch.stack(ls), *layers[j::cfg.group_size]) for j in range(cfg.group_size)
    ]
    return out


def unstack_layers(cfg: ArchConfig, stacked: dict) -> dict:
    """The inverse of ``stack_layers``: one dict per layer."""
    out = {name: leaf for name, leaf in stacked.items() if name != "groups"}
    out["layers"] = [
        tree_map(lambda leaf, g=g: leaf[g], stacked["groups"][j])
        for g, j in (divmod(i, cfg.group_size) for i in range(cfg.n_layers))
    ]
    return out


def save_params(path: str, cfg: ArchConfig, params: dict, metadata: dict | None = None) -> None:
    """``save`` of a model's parameters in the reference's stacked layout:
    the reference's ``restore`` reads the file into its ``init_params``
    tree."""
    save(path, stack_layers(cfg, params), metadata)


def restore_params(path: str, cfg: ArchConfig, like: dict) -> dict:
    """A model's parameters from a file in the reference's stacked layout
    (``save_params``'s, or the reference's ``save`` of its parameters),
    shaped, typed and placed as ``like``."""
    return unstack_layers(cfg, restore(path, stack_layers(cfg, like)))
