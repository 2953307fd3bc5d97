"""AdamW over the port's parameter trees.

Port of the JAX package's ``training/optimizer.py``, with its math: bias
corrections from the step count, decay added to the step's delta on the
leaves the reference decays (``decays``), moments stored in
``moments_dtype`` (float32, or bfloat16 for very large models) while the
arithmetic runs in float32.  These are torch ops on each leaf, not
``torch.optim.AdamW``, whose decay covers every tensor and is applied in
another order.  The update returns new tensors, as the reference returns
new arrays, so the parameters it was given stay valid.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.training.tree import leaves_with_paths, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    moments_dtype: torch.dtype = torch.float32


def decays(path: str, p: torch.Tensor) -> bool:
    """Whether AdamW decays the leaf at ``path`` (``leaves_with_paths``'s
    form) of the port's parameter tree: exactly where the reference's
    counterpart of that leaf has ``ndim >= 2``.

    The reference tests ``p.ndim >= 2`` (``src/repro/training/optimizer.py:56``)
    on its stacked tree, where every per-layer leaf carries a leading
    ``n_groups`` axis (``src/repro/models/transformer.py:110``).  The port keeps
    one dict per layer under ``params["layers"][i]``, so there a leaf with
    ``ndim >= 1`` (norm weights, qkv biases, RWKV's ``ln_x``, matrices) is
    decayed; a top-level leaf keeps the reference's ``ndim >= 2``."""
    return p.dim() >= (1 if path.startswith("['layers'][") else 2)


def adamw_init(params: Any, cfg: AdamWConfig) -> dict[str, Any]:
    """Zero moments of each parameter's shape in ``moments_dtype`` on its
    device, and the step count (an int32 scalar on the first leaf's
    device)."""
    zeros = lambda p: torch.zeros(p.shape, dtype=cfg.moments_dtype, device=p.device)  # noqa: E731
    first = leaves_with_paths(params)[0][1]
    return {
        "step": torch.zeros((), dtype=torch.int32, device=first.device),
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
    }


def adamw_update(
    grads: Any,
    state: dict[str, Any],
    params: Any,
    cfg: AdamWConfig,
    lr_scale: "torch.Tensor | float" = 1.0,
) -> tuple[Any, dict[str, Any]]:
    """Returns (new params, new state); ``lr_scale`` multiplies ``cfg.lr``
    (a schedule's value).  The leaves that ``decays`` names take the weight
    decay."""
    step = state["step"] + 1
    t = step.float()
    bc1 = 1.0 - cfg.b1**t
    bc2 = 1.0 - cfg.b2**t
    lr = cfg.lr * lr_scale

    def upd(g, m, v, path, p):
        g32 = g.float()
        m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g32
        v32 = cfg.b2 * v.float() + (1 - cfg.b2) * g32.square()
        delta = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
        if decays(path, p):
            delta = delta + cfg.weight_decay * p.float()
        new_p = (p.float() - lr * delta).to(p.dtype)
        return new_p, m32.to(cfg.moments_dtype), v32.to(cfg.moments_dtype)

    flat_p = leaves_with_paths(params)
    new = [
        upd(g, m, v, path, p)
        for (_, g), (_, m), (_, v), (path, p) in zip(
            leaves_with_paths(grads), leaves_with_paths(state["m"]), leaves_with_paths(state["v"]), flat_p,
            strict=True,
        )
    ]
    new_m = tree_unflatten(params, [n[1] for n in new])
    new_v = tree_unflatten(params, [n[2] for n in new])
    return tree_unflatten(params, [n[0] for n in new]), {"step": step, "m": new_m, "v": new_v}
