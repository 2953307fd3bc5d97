"""AdamW over the port's parameter trees.

Port of the JAX package's ``training/optimizer.py``, with its math: bias
corrections from the step count, decay added to the step's delta on the
leaves the reference decays (``decays``), moments stored in
``moments_dtype`` (float32, or bfloat16 for very large models) while the
arithmetic runs in float32.  These are torch ops on each leaf, not
``torch.optim.AdamW``, whose decay covers every tensor and is applied in
another order.  ``adamw_update`` returns new tensors, as the reference
returns new arrays, so the parameters it was given stay valid;
``adamw_update_`` writes the same values into them, as the reference's
train bundle gets by donating them.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.models.sharding_utils import _is_dtensor
from repro_torch.training.tree import leaves_with_paths, tree_map, tree_unflatten

# Elements an in-place update (``adamw_update_``) takes at a time: 256 MiB
# of each float32 temporary.
SLICE = 1 << 26


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


def _leaf_update(g, m, v, p, decay: bool, cfg: AdamWConfig, bc1, bc2, lr):
    """One leaf's (or slice's) new parameter and moments, all float32."""
    g32 = g.float()
    m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g32
    v32 = cfg.b2 * v.float() + (1 - cfg.b2) * g32.square()
    delta = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
    if decay:
        delta = delta + cfg.weight_decay * p.float()
    return p.float() - lr * delta, m32, v32


def _corrections(state, cfg: AdamWConfig, lr_scale):
    step = state["step"] + 1
    t = step.float()
    return step, 1.0 - cfg.b1**t, 1.0 - cfg.b2**t, cfg.lr * lr_scale


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
    step, bc1, bc2, lr = _corrections(state, cfg, lr_scale)

    def upd(g, m, v, path, p):
        new_p, m32, v32 = _leaf_update(g, m, v, p, decays(path, p), cfg, bc1, bc2, lr)
        return new_p.to(p.dtype), m32.to(cfg.moments_dtype), v32.to(cfg.moments_dtype)

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


def flat_slices(t: torch.Tensor) -> list[torch.Tensor]:
    """``t`` as views of at most ``SLICE`` consecutive elements (``t``
    itself if it is smaller, not contiguous or a DTensor), so that an
    elementwise pass over it in float32 holds one slice's temporaries."""
    if _is_dtensor(t) or t.numel() <= SLICE or not t.is_contiguous():
        return [t]
    return list(t.view(-1).split(SLICE))


def adamw_update_(
    grads: Any,
    state: dict[str, Any],
    params: Any,
    cfg: AdamWConfig,
    lr_scale: "torch.Tensor | float" = 1.0,
) -> tuple[Any, dict[str, Any]]:
    """``adamw_update`` written into ``params`` and ``state``'s moments,
    slice by slice (``flat_slices``); returns them with the new step
    count.  The values are ``adamw_update``'s bit for bit.  It is what the
    reference's train bundle gets by donating its parameters and state to
    the jitted step: one copy of them, and float32 temporaries of one
    slice, where a step that returns new tensors holds two copies and a
    whole leaf's temporaries."""
    step, bc1, bc2, lr = _corrections(state, cfg, lr_scale)
    for (_, g), (_, m), (_, v), (path, p) in zip(
        leaves_with_paths(grads), leaves_with_paths(state["m"]), leaves_with_paths(state["v"]),
        leaves_with_paths(params), strict=True,
    ):
        decay = decays(path, p)
        for gs, ms, vs, ps in zip(*(flat_slices(x) for x in (g, m, v, p)), strict=True):
            new_p, m32, v32 = _leaf_update(gs, ms, vs, ps, decay, cfg, bc1, bc2, lr)
            ps.copy_(new_p)
            ms.copy_(m32)
            vs.copy_(v32)
    return params, {"step": step, "m": state["m"], "v": state["v"]}
