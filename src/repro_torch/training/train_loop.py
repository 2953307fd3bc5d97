"""Training step with gradient-accumulation microbatching.

Port of the JAX package's ``training/train_loop.py``.  The global batch is
split into ``n_microbatches`` slices run one after another; their gradients
accumulate in the parameters' dtype and are divided by the count, and the
loss is the mean over slices, as the reference's ``lax.scan`` computes
them.  It is also what keeps a large batch's logits (batch x seq x vocab)
from ever being held at once.

The step takes no randomness: the model has no dropout, and the data and
the initial parameters come from their own seeded generators.  Gradients
come from ``torch.autograd.grad`` on detached copies of the parameter
leaves that require grad, so the parameters handed in are never marked and
stay usable by the serving paths.  A step made with ``donate`` writes the
new parameters and moments into the ones it was given (``adamw_update_``),
as the reference's train bundle donates them to its jitted step.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import torch

from repro_torch import tracing
from repro_torch.configs.base import ArchConfig
from repro_torch.models.sharding_utils import _is_dtensor, relayout, split_rows
from repro_torch.models.transformer import forward_loss
from repro_torch.training.optimizer import AdamWConfig, adamw_init, adamw_update, adamw_update_, flat_slices
from repro_torch.training.tree import leaves_with_paths, tree_unflatten


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: AdamWConfig = AdamWConfig()
    n_microbatches: int = 1
    remat: bool = True
    remat_policy: str = "nothing"   # nothing | dots (save the products' outputs)
    aux_weight: float = 0.01


def _split_micro(batch: dict[str, torch.Tensor], n: int) -> list[dict[str, torch.Tensor]]:
    """The batch as ``n`` consecutive slices along its leading axis, as the
    reference's reshape to (n, B / n, ...) cuts it.  A batch of DTensors
    sharded along that axis is cut shard by shard (``split_rows``), so
    that each microbatch stays sharded as the batch is."""
    sizes = {a.shape[0] for a in batch.values()}
    if len(sizes) != 1 or next(iter(sizes)) % n:
        raise ValueError(f"a batch of leading sizes {sorted(sizes)} does not split into {n} microbatches")
    parts = {k: split_rows(a, n) for k, a in batch.items()}
    return [{k: p[i] for k, p in parts.items()} for i in range(n)]


def make_train_step(
    cfg: ArchConfig, tcfg: TrainConfig, *, donate: bool = False
) -> Callable[..., tuple[Any, Any, dict[str, torch.Tensor]]]:
    """Returns ``train_step(params, opt_state, batch, lr_scale=1.0)`` ->
    (new params, new optimizer state, {"loss", "grad_norm"}).  With
    ``donate`` the new parameters and moments are the given tensors,
    updated in place; the microbatches' gradients are summed in place
    either way."""

    def grad_fn(params, mb):
        with tracing.span("train.forward"):
            flat = [p for _, p in leaves_with_paths(params)]
            live = [p.detach().requires_grad_(True) for p in flat]
            for x, p in zip(live, flat):
                if _is_dtensor(p):
                    # A DTensor's gradient can come out a pending sum over
                    # the batch axes of the whole (unsplit) parameter; it is
                    # split as its parameter is (a reduce-scatter) as soon
                    # as it is made, so no rank holds whole gradients.
                    x.register_hook(functools.partial(relayout, pl=p.placements))
            with torch.enable_grad():
                loss = forward_loss(
                    cfg, tree_unflatten(params, live), mb, remat=tcfg.remat,
                    remat_policy=tcfg.remat_policy, aux_weight=tcfg.aux_weight,
                )[0]
        with tracing.span("train.backward"):
            with torch.enable_grad():
                grads = torch.autograd.grad(loss, live, allow_unused=True)
            # A leaf the loss does not reach (the audio frontend never reads
            # ``embed``) gets a zero gradient, as jax.grad gives it.
            grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, flat)]
            # The graph and the leaves made for it are freed here, with the
            # backward.
            loss = loss.detach()
            del live
        return loss, grads

    def train_step(params, opt_state, batch, lr_scale=1.0):
        rows, seq = batch["labels"].shape[:2]
        with tracing.span("train.step", rows=rows, tokens=rows * seq):
            n = tcfg.n_microbatches
            if n > 1:
                grads, losses = None, []
                for mb in _split_micro(batch, n):
                    loss, g = grad_fn(params, mb)
                    if grads is None:
                        grads = [x.contiguous() for x in g]
                    else:
                        for a, x in zip(grads, g):
                            a.add_(x)
                    losses.append(loss)
                    del g   # this microbatch's gradients, before the next one's backward
                for a in grads:
                    a.div_(n)
                loss = sum(losses) / n
            else:
                loss, grads = grad_fn(params, batch)
            with tracing.span("train.optimizer"):
                gnorm = torch.sqrt(sum(s.float().square().sum() for g in grads for s in flat_slices(g)))
                update = adamw_update_ if donate else adamw_update
                new_params, new_opt = update(
                    tree_unflatten(params, grads), opt_state, params, tcfg.optimizer, lr_scale
                )
            return new_params, new_opt, {"loss": loss, "grad_norm": gnorm}

    return train_step


def init_train_state(cfg: ArchConfig, tcfg: TrainConfig, params: Any) -> dict[str, Any]:
    return adamw_init(params, tcfg.optimizer)
