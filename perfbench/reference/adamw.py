"""Plain AdamW for the train step's reference, in float32: bias-corrected
moments, and the decoupled weight decay added to the step on the leaves
that the configuration's rule names.  Each new parameter is stored as the
configuration stores its parameters (``store``: rounded to bfloat16 for a
model served in bfloat16), its arithmetic in float32.  Plain PyTorch;
imports nothing of the program."""
from __future__ import annotations

import torch


def decayed(path: str, t: torch.Tensor, rule: str) -> bool:
    """Whether a leaf takes weight decay.  ``layer_leaves_and_matrices``:
    every per-layer leaf (``layers.<i>.…``, norm weights and vectors too, as
    a model that stacks its layers along a leading axis decays every leaf of
    two or more dimensions) and the matrices outside the layers."""
    if rule == "layer_leaves_and_matrices":
        return path.startswith("layers.") or t.dim() >= 2
    raise ValueError(f"unknown decay rule {rule!r}")


class AdamW:
    def __init__(self, named: list[tuple[str, torch.Tensor]], opt: dict, store: dict[str, torch.dtype]):
        """``store`` maps each leaf's path to the type it is stored in."""
        self.opt, self.t, self.store = opt, 0, store
        self.named = named
        self.m = [torch.zeros_like(p) for _, p in named]
        self.v = [torch.zeros_like(p) for _, p in named]

    @torch.no_grad()
    def step(self, grads: list[torch.Tensor]) -> None:
        o = self.opt
        self.t += 1
        bc1, bc2 = 1 - o["b1"] ** self.t, 1 - o["b2"] ** self.t
        for (path, p), g, m, v in zip(self.named, grads, self.m, self.v, strict=True):
            m.mul_(o["b1"]).add_(g, alpha=1 - o["b1"])
            v.mul_(o["b2"]).add_(g.square(), alpha=1 - o["b2"])
            delta = (m / bc1) / ((v / bc2).sqrt() + o["eps"])
            if decayed(path, p, o["decay"]):
                delta += o["weight_decay"] * p
            p.copy_((p - o["lr"] * delta).to(self.store[path]).float())
