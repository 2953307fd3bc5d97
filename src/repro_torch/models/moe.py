"""Mixture-of-experts FFN with GShard-style capacity-bounded top-k dispatch.

Port of the JAX package's ``models/moe.py``.  What a token gets is the
reference's, decision for decision: the router runs in float32; top-k is
taken on the softmax probabilities and the k gates are renormalised by
``max(sum, 1e-9)``; tokens are split into groups, and within a group a
token's slot at an expert is the number of earlier tokens of the group
routed there (a cumulative sum in token order); a token whose slot is at or
past the capacity ``C`` is dropped by that expert.  The experts are SwiGLU
(``silu(x W_gate) * (x W_in)``, then ``W_out``) whatever the model's dense
MLP is, as in the reference.

The dispatch is the reference's static slots, on every tensor: plain ones
on the host or the card, DTensors under a mesh, and fake ones in a counted
dry run, so that the plan counts the computation the card runs.  Every
expert takes its whole capacity of C rows a group; each group's (E, C)
slots are filled by index from the group's own tokens (the reference fills
them by the one-hot einsum ``gtd,gtec->gecd``); a slot that no kept token
took holds token 0 with weight 0, which adds nothing, as the reference's
zero row does through a SwiGLU without bias.  The experts run as batched
products over their stack (the reference's ``gecd,edf->gecf``), and the
outputs, times their gates rounded to ``x.dtype``, are summed per token in
float32 and rounded once (the reference's ``gecd,gtec->gtd``).  Every shape
is static and nothing waits on the host, so a step holding an MoE can be
captured in a CUDA graph; the price is that every expert's weights are
read at every call, a decode step's too, as the reference reads them.

On DTensors each group's slots are filled on the rank that holds the
group, so that no rank gathers another batch shard's tokens, and the
combine adds each rank's slots and settles the sum in the tokens' layout.
The dispatched tokens ``xe`` (G, E, C, D) take the reference's layout:
pinned to ``(None, "model", "data", None)`` with ``weight_gather``,
otherwise split over E as the expert stack is.  The expert products and
their memory are those of the reference's full-capacity dispatch; its
one-hot dispatch and combine products are not counted, since the slots are
gathered.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models.layers import Params, normal
from repro_torch.models.sharding_utils import (
    _is_dtensor,
    constrain,
    join_rows,
    on_shards,
    relayout,
    split_rows,
)


def moe_init(
    generator: torch.Generator,
    d_model: int,
    d_ff: int,
    n_experts: int,
    dtype: torch.dtype,
    device: "str | torch.device" = "cuda",
) -> Params:
    """Router (float32) and expert weights of the reference's shapes and
    scales.  Each expert's matrices are drawn one expert at a time, so the
    float32 draws never hold more than one expert's slice (a whole
    (128, 5120, 8192) tensor of llama4 would take 21 GB of float32)."""
    dev = resolve_device(device)
    s_in = 1.0 / np.sqrt(d_model)
    s_out = 1.0 / np.sqrt(d_ff)

    def experts(shape, scale):
        out = torch.empty((n_experts, *shape), dtype=dtype, device=dev)
        for e in range(n_experts):
            out[e] = normal(shape, scale, generator, dtype, dev)
        return out

    return {
        "router": normal((d_model, n_experts), s_in, generator, torch.float32, dev),
        "w_gate": experts((d_model, d_ff), s_in),
        "w_in": experts((d_model, d_ff), s_in),
        "w_out": experts((d_ff, d_model), s_out),
    }


def moe_param_count(d_model: int, d_ff: int, n_experts: int) -> int:
    return d_model * n_experts + n_experts * 3 * d_model * d_ff


def expert_capacity(
    n_tokens: int, n_experts: int, k: int, capacity_factor: float
) -> int:
    cap = int(np.ceil(n_tokens * k * capacity_factor / n_experts))
    return max(8, int(np.ceil(cap / 8)) * 8)  # pad for tiling friendliness


@dataclasses.dataclass
class MoEOutput:
    y: torch.Tensor
    aux_loss: torch.Tensor          # load-balance loss (Shazeer-style)
    router_entropy: torch.Tensor


def route(xg: torch.Tensor, router: torch.Tensor, k: int, C: int):
    """The dispatch decisions for token groups ``xg`` (G, gs, D).

    Returns ``(gates, assigned, keep, slot, probs)``: the renormalised gate
    of each (group, token, expert) (G, gs, E) float32, 0 where the token did
    not choose the expert; ``assigned``, 1.0 where it did; ``keep``, True
    where it did and its slot is below ``C``; ``slot``, the within-group
    position of the token at the expert (int64); and the router's softmax
    probabilities (G, gs, E)."""
    logits = xg.float() @ router
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = probs.topk(k, dim=-1)                 # (G, gs, k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    gates = torch.zeros_like(probs).scatter_(-1, gate_idx, gate_vals)
    assigned = torch.zeros_like(probs).scatter_(-1, gate_idx, 1.0)
    slot = torch.cumsum(assigned, dim=1) - assigned             # within the group
    keep = (assigned > 0) & (slot < C)
    return gates, assigned, keep, slot.long(), probs


def _group_layout(x: torch.Tensor) -> list:
    """The placements on DTensor ``x``'s mesh that keep its shards of the
    leading (group) dimension and split nothing else."""
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(0) if p.is_shard(0) else Replicate() for p in x.placements]


def _dispatch(xg, gates, keep, slot, C: int):
    """The reference's static slots, filled on each rank's own groups:
    returns (xe (G, E, C, D), w (G, E, C), tok (G, E, C)).  Slot c of
    expert e in group g holds the group's token ``tok``, with combine
    weight ``w`` (its gate rounded to ``xg.dtype``); a slot that no kept
    token took holds token 0 with weight 0.  The reference fills the same
    slots by the one-hot einsum ``gtd,gtec->gecd``; here they are gathered,
    which costs no products."""

    def fill(xg, gates, keep, slot):
        G, gs, D = xg.shape
        E = gates.shape[-1]
        at = torch.where(keep, slot, C).transpose(1, 2)            # (G, E, gs); C: dropped
        tok = torch.zeros((G, E, C + 1), dtype=torch.long, device=xg.device)
        tok = tok.scatter_(2, at, torch.arange(gs, device=xg.device).expand(G, E, gs))[..., :C]
        w = torch.zeros((G, E, C + 1), dtype=torch.float32, device=xg.device)
        w = w.scatter_(2, at, gates.transpose(1, 2))[..., :C].to(xg.dtype)
        xe = xg.gather(1, tok.reshape(G, E * C, 1).expand(G, E * C, D))
        return xe.reshape(G, E, C, D), w, tok

    if not _is_dtensor(xg):
        return fill(xg, gates, keep, slot)
    pl = _group_layout(xg)
    return on_shards(fill, [xg, gates, keep, slot], [pl] * 4, [pl] * 3)


def _combine(ye, w, tok, like):
    """``y`` (G, gs, D) of ``like``'s shape, dtype and layout: each token's
    expert outputs times their weights, summed in float32 and rounded once
    (the reference's ``gecd,gtec->gtd``).  On DTensors each rank adds the
    slots it holds: ``ye`` moves only where the groups are split and it is
    not, and a split of the experts or a pending sum over a mesh dimension
    leaves a pending sum of ``y``, which is settled in ``like``'s layout."""

    def add(ye, w, tok):
        G, E, C, D = ye.shape
        y = torch.zeros((G, like.shape[1], D), dtype=torch.float32, device=ye.device)
        idx = tok.reshape(G, E * C, 1).expand(G, E * C, D)
        return y.scatter_add_(1, idx, (ye.float() * w.float()[..., None]).reshape(G, E * C, D))

    if not _is_dtensor(ye):
        return add(ye, w, tok).to(like.dtype)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    ye_pl, w_pl, y_pl = [], [], []
    for lp, yp in zip(_group_layout(like), ye.placements):
        if lp.is_shard(0):
            ye_pl.append(lp), w_pl.append(lp), y_pl.append(lp)
        elif yp.is_shard(1):               # experts split here: each rank adds its own
            ye_pl.append(yp), w_pl.append(Shard(1)), y_pl.append(Partial())
        elif yp.is_partial():
            ye_pl.append(yp), w_pl.append(Replicate()), y_pl.append(Partial())
        else:
            ye_pl.append(Replicate()), w_pl.append(Replicate()), y_pl.append(Replicate())
    mesh = like.device_mesh
    # Against a pending sum of ye, each rank's gradient of w is a pending
    # sum too.
    w_grad = [Partial() if p.is_partial() else q for p, q in zip(ye_pl, w_pl)]
    local = add(relayout(ye, ye_pl).to_local(), relayout(w, w_pl).to_local(grad_placements=w_grad),
                relayout(tok, w_pl).to_local())
    y = DTensor.from_local(local, mesh, y_pl, run_check=False, shape=like.shape, stride=like.stride())
    return y.redistribute(mesh, like.placements).to(like.dtype)


def _moe_groups(
    xg: torch.Tensor,        # (G, gs, D) token groups
    p: Params,
    k: int,
    C: int,
    weight_gather: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Capacity-bounded dispatch within each group, into the reference's
    static (G, E, C) slots; returns (y (G, gs, D), frac_tokens (E,),
    frac_probs (E,))."""
    gates, assigned, keep, slot, probs = route(xg, p["router"], k, C)
    frac = assigned.mean((0, 1)), probs.mean((0, 1))

    w_gate, w_in, w_out = p["w_gate"], p["w_in"], p["w_out"]
    if weight_gather:
        # The reference's expert-parallel layout: expert weights keep E
        # sharded and gather the intra-expert shards at use; an expert's
        # tokens (the reference's capacity dim) shard over 'data'.
        w_gate = constrain(w_gate, "model", None, None)
        w_in = constrain(w_in, "model", None, None)
        w_out = constrain(w_out, "model", None, None)
    xe, w, tok = _dispatch(xg, gates, keep, slot, C)
    ye = _experts(_expert_layout(xe, w_gate, weight_gather), w_gate, w_in, w_out)
    if weight_gather:
        ye = constrain(ye, None, "model", "data", None)
    return _combine(ye, w, tok, xg), *frac


def _experts(xe: torch.Tensor, w_gate: torch.Tensor, w_in: torch.Tensor, w_out: torch.Tensor) -> torch.Tensor:
    """Every expert's SwiGLU over its slots, xe (G, E, C, D) -> (G, E, C,
    D), as one batched product per weight over the expert stack (the
    reference's ``gecd,edf->gecf`` einsums).

    On DTensors each rank multiplies the slots it holds, and over each
    mesh dimension: where xe splits the experts, the weights split them
    too; where xe splits the tokens (groups or slots), the weights are
    whole there (their shards gathered, never the tokens, as the
    reference's ``weight_gather`` comment asks); where xe is whole, the
    weights keep a split of d_ff (tensor parallel inside each expert) and
    the output is a pending sum.  DTensor's own choice for the products
    gathered every batch shard's tokens."""

    def ffn(xe, w_gate, w_in, w_out):
        G, E, C, D = xe.shape
        xs = xe.transpose(0, 1).reshape(E, G * C, D)
        h = F.silu(torch.bmm(xs, w_gate)) * torch.bmm(xs, w_in)
        return torch.bmm(h, w_out).reshape(E, G, C, -1).transpose(0, 1).contiguous()

    if not _is_dtensor(xe):
        return ffn(xe, w_gate, w_in, w_out)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    x_pl, x_grad, i_pl, o_pl, w_grad, y_pl = [], [], [], [], [], []
    for xp, gp, op in zip(xe.placements, w_gate.placements, w_out.placements):
        if xp.is_shard(1):                      # experts split: each rank its own
            x_pl.append(xp), x_grad.append(xp), i_pl.append(Shard(0)), o_pl.append(Shard(0))
            w_grad.append(Shard(0)), y_pl.append(xp)
        elif xp.is_shard():                     # tokens split: the weights whole here
            x_pl.append(xp), x_grad.append(xp), i_pl.append(Replicate()), o_pl.append(Replicate())
            w_grad.append(Partial()), y_pl.append(xp)
        elif gp.is_shard(2) and op.is_shard(1):   # d_ff split inside each expert
            x_pl.append(Replicate()), x_grad.append(Partial()), i_pl.append(Shard(2)), o_pl.append(Shard(1))
            w_grad.append(None), y_pl.append(Partial())
        else:
            x_pl.append(Replicate()), x_grad.append(Replicate()), i_pl.append(Replicate())
            o_pl.append(Replicate()), w_grad.append(None), y_pl.append(Replicate())

    def local(t, pl):
        grad = [g if g is not None else p for g, p in zip(w_grad, pl)]
        return relayout(t, pl).to_local(grad_placements=grad)

    out = ffn(relayout(xe, x_pl).to_local(grad_placements=x_grad),
              local(w_gate, i_pl), local(w_in, i_pl), local(w_out, o_pl))
    return DTensor.from_local(out, xe.device_mesh, y_pl, run_check=False, shape=xe.shape, stride=xe.stride())


def _expert_layout(xe: torch.Tensor, w_gate: torch.Tensor, weight_gather: bool) -> torch.Tensor:
    """The dispatched tokens ``xe`` (G, E, C, D) laid out as the reference
    lays them out: with ``weight_gather`` pinned to ``(None, "model",
    "data", None)``; otherwise E takes the expert stack's own split (llama4:
    'data'), and every other mesh dimension keeps xe's split of the
    groups.  A plain tensor is returned as it is."""
    if weight_gather:
        return constrain(xe, None, "model", "data", None)
    if not (_is_dtensor(xe) and _is_dtensor(w_gate)):
        return xe
    from torch.distributed.tensor import Shard

    pl = [Shard(1) if wp.is_shard(0) else xp for wp, xp in zip(w_gate.placements, xe.placements)]
    return relayout(xe, pl)


def moe_ffn(
    x: torch.Tensor,
    p: Params,
    *,
    k: int,
    capacity_factor: float = 1.25,
    group_size: int = 1024,
    scan_group_chunk: int = 64,
    weight_gather: bool = False,
) -> MoEOutput:
    """x: (B, S, D) -> (B, S, D) via grouped top-k capacity dispatch.

    Tokens are split into groups of ``group_size`` (halved until it divides
    B*S) with a capacity per group.  When there are more than
    ``scan_group_chunk`` groups and they divide evenly, they are processed
    that many at a time, as the reference's ``lax.map`` does, which bounds
    live memory and averages the load statistics per chunk.
    ``weight_gather`` is the reference's sharding hint for expert-parallel
    layouts (``constrain``): it acts only on DTensors under an active mesh.
    """
    B, S, D = x.shape
    E = p["router"].shape[-1]
    T = B * S
    gs = min(group_size, T)
    while T % gs:
        gs //= 2
    gs = max(gs, 1)
    G = T // gs
    C = expert_capacity(gs, E, k, capacity_factor)
    xg = x.reshape(G, gs, D)

    if G > scan_group_chunk and G % scan_group_chunk == 0:
        # On groups split over the batch axes each chunk takes its groups
        # from every rank's own (``split_rows``), so that no chunk is
        # gathered; the groups are independent, so y is the same.
        parts = [_moe_groups(xc, p, k, C, weight_gather) for xc in split_rows(xg, G // scan_group_chunk)]
        y = join_rows([part[0] for part in parts])
        frac_tokens = torch.stack([part[1] for part in parts]).mean(0)
        frac_probs = torch.stack([part[2] for part in parts]).mean(0)
    else:
        y, frac_tokens, frac_probs = _moe_groups(xg, p, k, C, weight_gather)

    aux = E * torch.sum(frac_tokens * frac_probs)
    entropy = -torch.sum(frac_probs * torch.log(frac_probs + 1e-9))
    return MoEOutput(y=y.reshape(B, S, D).to(x.dtype), aux_loss=aux, router_entropy=entropy)
