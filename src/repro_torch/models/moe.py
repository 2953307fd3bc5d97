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

The reference dispatches with dense one-hot einsums over a (G, gs, E, C)
tensor, which suits the TPU's matrix unit.  Here the dispatch is by index:
the kept (token, expert) pairs are gathered expert by expert, each expert
runs its FFN on its own tokens only, and the outputs, times their gates
rounded to ``x.dtype`` (the reference's ``combine``), are summed per token
in float32 with ``index_add_`` and rounded once, as the reference's einsum
accumulates in float32.  Experts that no token reached cost nothing, so a
decode step reads only the weights of the experts its tokens chose.

On fake tensors (a counted dry run) there are no decisions to read: each
expert then takes its whole capacity of ``G * C`` rows, the reference's
static slots, and the experts run as batched products over their stack,
so that the expert products and their memory are those of the reference's
full-capacity dispatch.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models.layers import Params, normal
from repro_torch.models.sharding_utils import constrain, is_fake, lifter, match, replica, whole_dim0


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


def _moe_groups(
    xg: torch.Tensor,        # (G, gs, D) token groups
    p: Params,
    k: int,
    C: int,
    weight_gather: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Capacity-bounded dispatch within each group; returns (y (G, gs, D),
    frac_tokens (E,), frac_probs (E,))."""
    G, gs, D = xg.shape
    E = p["router"].shape[-1]
    gates, assigned, keep, _, probs = route(xg, p["router"], k, C)

    w_gate, w_in, w_out = p["w_gate"], p["w_in"], p["w_out"]
    if weight_gather:
        # The reference's expert-parallel layout: expert weights keep E
        # sharded and gather the intra-expert shards at use; an expert's
        # tokens (the reference's capacity dim) shard over 'data'.
        w_gate = constrain(w_gate, "model", None, None)
        w_in = constrain(w_in, "model", None, None)
        w_out = constrain(w_out, "model", None, None)
    # Tokens and gates are gathered whole before they are indexed by token
    # (a no-op without a mesh): DTensor would otherwise leave each gather
    # pending as a masked partial sum, which it cannot hold for several
    # experts at once.
    xf = constrain(xg.reshape(G * gs, D), None, None)
    gates = constrain(gates.reshape(G * gs, E), None, None)
    y = torch.zeros_like(xf, dtype=torch.float32)
    if is_fake(keep):
        # Fake tensors (a counted dry run) hold no decisions: every expert
        # takes its whole capacity, G * C rows, and the experts run as one
        # batched product each, as the reference's static (G, E, C) slots
        # and einsums do (an expert stack sharded by expert stays so).
        lift = lifter(keep)
        rows = lift(torch.zeros(E * G * C, dtype=torch.long, device=keep.device))
        experts = lift(torch.arange(E, device=keep.device).repeat_interleave(G * C))
        combine = gates[rows, experts].to(xg.dtype).float()
        xe = xf[rows].reshape(E, G * C, D)
        h = F.silu(torch.bmm(xe, w_gate)) * torch.bmm(xe, w_in)
        ye = torch.bmm(h, w_out).reshape(E * G * C, D)
        y.index_add_(0, rows, match(ye.float() * combine[:, None], y))
        return y.to(xg.dtype).reshape(G, gs, D), assigned.mean((0, 1)), probs.mean((0, 1))

    # The kept pairs' count depends on the data, which DTensor cannot
    # propagate: the pairs are found on keep's full value, then lifted back.
    keep, lift = replica(keep)
    rows, experts = keep.reshape(G * gs, E).nonzero(as_tuple=True)   # token-major
    order = torch.argsort(experts, stable=True)
    rows, experts = rows[order], experts[order]
    counts = torch.bincount(experts, minlength=E).tolist()
    rows, experts = lift(rows), lift(experts)
    combine = gates[rows, experts].to(xg.dtype).float()
    # An expert stack sharded by expert is gathered once, whole in E, its
    # other shards kept: picking expert e out of the shards would gather
    # the stack again for every expert.
    w_gate, w_in, w_out = (whole_dim0(w) for w in (w_gate, w_in, w_out))
    start = 0
    for e, n in enumerate(counts):
        if n == 0:
            continue
        idx = rows[start : start + n]
        xe = xf[idx]
        if weight_gather:
            xe = constrain(xe, "data", None)
        h = F.silu(xe @ w_gate[e]) * (xe @ w_in[e])
        ye = h @ w_out[e]
        if weight_gather:
            ye = constrain(ye, "data", None)
        y.index_add_(0, idx, match(ye.float() * combine[start : start + n, None], y))
        start += n
    return y.to(xg.dtype).reshape(G, gs, D), assigned.mean((0, 1)), probs.mean((0, 1))


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
        parts = [_moe_groups(xc, p, k, C, weight_gather) for xc in xg.split(scan_group_chunk)]
        y = torch.cat([part[0] for part in parts])
        frac_tokens = torch.stack([part[1] for part in parts]).mean(0)
        frac_probs = torch.stack([part[2] for part in parts]).mean(0)
    else:
        y, frac_tokens, frac_probs = _moe_groups(xg, p, k, C, weight_gather)

    aux = E * torch.sum(frac_tokens * frac_probs)
    entropy = -torch.sum(frac_probs * torch.log(frac_probs + 1e-9))
    return MoEOutput(y=y.reshape(B, S, D).to(x.dtype), aux_loss=aux, router_entropy=entropy)
