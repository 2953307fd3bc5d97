"""The yardstick's counts of model FLOPs and of the attention kernel's
operations and bytes.

Model FLOPs of a forward pass are 2 x the weights that multiply x the
tokens they multiply, plus attention: 4 x head_dim x query heads x the
(query, key) pairs that each layer's causal or window mask keeps (QK^T and
PV, a multiply and an add each).  Embedding lookups, norms and elementwise
work (the SSM's state update among them) are not counted.  The output
head counts only on the positions it is applied to.  A configuration's
reference family (``reference/<family>.py``) states what there is to
count: its weights that multiply (``matmul_weights``) and its attention
calls (``attention_calls``); the rules are here.
"""
from __future__ import annotations

from harness import spec


def causal_pairs(s: int, window: int = 0) -> int:
    """(query, key) pairs of an S-token causal mask, restricted to the last
    ``window`` keys of each query when ``window`` > 0."""
    if window <= 0 or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def attention_flops(heads: int, head_dim: int, s: int, window: int) -> int:
    """FLOPs of one attention call's two products over the kept pairs."""
    return 4 * head_dim * heads * causal_pairs(s, window)


def forward_flops(conf: dict, s: int, head_positions: int) -> int:
    """Model FLOPs of one forward pass of ``conf``'s model over one
    sequence of ``s`` tokens whose output head runs on ``head_positions``."""
    fam = spec.reference(conf["reference"])
    body, head = fam.matmul_weights(conf["model"])
    attn = sum(attention_flops(h, hd, s, w) for h, _, hd, w in fam.attention_calls(conf["model"]))
    return 2 * body * s + 2 * head * head_positions + attn


def prefill_flops(conf: dict, s: int) -> int:
    """A prefill of ``s`` tokens: the head on the last position only."""
    return forward_flops(conf, s, 1)


def train_flops(conf: dict, s: int) -> int:
    """A train step's model FLOPs on one sequence: 3 x the forward (the
    backward is two products for each of the forward's), the head on every
    position; remat's second forward is not counted."""
    return 3 * forward_flops(conf, s, s)


def flash_call(heads: int, kv_heads: int, head_dim: int, s: int, window: int,
               elem_bytes: int = 2) -> tuple[int, int]:
    """(FLOPs, bytes) of one ``flash_attention`` forward call on one
    sequence: the pairs the mask keeps; q, k and v read once, o written
    once."""
    nbytes = elem_bytes * s * head_dim * (2 * heads + 2 * kv_heads)
    return attention_flops(heads, head_dim, s, window), nbytes


def flash_calls(conf: dict, s: int) -> list[tuple[int, int]]:
    """(FLOPs, bytes) of each ``flash_attention`` call of a forward pass of
    ``conf``'s model over ``s`` tokens."""
    fam = spec.reference(conf["reference"])
    return [flash_call(h, kv, hd, s, w) for h, kv, hd, w in fam.attention_calls(conf["model"])]
