"""GQA attention block: projections, RoPE, masked attention and KV caches.

Port of the JAX package's ``models/attention.py``.  The full-sequence path
(training, prefill) goes through the hand-written ``flash_attention`` kernel
(``kernels/flash_attention.py``) at every sequence length: the reference
switches between ``attention_plain`` and ``attention_chunked`` at
``CHUNKED_SEQ_THRESHOLD``, and both compute that function.  Decode attends
one query against the cache with plain einsums, as the reference does.

Decode writes the new key and value into the cache tensors in place (the
reference returns updated copies); the caches it returns are the ones it
was given.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.kernels.flash_attention import causal_attention
from repro_torch.models.layers import NEG_INF, Params, apply_rope, normal
from repro_torch.models.sharding_utils import (
    _is_dtensor,
    even,
    head_placements,
    on_shards,
    unflatten,
    write_position,
)


def attn_init(
    generator: torch.Generator,
    d_model: int,
    n_heads: int,
    n_kv_heads: int,
    head_dim: int,
    qkv_bias: bool,
    dtype: torch.dtype,
    device: torch.device,
) -> Params:
    s = 1.0 / np.sqrt(d_model)
    so = 1.0 / np.sqrt(n_heads * head_dim)
    p: Params = {
        "wq": normal((d_model, n_heads * head_dim), s, generator, dtype, device),
        "wk": normal((d_model, n_kv_heads * head_dim), s, generator, dtype, device),
        "wv": normal((d_model, n_kv_heads * head_dim), s, generator, dtype, device),
        "wo": normal((n_heads * head_dim, d_model), so, generator, dtype, device),
    }
    if qkv_bias:
        p["bq"] = torch.zeros((n_heads * head_dim,), dtype=dtype, device=device)
        p["bk"] = torch.zeros((n_kv_heads * head_dim,), dtype=dtype, device=device)
        p["bv"] = torch.zeros((n_kv_heads * head_dim,), dtype=dtype, device=device)
    return p


def attn_param_count(
    d_model: int, n_heads: int, n_kv_heads: int, head_dim: int, qkv_bias: bool
) -> int:
    n = d_model * head_dim * (2 * n_heads + 2 * n_kv_heads)
    if qkv_bias:
        n += head_dim * (n_heads + 2 * n_kv_heads)
    return n


def _project_qkv(x, p, n_heads, n_kv_heads, head_dim):
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    return (
        unflatten(q, -1, (n_heads, head_dim)),
        unflatten(k, -1, (n_kv_heads, head_dim)),
        unflatten(v, -1, (n_kv_heads, head_dim)),
    )


def attn_forward(
    x: torch.Tensor,
    p: Params,
    *,
    n_heads: int,
    n_kv_heads: int,
    head_dim: int,
    rope_theta: float,
    window: int,
    positions: torch.Tensor | None = None,
    return_kv: bool = False,
):
    """Full-sequence (training / prefill) attention.  x: (B, S, D).

    ``positions`` (default ``0 .. S-1``) rotate q and k; the causal and
    window masks follow the sequence order, which is the same mask for any
    positions that rise by one per token.  ``return_kv=True`` also returns
    the post-RoPE (k, v) in (B, S, KV, hd) for the KV cache.
    """
    with tracing.span("attention"):
        s = x.shape[1]
        if positions is None:
            positions = torch.arange(s, device=x.device)
        q, k_kv, v_kv = _project_qkv(x, p, n_heads, n_kv_heads, head_dim)
        q = apply_rope(q, positions, rope_theta)
        k_kv = apply_rope(k_kv, positions, rope_theta)
        scale = 1.0 / np.sqrt(head_dim)
        out = _attention(q, k_kv, v_kv, scale, window) @ p["wo"]
        if return_kv:
            return out, k_kv, v_kv
        return out


def _attention(q, k, v, scale: float, window: int) -> torch.Tensor:
    """``causal_attention`` with its heads flattened, (B, S, H * hd); on
    DTensors, on each rank's shards: the batch over the batch axes and the
    heads over ``"model"`` where both head counts divide it, as the
    reference's specs lay them out.  The heads are flattened on the shards,
    so that the gradient is split back into heads there too (DTensor cannot
    split a dimension sharded over more ranks than it has heads)."""

    def attend(q, k, v):
        b, s, h, hd = q.shape
        return causal_attention(q, k, v, scale=scale, window=window).reshape(b, s, h * hd)

    if not _is_dtensor(q):
        return attend(q, k, v)
    pq = head_placements(q, 0, 2, (q.shape[2], k.shape[2]))
    return on_shards(attend, [q, k, v], [pq, pq, pq], [pq])


def _gqa_cache_attention(
    q: torch.Tensor,          # (B, 1, H, hd)
    k_cache: torch.Tensor,    # (B, S, KV, hd)
    v_cache: torch.Tensor,    # (B, S, KV, hd)
    mask: torch.Tensor,       # (S,) bool
    scale: float,
) -> torch.Tensor:
    """One query per sequence against its cache, with query heads grouped
    over their KV head instead of repeating the cache.  Scores, softmax and
    the weighted sum in float32; the probabilities are rounded to the
    cache's dtype first, as in the reference."""
    b, _, h, hd = q.shape
    kv = k_cache.shape[2]
    g = h // kv
    qg = unflatten(q, 2, (kv, g))
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k_cache.float()) * scale
    s = s.masked_fill(~mask, NEG_INF)                     # (B, KV, G, 1, S)
    m = s.amax(dim=-1, keepdim=True)
    p_ = torch.exp(s - m)
    denom = p_.sum(dim=-1, keepdim=True)
    out = torch.einsum(
        "bkgqs,bskd->bqkgd", p_.to(v_cache.dtype).float(), v_cache.float()
    ) / denom.reshape(b, 1, kv, g, 1)
    return even(out, (2, 3)).reshape(b, 1, h, hd).to(q.dtype)


def attn_decode_step(
    x: torch.Tensor,
    p: Params,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    cur_len: int,
    *,
    n_heads: int,
    n_kv_heads: int,
    head_dim: int,
    rope_theta: float,
    window: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode with a full KV cache.

    x: (B, 1, D); k_cache, v_cache: (B, S_max, KV, hd); ``cur_len`` tokens
    are already cached.  Writes slot ``cur_len`` in place and returns (out,
    k_cache, v_cache).
    """
    b = x.shape[0]
    s_max = k_cache.shape[1]
    if not 0 <= cur_len < s_max:
        raise ValueError(f"cache of {s_max} slots cannot take position {cur_len}")
    pos = torch.full((b, 1), cur_len, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(x, p, n_heads, n_kv_heads, head_dim)
    q = apply_rope(q, pos, rope_theta)
    k_new = apply_rope(k_new, pos, rope_theta)
    write_position(k_cache, cur_len, k_new[:, 0])
    write_position(v_cache, cur_len, v_new[:, 0])

    kv_pos = torch.arange(s_max, device=x.device)
    mask = kv_pos <= cur_len
    if window > 0:
        mask &= cur_len - kv_pos < window
    out = _gqa_cache_attention(q, k_cache, v_cache, mask, 1.0 / np.sqrt(head_dim))
    return out.reshape(b, 1, n_heads * head_dim) @ p["wo"], k_cache, v_cache


def attn_decode_step_ring(
    x: torch.Tensor,
    p: Params,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    cur_len: int,
    *,
    n_heads: int,
    n_kv_heads: int,
    head_dim: int,
    rope_theta: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode against a ring-buffered sliding-window cache of the
    last ``W`` tokens (W = cache size): slot ``cur_len % W`` is overwritten
    in place.  Keys carry RoPE of their absolute positions, so attention
    needs only an occupancy mask."""
    b = x.shape[0]
    w = k_cache.shape[1]
    pos = torch.full((b, 1), cur_len, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(x, p, n_heads, n_kv_heads, head_dim)
    q = apply_rope(q, pos, rope_theta)
    k_new = apply_rope(k_new, pos, rope_theta)
    slot = cur_len % w
    write_position(k_cache, slot, k_new[:, 0])
    write_position(v_cache, slot, v_new[:, 0])

    occupied = torch.arange(w, device=x.device) <= cur_len
    out = _gqa_cache_attention(q, k_cache, v_cache, occupied, 1.0 / np.sqrt(head_dim))
    return out.reshape(b, 1, n_heads * head_dim) @ p["wo"], k_cache, v_cache
