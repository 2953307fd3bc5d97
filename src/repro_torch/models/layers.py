"""Shared neural-net building blocks of the model zoo, as plain functions on
tensors.

Port of the JAX package's ``models/layers.py``.  Parameters are dicts of
tensors, as the reference's pytrees.  The reference's ``attention_chunked``
(the pure-jnp flash oracle) is not ported: ``kernels/flash_attention.py``
computes that function, and its plain version is ``attention_plain`` with
``causal_window_mask``.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

Params = dict[str, Any]


# --------------------------------------------------------------------------
# Normalization
# --------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMS norm in float32, scaled by ``1 + weight`` (zero-initialised)."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + weight.float())).to(x.dtype)


# --------------------------------------------------------------------------
# Rotary position embedding
# --------------------------------------------------------------------------
def rope_frequencies(
    head_dim: int, theta: float, device: "str | torch.device | None" = None
) -> torch.Tensor:
    """1 / theta^(2i / head_dim), computed in float64 and returned in float32
    on ``device``, where RoPE uses it (a host array would be copied to the
    card, and waited for, at every call)."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float64, device=device) / head_dim
    return (1.0 / theta**exponents).float()


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) or (S,).  Rotates the two halves
    of the head dimension (not interleaved pairs), in float32."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    if positions.dim() == 1:
        positions = positions[None, :]
    angles = positions[..., None].float() * freqs           # (B, S, hd/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# Attention
# --------------------------------------------------------------------------
# Finite, as in the reference: a row whose scores are all masked then gets
# uniform weights instead of NaN, and exp(m_prev - m_new) of two masked
# maxima is exp(0), not exp(-inf + inf).
NEG_INF = -1e30


def causal_window_mask(
    q_pos: torch.Tensor, kv_pos: torch.Tensor, window: int
) -> torch.Tensor:
    """(Q, K) boolean mask: causal, restricted to the last ``window``
    positions when ``window`` > 0 (0 is global attention)."""
    q = q_pos[:, None]
    k = kv_pos[None, :]
    mask = k <= q
    if window > 0:
        mask = mask & (q - k < window)
    return mask


def repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, KV, hd) -> (B, S, KV*n_rep, hd) for GQA."""
    if n_rep == 1:
        return k
    b, s, kv, hd = k.shape
    return k[:, :, :, None, :].expand(b, s, kv, n_rep, hd).reshape(b, s, kv * n_rep, hd)


def attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor,
    scale: float,
) -> torch.Tensor:
    """Reference attention.  q: (B,Sq,H,hd); k, v: (B,Sk,H,hd); mask: (Sq,Sk).

    Scores and softmax in float32; the probabilities are cast to q's dtype
    before the product with v, as in the reference."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    logits = torch.where(mask[None, None], logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


# --------------------------------------------------------------------------
# MLP variants
# --------------------------------------------------------------------------
def mlp_forward(x: torch.Tensor, p: Params, kind: str) -> torch.Tensor:
    """kind: swiglu | gelu | relu2 (Nemotron squared-ReLU).  ``gelu`` is the
    tanh approximation, which is ``jax.nn.gelu``'s default."""
    if kind == "swiglu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_in"])
        return h @ p["w_out"]
    if kind == "gelu":
        return F.gelu(x @ p["w_in"], approximate="tanh") @ p["w_out"]
    if kind == "relu2":
        return F.relu(x @ p["w_in"]).square() @ p["w_out"]
    raise ValueError(f"unknown mlp kind {kind}")


def normal(
    shape, scale: float, generator: torch.Generator, dtype: torch.dtype, device: torch.device
) -> torch.Tensor:
    """Standard normal draws on the generator's device, times ``scale`` in
    float32, as ``dtype`` on ``device``."""
    x = torch.randn(shape, generator=generator, device=generator.device)
    return (x * scale).to(device=device, dtype=dtype)


def mlp_init(
    generator: torch.Generator,
    d_model: int,
    d_ff: int,
    kind: str,
    dtype: torch.dtype,
    device: torch.device,
) -> Params:
    scale_in = 1.0 / np.sqrt(d_model)
    scale_out = 1.0 / np.sqrt(d_ff)
    p: Params = {
        "w_in": normal((d_model, d_ff), scale_in, generator, dtype, device),
        "w_out": normal((d_ff, d_model), scale_out, generator, dtype, device),
    }
    if kind == "swiglu":
        p["w_gate"] = normal((d_model, d_ff), scale_in, generator, dtype, device)
    return p


def mlp_param_count(d_model: int, d_ff: int, kind: str) -> int:
    n = 2 * d_model * d_ff
    if kind == "swiglu":
        n += d_model * d_ff
    return n
