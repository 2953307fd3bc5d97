"""RWKV6 ("Finch") block: attention-free time mix with data-dependent decay.

Port of the JAX package's ``models/rwkv.py``.  The WKV6 recurrence per head
(state S in R^{hd x hd}):

    out_t = r_t^T (S_t + diag(u) k_t v_t^T)
    S_{t+1} = diag(w_t) S_t + k_t v_t^T

with w_t = exp(-exp(w0 + lora(x_t))) the data-dependent decay.  A prompt
(S > 1) goes through the hand-written ``wkv6`` kernel
(``kernels/wkv6.py``), which returns the final state for the decode cache;
one decode token (S == 1) steps ``wkv_scan``.  Training differentiates the
kernel call through ``_WKV6``, whose backward is the hand-written
``wkv6_bwd`` kernel, where the reference differentiates ``wkv_scan`` with
XLA.  The reference's ``wkv_chunked`` is not ported: the kernel takes its
place.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.kernels.wkv6 import wkv6, wkv6_plain
from repro_torch.models.layers import Params, normal, rms_norm
from repro_torch.models.sharding_utils import _is_dtensor, head_placements, like, on_shards, unflatten


def rwkv_init(
    generator: torch.Generator,
    d_model: int,
    d_ff: int,
    n_heads: int,
    decay_rank: int,
    dtype: torch.dtype,
    device: torch.device,
) -> Params:
    head_dim = d_model // n_heads
    s = 1.0 / np.sqrt(d_model)

    def const(shape, value, dt=dtype):
        return torch.full(shape, value, dtype=dt, device=device)

    return {
        # time mix
        "mu": const((5, d_model), 0.5),   # r, k, v, w, g lerp coefficients
        "w0": const((n_heads, head_dim), -2.0, torch.float32),
        "w_lora_a": normal((d_model, decay_rank), s, generator, dtype, device),
        "w_lora_b": normal((decay_rank, d_model), 1.0 / np.sqrt(decay_rank), generator, dtype, device),
        "u": const((n_heads, head_dim), 0.0, torch.float32),
        "wr": normal((d_model, d_model), s, generator, dtype, device),
        "wk": normal((d_model, d_model), s, generator, dtype, device),
        "wv": normal((d_model, d_model), s, generator, dtype, device),
        "wg": normal((d_model, d_model), s, generator, dtype, device),
        "wo": normal((d_model, d_model), s, generator, dtype, device),
        "ln_x": const((d_model,), 0.0),
        # channel mix (squared ReLU, the RWKV convention)
        "mu_c": const((2, d_model), 0.5),
        "ck": normal((d_model, d_ff), s, generator, dtype, device),
        "cv": normal((d_ff, d_model), 1.0 / np.sqrt(d_ff), generator, dtype, device),
        "cr": normal((d_model, d_model), s, generator, dtype, device),
    }


def rwkv_param_count(d_model: int, d_ff: int, decay_rank: int) -> int:
    return (
        5 * d_model
        + 2 * d_model                      # w0, u
        + 2 * d_model * decay_rank
        + 5 * d_model * d_model            # wr wk wv wg wo
        + d_model                          # ln_x
        + 2 * d_model
        + d_model * d_ff * 2
        + d_model * d_model                # cr
    )


def _token_shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """shift(x)[t] = x[t-1]; position 0 sees ``prev`` (the decode carry)."""
    return torch.cat([prev[:, None, :], x[:, :-1, :]], dim=1)


def _low_rank(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``tanh(x a) b``.  On DTensors it runs on each rank's batch rows
    with ``b``'s column split kept, the output split as those: DTensor's
    own propagation may split the flattened (batch x sequence) rows of the
    narrow product over 'model', which it then cannot unflatten."""
    if not _is_dtensor(x):
        return torch.tanh(x @ a) @ b
    from torch.distributed.tensor import Replicate, Shard

    xp, bp, yp = [], [], []
    for p, q in zip(x.placements, b.placements):
        if p.is_shard(0):
            xp.append(Shard(0)), bp.append(Replicate()), yp.append(Shard(0))
        elif q.is_shard(1):
            xp.append(Replicate()), bp.append(Shard(1)), yp.append(Shard(2))
        else:
            xp.append(Replicate()), bp.append(Replicate()), yp.append(Replicate())
    rep = [Replicate()] * len(xp)
    return on_shards(lambda x, a, b: torch.tanh(x @ a) @ b, [x, a, b], [xp, rep, bp], [yp])


def _decays(xw: torch.Tensor, p: Params, n_heads: int, head_dim: int) -> torch.Tensor:
    """Data-dependent per-channel decay w_t in (0, 1), float32."""
    lora = _low_rank(xw, p["w_lora_a"], p["w_lora_b"])
    w = p["w0"][None, None] + unflatten(lora, -1, (n_heads, head_dim)).float()
    return torch.exp(-torch.exp(w))


# The recurrence one token at a time: r, k, v, w (B, S, H, hd), u (H, hd),
# state (B, H, hd, hd) -> (out float32, final state float32).
wkv_scan = wkv6_plain


def _wkv6(r, k, v, w, u, state):
    """``wkv6``; on DTensors, on each rank's shards: the batch over the
    batch axes and the heads over ``"model"`` where they divide it."""
    if not _is_dtensor(r):
        return wkv6(r, k, v, w, u, state)
    pr = head_placements(r, 0, 2, (r.shape[2],))
    pu, ps = like(pr, {2: 0}), like(pr, {0: 0, 2: 1})
    return on_shards(wkv6, [r, k, v, w, u, state], [pr, pr, pr, pr, pu, ps], [pr, ps])


def time_mix(
    x: torch.Tensor,
    p: Params,
    state: tuple[torch.Tensor, torch.Tensor],
    *,
    n_heads: int,
    eps: float,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """RWKV6 attention replacement.  x: (B, S, D).

    state = (shift_prev (B, D), wkv_state (B, H, hd, hd) float32); zeros for
    a prompt from scratch.  Returns (y, (last token of x, new wkv state)).
    """
    b, s, d = x.shape
    head_dim = d // n_heads
    shift_prev, wkv_state = state
    xs = _token_shift(x, shift_prev)
    mu = p["mu"]
    xr = x + (xs - x) * mu[0]
    xk = x + (xs - x) * mu[1]
    xv = x + (xs - x) * mu[2]
    xw = x + (xs - x) * mu[3]
    xg = x + (xs - x) * mu[4]

    r = unflatten(xr @ p["wr"], -1, (n_heads, head_dim))
    k = unflatten(xk @ p["wk"], -1, (n_heads, head_dim))
    v = unflatten(xv @ p["wv"], -1, (n_heads, head_dim))
    g = F.silu(xg @ p["wg"])
    w = _decays(xw, p, n_heads, head_dim)

    if s > 1:
        out, wkv_state = _wkv6(r, k, v, w, p["u"], wkv_state)
    else:
        out, wkv_state = wkv_scan(r, k, v, w, p["u"], wkv_state)
    out = out.reshape(b, s, d).to(x.dtype)
    out = rms_norm(out, p["ln_x"], eps) * g
    # The last token's copy, not a view that would keep all of x alive in
    # the decode cache.
    return out @ p["wo"], (x[:, -1, :].contiguous(), wkv_state)


def channel_mix(
    x: torch.Tensor, p: Params, prev: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """RWKV squared-ReLU channel mix with token shift."""
    xs = _token_shift(x, prev)
    mu = p["mu_c"]
    xk = x + (xs - x) * mu[0]
    xr = x + (xs - x) * mu[1]
    kk = F.relu(xk @ p["ck"]).square()
    return torch.sigmoid(xr @ p["cr"]) * (kk @ p["cv"]), x[:, -1, :].contiguous()


def rwkv_state_init(
    batch: int,
    d_model: int,
    n_heads: int,
    dtype: torch.dtype = torch.float32,
    device: "str | torch.device" = "cuda",
) -> dict[str, torch.Tensor]:
    device = resolve_device(device)
    head_dim = d_model // n_heads
    return {
        "tm_shift": torch.zeros((batch, d_model), dtype=dtype, device=device),
        "wkv": torch.zeros((batch, n_heads, head_dim, head_dim), dtype=torch.float32, device=device),
        "cm_shift": torch.zeros((batch, d_model), dtype=dtype, device=device),
    }
