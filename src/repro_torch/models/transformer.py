"""Decoder model of the model zoo: parameters, full forward, prefill and
decode.

Port of the JAX package's ``models/transformer.py`` for the dense attention
families (``block="transformer"`` without experts: qwen1.5-0.5b, gemma3-1b,
minicpm-2b, nemotron-4-15b) and RWKV6 (``block="rwkv6"``).  Mixture of
experts, hymba's SSM heads and the vision and audio frontends are not ported
yet (ROADMAP A9): every entry point raises ``NotImplementedError`` for them.

The reference scans stacked layer groups for training; the port keeps one
parameter dict per layer and runs every path as a plain loop over layers
(scan and remat are training concerns).  The reference's sharding
constraints have no meaning on one card and are left out.

* The full forward (``embed_inputs`` -> ``backbone`` -> ``unembed``) and
  ``prefill_step`` run attention through the ``flash_attention`` kernel and
  the RWKV time mix through the ``wkv6`` kernel.
* ``decode_step`` keeps per-layer caches: full-attention layers a KV cache
  of ``max_len`` slots, sliding-window layers a ring buffer of ``window``
  slots, RWKV layers their O(1) recurrent state.  It updates the caches in
  place and returns them.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models.layers import (
    Params,
    mlp_forward,
    mlp_init,
    mlp_param_count,
    normal,
    rms_norm,
)

DEFAULT_DTYPE = torch.bfloat16


def _check_supported(cfg: ArchConfig) -> None:
    if cfg.is_moe:
        family = "mixture of experts"
    elif cfg.block == "hymba":
        family = "hymba (parallel SSM heads)"
    elif cfg.frontend != "none":
        family = f"the {cfg.frontend} frontend"
    elif cfg.block not in ("transformer", "rwkv6"):
        family = f"block {cfg.block!r}"
    else:
        return
    raise NotImplementedError(
        f"{cfg.name}: {family} is not ported to repro_torch yet (ROADMAP A9)"
    )


# ==========================================================================
# Parameters
# ==========================================================================
def _layer_init(cfg: ArchConfig, generator, dtype, device) -> Params:
    zeros = lambda: torch.zeros((cfg.d_model,), dtype=dtype, device=device)  # noqa: E731
    if cfg.block == "rwkv6":
        return {
            "ln1": zeros(),
            "rwkv": rwkv_mod.rwkv_init(
                generator, cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.decay_rank, dtype, device
            ),
            "ln2": zeros(),
        }
    return {
        "ln1": zeros(),
        "ln2": zeros(),
        "attn": attn_mod.attn_init(
            generator, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim, cfg.qkv_bias, dtype, device,
        ),
        "mlp": mlp_init(generator, cfg.d_model, cfg.d_ff, cfg.mlp, dtype, device),
    }


def init_params(
    cfg: ArchConfig,
    generator: torch.Generator,
    *,
    device: "str | torch.device" = "cuda",
    dtype: torch.dtype = DEFAULT_DTYPE,
) -> Params:
    """Random parameters of the reference's shapes and scales, drawn from
    ``generator`` on its own device (a CUDA generator draws on the card) and
    stored as ``dtype`` on ``device``.  Norm weights are zero (the norms
    scale by ``1 + weight``); RWKV's ``w0`` and ``u`` stay float32."""
    _check_supported(cfg)
    dev = resolve_device(device)
    scale = 1.0 / np.sqrt(cfg.d_model)
    return {
        "embed": normal((cfg.vocab_size, cfg.d_model), scale, generator, dtype, dev),
        "final_norm": torch.zeros((cfg.d_model,), dtype=dtype, device=dev),
        "lm_head": normal((cfg.d_model, cfg.vocab_size), scale, generator, dtype, dev),
        "layers": [_layer_init(cfg, generator, dtype, dev) for _ in range(cfg.n_layers)],
    }


def _tensor(a) -> torch.Tensor:
    """One leaf of the reference's parameters (a JAX or numpy array) as a
    CPU tensor of the same dtype.  bfloat16 goes through float32, since
    ``torch.from_numpy`` does not take numpy's bfloat16."""
    a = np.asarray(a)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    if a.dtype.name not in dtypes:
        raise TypeError(f"parameter of dtype {a.dtype} has no torch counterpart here")
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dtypes[a.dtype.name])


def params_from_jax(cfg: ArchConfig, params: dict) -> Params:
    """The reference's ``init_params`` output as the port's parameters, on
    the host, each leaf in its own dtype.  The reference stacks each
    position of a layer group along a leading ``n_groups`` axis
    (``params["groups"][j][name][g]`` is layer ``g * group_size + j``, as
    its ``_layer_params_at`` reads it); the port keeps one dict per layer."""
    _check_supported(cfg)

    def layer(tree, g):
        if isinstance(tree, dict):
            return {name: layer(sub, g) for name, sub in tree.items()}
        return _tensor(np.asarray(tree)[g])

    layers = []
    for i in range(cfg.n_layers):
        g, j = divmod(i, cfg.group_size)
        layers.append(layer(params["groups"][j], g))
    return {
        "embed": _tensor(params["embed"]),
        "final_norm": _tensor(params["final_norm"]),
        "lm_head": _tensor(params["lm_head"]),
        "layers": layers,
    }


def layer_window_values(cfg: ArchConfig) -> list[int]:
    """Each layer's attention window (0 = global/full attention)."""
    return [
        0 if cfg.attn_kind == "none" or cfg.layer_is_global(i) else cfg.window
        for i in range(cfg.n_layers)
    ]


# ==========================================================================
# Full forward
# ==========================================================================
def _zero_rwkv_state(cfg: ArchConfig, h: torch.Tensor):
    b = h.shape[0]
    hd = cfg.resolved_head_dim
    return (
        torch.zeros((b, cfg.d_model), dtype=h.dtype, device=h.device),
        torch.zeros((b, cfg.n_heads, hd, hd), dtype=torch.float32, device=h.device),
    )


def _transformer_layer(
    cfg: ArchConfig, p: Params, h: torch.Tensor, window: int, positions: torch.Tensor
) -> torch.Tensor:
    """Pre-norm residual block over a whole sequence, from a zero state."""
    x = rms_norm(h, p["ln1"], cfg.norm_eps)
    if cfg.block == "rwkv6":
        y, _ = rwkv_mod.time_mix(
            x, p["rwkv"], _zero_rwkv_state(cfg, h), n_heads=cfg.n_heads, eps=cfg.norm_eps
        )
        h = h + y
        x2 = rms_norm(h, p["ln2"], cfg.norm_eps)
        y2, _ = rwkv_mod.channel_mix(x2, p["rwkv"], torch.zeros_like(h[:, 0]))
        return h + y2
    y = attn_mod.attn_forward(
        x,
        p["attn"],
        n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.resolved_head_dim,
        rope_theta=cfg.rope_theta,
        window=window,
        positions=positions,
    )
    h = h + y
    x2 = rms_norm(h, p["ln2"], cfg.norm_eps)
    return h + mlp_forward(x2, p["mlp"], cfg.mlp)


def backbone(
    cfg: ArchConfig, params: Params, h: torch.Tensor, positions: torch.Tensor | None = None
) -> torch.Tensor:
    """Run every layer over h (B, S, D); returns the hidden states."""
    _check_supported(cfg)
    if positions is None:
        positions = torch.arange(h.shape[1], device=h.device)
    for p, window in zip(params["layers"], layer_window_values(cfg)):
        h = _transformer_layer(cfg, p, h, window, positions)
    return h


def embed_inputs(cfg: ArchConfig, params: Params, batch: dict[str, torch.Tensor]) -> torch.Tensor:
    """Token embeddings (B, S, D) of ``batch["tokens"]`` (B, S).  Text only:
    the reference's frontends are not ported (ROADMAP A9)."""
    _check_supported(cfg)
    return params["embed"][batch["tokens"]]


def unembed(cfg: ArchConfig, params: Params, h: torch.Tensor) -> torch.Tensor:
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return h @ params["lm_head"]


# ==========================================================================
# Serving: prefill and decode
# ==========================================================================
def init_decode_caches(
    cfg: ArchConfig,
    batch: int,
    max_len: int,
    dtype: torch.dtype = DEFAULT_DTYPE,
    device: "str | torch.device" = "cuda",
) -> list[dict[str, torch.Tensor]]:
    """Empty per-layer caches sized by each layer's kind."""
    _check_supported(cfg)
    dev = resolve_device(device)
    caches = []
    hd = cfg.resolved_head_dim
    for i in range(cfg.n_layers):
        if cfg.block == "rwkv6":
            caches.append(rwkv_mod.rwkv_state_init(batch, cfg.d_model, cfg.n_heads, dtype, dev))
            continue
        size = max_len if cfg.layer_is_global(i) else min(cfg.window, max_len)
        shape = (batch, size, cfg.n_kv_heads, hd)
        caches.append({
            "k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev),
        })
    return caches


def decode_step(
    cfg: ArchConfig,
    params: Params,
    caches: list[dict[str, torch.Tensor]],
    tokens: torch.Tensor,     # (B, 1) integer
    cur_len: int,             # tokens already cached
) -> tuple[torch.Tensor, list[dict[str, torch.Tensor]]]:
    """One-token serve step: returns (logits (B, 1, V), caches), the caches
    updated in place."""
    _check_supported(cfg)
    h = params["embed"][tokens]
    new_caches = []
    for i, (p, cache) in enumerate(zip(params["layers"], caches)):
        x = rms_norm(h, p["ln1"], cfg.norm_eps)
        if cfg.block == "rwkv6":
            y, (tm_shift, wkv) = rwkv_mod.time_mix(
                x, p["rwkv"], (cache["tm_shift"], cache["wkv"]),
                n_heads=cfg.n_heads, eps=cfg.norm_eps,
            )
            h = h + y
            x2 = rms_norm(h, p["ln2"], cfg.norm_eps)
            y2, cm_shift = rwkv_mod.channel_mix(x2, p["rwkv"], cache["cm_shift"])
            h = h + y2
            new_caches.append({"tm_shift": tm_shift, "wkv": wkv, "cm_shift": cm_shift})
            continue

        kw = dict(
            n_heads=cfg.n_heads,
            n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.resolved_head_dim,
            rope_theta=cfg.rope_theta,
        )
        if cfg.layer_is_global(i):
            y, k_c, v_c = attn_mod.attn_decode_step(
                x, p["attn"], cache["k"], cache["v"], cur_len, window=0, **kw
            )
        else:
            y, k_c, v_c = attn_mod.attn_decode_step_ring(
                x, p["attn"], cache["k"], cache["v"], cur_len, **kw
            )
        h = h + y
        x2 = rms_norm(h, p["ln2"], cfg.norm_eps)
        h = h + mlp_forward(x2, p["mlp"], cfg.mlp)
        new_caches.append({"k": k_c, "v": v_c})
    return unembed(cfg, params, h), new_caches


def prefill_step(
    cfg: ArchConfig,
    params: Params,
    batch: dict[str, torch.Tensor],
    max_len: int,
) -> tuple[torch.Tensor, list[dict[str, torch.Tensor]]]:
    """Process a whole prompt ``batch["tokens"]`` (B, S); returns (logits of
    the last token (B, 1, V), decode caches).

    Full-attention layers cache the prompt in the first S of ``max_len``
    slots; sliding-window layers seed their ring buffer of W slots with the
    last W tokens so that slot ``t % W`` holds token t, as decode expects;
    RWKV layers keep the recurrent state after the prompt.
    """
    h = embed_inputs(cfg, params, batch)
    b, s, _ = h.shape
    if s > max_len:
        raise ValueError(f"prompt of {s} tokens exceeds max_len {max_len}")
    positions = torch.arange(s, device=h.device)
    hd = cfg.resolved_head_dim
    caches = []
    for i, p in enumerate(params["layers"]):
        x = rms_norm(h, p["ln1"], cfg.norm_eps)
        if cfg.block == "rwkv6":
            y, (tm_shift, wkv) = rwkv_mod.time_mix(
                x, p["rwkv"], _zero_rwkv_state(cfg, h), n_heads=cfg.n_heads, eps=cfg.norm_eps
            )
            h = h + y
            x2 = rms_norm(h, p["ln2"], cfg.norm_eps)
            y2, cm_shift = rwkv_mod.channel_mix(x2, p["rwkv"], torch.zeros_like(h[:, 0]))
            h = h + y2
            caches.append({"tm_shift": tm_shift, "wkv": wkv, "cm_shift": cm_shift})
            continue

        is_global = cfg.layer_is_global(i)
        y, k_kv, v_kv = attn_mod.attn_forward(
            x,
            p["attn"],
            n_heads=cfg.n_heads,
            n_kv_heads=cfg.n_kv_heads,
            head_dim=hd,
            rope_theta=cfg.rope_theta,
            window=0 if is_global else cfg.window,
            positions=positions,
            return_kv=True,
        )
        size = max_len if is_global else min(cfg.window, max_len)
        k_c = torch.zeros((b, size, cfg.n_kv_heads, hd), dtype=h.dtype, device=h.device)
        v_c = torch.zeros_like(k_c)
        if is_global or s <= size:
            k_c[:, :s] = k_kv
            v_c[:, :s] = v_kv
        else:
            slots = torch.arange(s - size, s, device=h.device) % size
            k_c[:, slots] = k_kv[:, s - size:]
            v_c[:, slots] = v_kv[:, s - size:]
        h = h + y
        x2 = rms_norm(h, p["ln2"], cfg.norm_eps)
        h = h + mlp_forward(x2, p["mlp"], cfg.mlp)
        caches.append({"k": k_c, "v": v_c})
    return unembed(cfg, params, h[:, -1:, :]), caches


# ==========================================================================
# Parameter accounting
# ==========================================================================
def count_params(cfg: ArchConfig, active_only: bool = False) -> int:
    """Parameters of the model (every one is active in the ported families)."""
    _check_supported(cfg)
    total = cfg.vocab_size * cfg.d_model * 2           # embed + lm_head
    total += cfg.d_model                               # final norm
    for _ in range(cfg.n_layers):
        total += 2 * cfg.d_model                       # ln1, ln2
        if cfg.block == "rwkv6":
            total += rwkv_mod.rwkv_param_count(cfg.d_model, cfg.d_ff, cfg.decay_rank)
            continue
        total += attn_mod.attn_param_count(
            cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, cfg.qkv_bias
        )
        total += mlp_param_count(cfg.d_model, cfg.d_ff, cfg.mlp)
    return total
