"""Decoder model of the model zoo: parameters, full forward, prefill and
decode.

Port of the JAX package's ``models/transformer.py`` for every registered
architecture: the dense attention families, mixture of experts
(``models/moe.py``: grok-1-314b, llama4-maverick), hymba's parallel
attention and SSM heads (``models/ssm.py``), RWKV6, and the vision and
audio frontends (``models/frontend.py``: phi-3-vision, musicgen).

The reference scans stacked layer groups for training; the port keeps one
parameter dict per layer and runs every path as a plain loop over layers.
For training, ``backbone`` recomputes each layer in the backward pass
(``torch.utils.checkpoint``) as the reference's ``jax.checkpoint`` of its
layer group does, and ``forward_loss`` is the next-token cross-entropy.
The reference's sharding constraints (``models/sharding_utils.py``) sit
where the reference has them; they act only on DTensors under an active
mesh, so the paths on plain tensors are unchanged.

* The full forward (``embed_inputs`` -> ``backbone`` -> ``unembed``),
  ``forward_loss`` and ``prefill_step`` run attention through the
  ``flash_attention`` kernel and the RWKV time mix through the ``wkv6``
  kernel.  A gradient of either runs its hand-written backward kernel
  (``flash_attention_bwd``, ``wkv6_bwd``).
* ``decode_step`` keeps per-layer caches: full-attention layers a KV cache
  of ``max_len`` slots, sliding-window layers a ring buffer of ``window``
  slots, RWKV layers their O(1) recurrent state, hymba layers the SSM
  state besides their KV cache.  It updates the KV caches in place and
  returns them.
* The vision frontend prepends the projected patch embeddings to the text
  tokens, so prefill positions run over patches and text; the audio
  frontend projects frame embeddings, in prefill and in decode.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch import tracing
from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (
    Params,
    mlp_forward,
    mlp_init,
    mlp_param_count,
    normal,
    rms_norm,
)
from repro_torch.models.sharding_utils import (
    _is_dtensor,
    constrain,
    relayout,
    vocab_parallel_embedding,
    vocab_parallel_nll,
)

DEFAULT_DTYPE = torch.bfloat16


# ==========================================================================
# Parameters
# ==========================================================================
def _layer_init(cfg: ArchConfig, layer_idx: int, generator, dtype, device) -> Params:
    zeros = lambda: torch.zeros((cfg.d_model,), dtype=dtype, device=device)  # noqa: E731
    if cfg.block == "rwkv6":
        return {
            "ln1": zeros(),
            "rwkv": rwkv_mod.rwkv_init(
                generator, cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.decay_rank, dtype, device
            ),
            "ln2": zeros(),
        }
    p: Params = {
        "ln1": zeros(),
        "ln2": zeros(),
        "attn": attn_mod.attn_init(
            generator, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim, cfg.qkv_bias, dtype, device,
        ),
    }
    if cfg.block == "hymba":
        p["ssm"] = ssm_mod.ssm_init(generator, cfg.d_model, cfg.ssm_inner, cfg.ssm_state, dtype, device)
    if cfg.layer_is_moe(layer_idx):
        p["moe"] = moe_mod.moe_init(generator, cfg.d_model, cfg.d_ff, cfg.n_experts, dtype, device)
    else:
        p["mlp"] = mlp_init(generator, cfg.d_model, cfg.d_ff, cfg.mlp, dtype, device)
    return p


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
    scale by ``1 + weight``); RWKV's ``w0`` and ``u``, the MoE router and
    the SSM's ``A_log`` and ``D`` stay float32."""
    dev = resolve_device(device)
    scale = 1.0 / np.sqrt(cfg.d_model)
    params: Params = {
        "embed": normal((cfg.vocab_size, cfg.d_model), scale, generator, dtype, dev),
        "final_norm": torch.zeros((cfg.d_model,), dtype=dtype, device=dev),
        "lm_head": normal((cfg.d_model, cfg.vocab_size), scale, generator, dtype, dev),
    }
    if cfg.frontend != "none":
        params["frontend_proj"] = normal((cfg.frontend_dim, cfg.d_model), scale, generator, dtype, dev)
    params["layers"] = [_layer_init(cfg, i, generator, dtype, dev) for i in range(cfg.n_layers)]
    return params


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

    def layer(tree, g):
        if isinstance(tree, dict):
            return {name: layer(sub, g) for name, sub in tree.items()}
        return _tensor(np.asarray(tree)[g])

    out = {name: _tensor(params[name]) for name in ("embed", "final_norm", "lm_head")}
    if cfg.frontend != "none":
        out["frontend_proj"] = _tensor(params["frontend_proj"])
    out["layers"] = []
    for i in range(cfg.n_layers):
        g, j = divmod(i, cfg.group_size)
        out["layers"].append(layer(params["groups"][j], g))
    return out


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


def _batch_token(cfg: ArchConfig) -> str:
    return "batch_full" if cfg.parallelism == "fsdp" else "batch"


def _attn_kw(cfg: ArchConfig) -> dict:
    return dict(
        n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.resolved_head_dim,
        rope_theta=cfg.rope_theta,
    )


def _ffn(cfg: ArchConfig, p: Params, x2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The layer's MoE or dense MLP on the normed x2; returns (y, the MoE's
    load-balance loss or None)."""
    if "moe" in p:
        with tracing.span("moe"):
            out = moe_mod.moe_ffn(
                x2, p["moe"], k=cfg.experts_per_token,
                capacity_factor=cfg.capacity_factor,
                weight_gather=cfg.moe_weight_gather,
            )
        return out.y, out.aux_loss
    with tracing.span("mlp"):
        return mlp_forward(x2, p["mlp"], cfg.mlp), None


def _transformer_layer(
    cfg: ArchConfig, p: Params, h: torch.Tensor, window: int, positions: torch.Tensor, index: int
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Pre-norm residual block over a whole sequence, from a zero state;
    returns (h, the MoE's load-balance loss or None).  ``index`` is the
    layer's, for its span."""
    with tracing.span("layer", index=index):
        x = rms_norm(h, p["ln1"], cfg.norm_eps)
        if cfg.block == "rwkv6":
            y, _ = rwkv_mod.time_mix(
                x, p["rwkv"], _zero_rwkv_state(cfg, h), n_heads=cfg.n_heads, eps=cfg.norm_eps
            )
            h = h + y
            x2 = rms_norm(h, p["ln2"], cfg.norm_eps)
            y2, _ = rwkv_mod.channel_mix(x2, p["rwkv"], torch.zeros_like(h[:, 0]))
            return h + y2, None
        y = attn_mod.attn_forward(x, p["attn"], window=window, positions=positions, **_attn_kw(cfg))
        if cfg.block == "hymba":
            # Attention and SSM heads run in parallel on the same normed input;
            # their outputs are averaged (arXiv:2411.13676 Sec. 2).
            y_ssm, _ = ssm_mod.ssm_forward(x, p["ssm"], chunked=cfg.use_chunked_scan)
            y = 0.5 * (y + y_ssm)
        h = h + y
        y2, aux = _ffn(cfg, p, rms_norm(h, p["ln2"], cfg.norm_eps))
        return constrain(h + y2, _batch_token(cfg), None, None), aux


# Products whose outputs the "dots" policy keeps for the backward pass, as
# jax.checkpoint_policies.dots_saveable keeps dot_general's.
_DOT_OPS = frozenset({
    torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
    torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default,
})


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOT_OPS else CheckpointPolicy.PREFER_RECOMPUTE


def backbone(
    cfg: ArchConfig,
    params: Params,
    h: torch.Tensor,
    positions: torch.Tensor | None = None,
    *,
    remat: bool = True,
    remat_policy: str = "nothing",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Run every layer over h (B, S, D); returns (hidden states, the MoE
    layers' summed load-balance loss, a float32 scalar).

    With ``remat`` each layer keeps only its input for the backward pass
    and runs again there (``torch.utils.checkpoint``, non-reentrant), as
    the reference's ``jax.checkpoint`` does per layer group: with
    ``remat_policy="nothing"`` it saves nothing else, with ``"dots"`` the
    matrix products' outputs.  The forward's values are the same either
    way.
    """
    if remat_policy not in ("nothing", "dots"):
        raise ValueError(f"unknown remat_policy {remat_policy!r}")
    if positions is None:
        positions = torch.arange(h.shape[1], device=h.device)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    kw = {}
    if remat_policy == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _save_dots)
    for i, (p, window) in enumerate(zip(params["layers"], layer_window_values(cfg))):
        if remat:
            h, a = checkpoint(_transformer_layer, cfg, p, h, window, positions, i, use_reentrant=False, **kw)
        else:
            h, a = _transformer_layer(cfg, p, h, window, positions, i)
        if a is not None:
            aux = aux + a
    return h, aux


def _project(embeds: torch.Tensor, proj: torch.Tensor) -> torch.Tensor:
    """Frontend embeddings through ``frontend_proj``, in the projector's
    dtype (the reference's bf16 @ f32 promotes to f32 the same way)."""
    return embeds.to(proj.dtype) @ proj


def embed_inputs(
    cfg: ArchConfig, params: Params, batch: dict[str, torch.Tensor]
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Returns (h (B, S, D), loss mask or None).

    * text archs: ``batch["tokens"]`` (B, S).
    * vision: the projected ``batch["patch_embeds"]`` (B, P, frontend_dim)
      are prepended to the token embeddings; the mask is 0 on the patches
      and 1 on the text.
    * audio: ``batch["frame_embeds"]`` (B, S, frontend_dim) projected to
      d_model.
    """
    with tracing.span("embed"):
        if cfg.frontend == "vision":
            tok = vocab_parallel_embedding(params["embed"], batch["tokens"])
            patches = _project(batch["patch_embeds"], params["frontend_proj"]).to(tok.dtype)
            b, n_p, s_text = patches.shape[0], patches.shape[1], tok.shape[1]
            mask = torch.cat([
                torch.zeros((b, n_p), dtype=torch.float32, device=tok.device),
                torch.ones((b, s_text), dtype=torch.float32, device=tok.device),
            ], dim=1)
            return constrain(torch.cat([patches, tok], dim=1), _batch_token(cfg), None, None), mask
        if cfg.frontend == "audio":
            h = _project(batch["frame_embeds"], params["frontend_proj"])
            return constrain(h, _batch_token(cfg), None, None), None
        h = vocab_parallel_embedding(params["embed"], batch["tokens"])
        return constrain(h, _batch_token(cfg), None, None), None


def unembed(cfg: ArchConfig, params: Params, h: torch.Tensor) -> torch.Tensor:
    with tracing.span("head"):
        h = rms_norm(h, params["final_norm"], cfg.norm_eps)
        logits = h @ params["lm_head"]
        if cfg.parallelism == "fsdp":
            return constrain(logits, "batch_full", None, None)
        return constrain(logits, "batch", None, "model")


def forward_loss(
    cfg: ArchConfig,
    params: Params,
    batch: dict[str, torch.Tensor],
    *,
    remat: bool = True,
    remat_policy: str = "nothing",
    aux_weight: float = 0.01,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Next-token cross-entropy of one microbatch plus ``aux_weight`` times
    the MoE load-balance loss; returns (loss, {"ce", "aux"}), float32
    scalars.  ``batch`` is ``embed_inputs``' batch with ``labels`` (B, S)
    (the text positions for the vision frontend, whose patch positions get
    label 0 and are masked out of the mean)."""
    h, loss_mask = embed_inputs(cfg, params, batch)
    h, aux = backbone(cfg, params, h, remat=remat, remat_policy=remat_policy)
    logits = unembed(cfg, params, h).float()                # (B, S, V)
    labels = batch["labels"].long()
    if cfg.frontend == "vision":
        labels = torch.cat([labels.new_zeros((labels.shape[0], cfg.n_patches)), labels], dim=1)
    # Logits split over the vocabulary stay split (each rank reduces its
    # shard); any other logits take the whole row.
    nll = vocab_parallel_nll(logits, labels)
    if nll is None:
        logp = torch.log_softmax(logits, dim=-1)
        # -logp at each label; nll_loss's backward writes into a gradient of
        # logp's own layout, where gather's would make a new one (on
        # DTensors a replicated one of the global shape).
        b, s, v = logp.shape
        nll = F.nll_loss(logp.reshape(b * s, v), labels.reshape(b * s), reduction="none").reshape(b, s)
    if loss_mask is not None:
        nll = nll * loss_mask
        denom = loss_mask.sum().clamp_min(1.0)
    else:
        denom = nll.numel()
    ce = nll.sum() / denom
    return ce + aux_weight * aux, {"ce": ce, "aux": aux}


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
    dev = resolve_device(device)
    caches = []
    hd = cfg.resolved_head_dim
    for i in range(cfg.n_layers):
        if cfg.block == "rwkv6":
            caches.append(rwkv_mod.rwkv_state_init(batch, cfg.d_model, cfg.n_heads, dtype, dev))
            continue
        size = max_len if cfg.layer_is_global(i) else min(cfg.window, max_len)
        shape = (batch, size, cfg.n_kv_heads, hd)
        cache = {
            "k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev),
        }
        if cfg.block == "hymba":
            cache["ssm"] = ssm_mod.ssm_state_init(batch, cfg.ssm_inner, cfg.ssm_state, dev)
            cache["ssm_prev"] = torch.zeros((batch, cfg.d_model), dtype=dtype, device=dev)
        caches.append(cache)
    return caches


def decode_step(
    cfg: ArchConfig,
    params: Params,
    caches: list[dict[str, torch.Tensor]],
    tokens: torch.Tensor,     # (B, 1) integer, or (B, 1, frontend_dim) for audio
    cur_len: int,             # positions already cached
) -> tuple[torch.Tensor, list[dict[str, torch.Tensor]]]:
    """One-token serve step: returns (logits (B, 1, V), caches), the KV
    caches updated in place."""
    if cfg.frontend == "audio":
        h = _project(tokens, params["frontend_proj"])
    else:
        h = vocab_parallel_embedding(params["embed"], tokens)
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

        if cfg.layer_is_global(i):
            y, k_c, v_c = attn_mod.attn_decode_step(
                x, p["attn"], cache["k"], cache["v"], cur_len, window=0, **_attn_kw(cfg)
            )
        else:
            y, k_c, v_c = attn_mod.attn_decode_step_ring(
                x, p["attn"], cache["k"], cache["v"], cur_len, **_attn_kw(cfg)
            )
        new_cache = {"k": k_c, "v": v_c}
        if cfg.block == "hymba":
            y_ssm, new_cache["ssm"] = ssm_mod.ssm_forward(x, p["ssm"], cache["ssm"])
            new_cache["ssm_prev"] = cache["ssm_prev"]
            y = 0.5 * (y + y_ssm)
        h = h + y
        y2, _ = _ffn(cfg, p, rms_norm(h, p["ln2"], cfg.norm_eps))
        h = constrain(h + y2, _batch_token(cfg), None, None)
        new_caches.append(new_cache)
    return unembed(cfg, params, h), new_caches


def _seed_cache(cfg: ArchConfig, kv: torch.Tensor, size: int, dtype: torch.dtype) -> torch.Tensor:
    """A cache of ``size`` slots (B, size, KV, hd) holding the prompt's
    keys or values ``kv`` (B, S, KV, hd) as decode expects them: position t
    in slot t of a full cache, in slot ``t % size`` of a ring buffer that
    keeps the last ``size`` positions; empty slots zero.

    On a mesh (a DTensor ``kv``) the cache takes the reference's cache
    layout (``launch.sharding.cache_shardings``: the batch over the batch
    axes, the sequence over 'model' where it divides), and the prompt moves
    into it by one redistribution: no rank holds a whole-sequence cache."""
    b, s = kv.shape[:2]
    if not _is_dtensor(kv):
        cache = kv.new_zeros((b, size, *kv.shape[2:]), dtype=dtype)
        if s <= size:
            cache[:, :s] = kv
        else:
            slots = torch.arange(s - size, s, device=kv.device) % size
            cache[:, slots] = kv[:, s - size:]
        return cache
    from repro_torch.launch import sharding as shd

    if s < size:
        kv = F.pad(kv, (0, 0, 0, 0, 0, size - s))
    elif s > size:
        kv = torch.roll(kv[:, s - size:], (s - size) % size, dims=1)
    mesh = kv.device_mesh
    spec = shd.cache_specs(cfg, mesh, {"k": kv})["k"]
    return relayout(kv.to(dtype), shd.placements(spec, mesh))


def prefill_step(
    cfg: ArchConfig,
    params: Params,
    batch: dict[str, torch.Tensor],
    max_len: int,
) -> tuple[torch.Tensor, list[dict[str, torch.Tensor]]]:
    """Process a whole prompt (``batch`` as ``embed_inputs`` takes it, S
    positions in all); returns (logits of the last position (B, 1, V),
    decode caches).

    Full-attention layers cache the prompt in the first S of ``max_len``
    slots; sliding-window layers seed their ring buffer of W slots with the
    last W positions so that slot ``t % W`` holds position t, as decode
    expects; RWKV layers keep the recurrent state after the prompt, hymba
    layers the SSM state and the last normed input (``ssm_prev``).
    """
    inputs = batch["frame_embeds"] if cfg.frontend == "audio" else batch["tokens"]
    with tracing.span("prefill", batch=inputs.shape[0], tokens=inputs.shape[0] * inputs.shape[1]):
        h, _ = embed_inputs(cfg, params, batch)
        s = h.shape[1]
        if s > max_len:
            raise ValueError(f"prompt of {s} positions exceeds max_len {max_len}")
        positions = torch.arange(s, device=h.device)
        caches = []
        for i, p in enumerate(params["layers"]):
            with tracing.span("layer", index=i):
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
                    x, p["attn"], window=0 if is_global else cfg.window, positions=positions,
                    return_kv=True, **_attn_kw(cfg),
                )
                size = max_len if is_global else min(cfg.window, max_len)
                with tracing.span("cache"):
                    cache = {"k": _seed_cache(cfg, k_kv, size, h.dtype), "v": _seed_cache(cfg, v_kv, size, h.dtype)}
                if cfg.block == "hymba":
                    y_ssm, cache["ssm"] = ssm_mod.ssm_forward(x, p["ssm"], chunked=cfg.use_chunked_scan)
                    cache["ssm_prev"] = x[:, -1, :].clone()      # not a view that holds all of x
                    y = 0.5 * (y + y_ssm)
                h = h + y
                y2, _ = _ffn(cfg, p, rms_norm(h, p["ln2"], cfg.norm_eps))
                h = constrain(h + y2, _batch_token(cfg), None, None)
                caches.append(cache)
        return unembed(cfg, params, h[:, -1:, :]), caches


# ==========================================================================
# Parameter accounting
# ==========================================================================
def count_params(cfg: ArchConfig, active_only: bool = False) -> int:
    """Parameters of the model; ``active_only`` counts the router and the
    ``experts_per_token`` experts a token runs through on MoE layers."""
    total = cfg.vocab_size * cfg.d_model * 2           # embed + lm_head
    total += cfg.d_model                               # final norm
    if cfg.frontend != "none":
        total += cfg.frontend_dim * cfg.d_model
    for i in range(cfg.n_layers):
        total += 2 * cfg.d_model                       # ln1, ln2
        if cfg.block == "rwkv6":
            total += rwkv_mod.rwkv_param_count(cfg.d_model, cfg.d_ff, cfg.decay_rank)
            continue
        total += attn_mod.attn_param_count(
            cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, cfg.qkv_bias
        )
        if cfg.block == "hymba":
            total += ssm_mod.ssm_param_count(cfg.d_model, cfg.ssm_inner, cfg.ssm_state)
        if cfg.layer_is_moe(i):
            if active_only:
                total += cfg.d_model * cfg.n_experts
                total += cfg.experts_per_token * 3 * cfg.d_model * cfg.d_ff
            else:
                total += moe_mod.moe_param_count(cfg.d_model, cfg.d_ff, cfg.n_experts)
        else:
            total += mlp_param_count(cfg.d_model, cfg.d_ff, cfg.mlp)
    return total
