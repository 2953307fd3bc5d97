"""Architecture config schema + input-shape suite.

Every assigned architecture is a selectable ``ArchConfig``; smoke tests use
``reduced()`` variants (2 layers, d_model <= 512, <= 4 experts) and the
dry-run exercises the full configs symbolically.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    arch_type: str                  # dense | moe | ssm | hybrid | vlm | audio
    citation: str
    n_layers: int
    d_model: int
    n_heads: int                    # 0 for attention-free blocks
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // n_heads
    qkv_bias: bool = False
    mlp: str = "swiglu"             # swiglu | gelu | relu2
    # Attention pattern.
    attn_kind: str = "full"         # full | local_global | none
    window: int = 0
    global_period: int = 0          # every Nth layer global (gemma3: 6)
    full_attn_layers: tuple[int, ...] = ()  # explicit global layers (hymba)
    # Mixture of experts.
    n_experts: int = 0
    experts_per_token: int = 0
    moe_period: int = 1             # every Nth layer is MoE (llama4: 2)
    capacity_factor: float = 1.25
    # Block family.
    block: str = "transformer"      # transformer | rwkv6 | hymba
    ssm_state: int = 0
    ssm_inner: int = 0              # hymba SSM path width
    decay_rank: int = 64            # rwkv6 decay LoRA rank
    # Modality frontend (stub; embeddings provided by input_specs).
    frontend: str = "none"          # none | vision | audio
    frontend_dim: int = 0
    n_patches: int = 0
    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    # §Perf knobs (False = paper-faithful baseline lowering).
    use_chunked_scan: bool = False  # chunked closed-form WKV/SSD recurrences
    remat_policy: str = "nothing"   # nothing | dots (save matmul outputs)
    parallelism: str = "tp"         # tp (data x tensor) | fsdp (ZeRO-3 over
                                    # ALL axes; small models where weight
                                    # all-gather << activation all-reduce)
    moe_weight_gather: bool = False # constrain expert weights replicated on
                                    # the intra-expert axis at use: AG the
                                    # (small) weight shards instead of
                                    # all-reducing the (huge) FFN outputs

    def __post_init__(self):
        if self.block == "transformer" or self.block == "hymba":
            assert self.n_heads > 0
            hd = self.head_dim or self.d_model // self.n_heads
            assert self.n_heads % self.n_kv_heads == 0
        if self.n_experts:
            assert self.experts_per_token >= 1
            assert self.n_layers % self.moe_period == 0

    # -- derived -----------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def group_size(self) -> int:
        """Scan unit: moe_period layers for MoE archs (last one MoE), else 1."""
        return self.moe_period if self.is_moe else 1

    @property
    def n_groups(self) -> int:
        return self.n_layers // self.group_size

    def layer_is_moe(self, i: int) -> bool:
        return self.is_moe and (i % self.moe_period == self.moe_period - 1)

    def layer_is_global(self, i: int) -> bool:
        """True if layer i uses full (global) attention."""
        if self.attn_kind == "full":
            return True
        if self.attn_kind == "none":
            return False
        if self.full_attn_layers:
            return i in self.full_attn_layers
        if self.global_period > 0:
            return (i + 1) % self.global_period == 0
        return False

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch decode at 500k context with bounded per-layer state?

        True for attention-free (rwkv6) and local/global archs whose *local*
        layers ring-buffer; global layers still keep full caches but are a
        small minority (their O(S) cache is the documented cost).
        """
        return self.block == "rwkv6" or self.attn_kind == "local_global"

    def supports_shape(self, shape_name: str) -> bool:
        if shape_name == "long_500k":
            return self.sub_quadratic
        return True

    # -- parameter accounting (used by roofline MODEL_FLOPS) ----------------
    def param_count(self) -> int:
        from repro_torch.models.transformer import count_params  # lazy, avoids cycle
        return count_params(self)

    def active_param_count(self) -> int:
        from repro_torch.models.transformer import count_params
        return count_params(self, active_only=True)

    # -- smoke-scale variant -------------------------------------------------
    def reduced(self) -> "ArchConfig":
        """2 layers, d_model <= 512, <= 4 experts; same family behaviour."""
        d_model = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4) if self.n_heads else 0
        n_kv = min(self.n_kv_heads, n_heads) if n_heads else 0
        if n_heads and n_heads % max(n_kv, 1) != 0:
            n_kv = 1
        group = 2 if self.is_moe else 1
        n_layers = 2 * group if self.is_moe and self.moe_period > 1 else 2
        return dataclasses.replace(
            self,
            n_layers=n_layers,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=max(n_kv, 1) if n_heads else 0,
            head_dim=d_model // n_heads if n_heads else 0,
            d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 1024),
            n_experts=min(self.n_experts, 4) if self.is_moe else 0,
            experts_per_token=min(self.experts_per_token, 2) if self.is_moe else 0,
            moe_period=2 if self.is_moe and self.moe_period > 1 else self.moe_period,
            window=min(self.window, 16) if self.window else 0,
            global_period=min(self.global_period, 2) if self.global_period else 0,
            full_attn_layers=(0,) if self.full_attn_layers else (),
            ssm_inner=min(self.ssm_inner, 256) if self.ssm_inner else 0,
            decay_rank=min(self.decay_rank, 16),
            frontend_dim=min(self.frontend_dim, 64) if self.frontend_dim else 0,
            n_patches=min(self.n_patches, 8) if self.n_patches else 0,
        )


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
