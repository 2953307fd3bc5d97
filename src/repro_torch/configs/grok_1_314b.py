"""grok-1-314b [moe]: 8 experts, top-2 routing, every layer MoE.

[hf:xai-org/grok-1]  64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="grok-1-314b",
    arch_type="moe",
    citation="hf:xai-org/grok-1",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab_size=131072,
    mlp="gelu",
    attn_kind="full",
    n_experts=8,
    experts_per_token=2,
    moe_period=1,
    rope_theta=1e4,
)
