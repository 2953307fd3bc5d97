"""llama4-maverick-400b-a17b [moe]: interleaved MoE + chunked local attention.

[hf:meta-llama/Llama-4-Scout-17B-16E family]  48L d_model=5120 40H (GQA kv=8)
d_ff=8192 vocab=202048, MoE 128 experts top-1, early fusion.  MoE layers
interleave with dense layers (moe_period=2, matching Maverick's
interleave_moe_layer_step); attention follows the iRoPE pattern of 3 chunked
local layers (8192-token chunks) per global layer, which is what makes
long_500k decode feasible for this arch.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
    arch_type="moe",
    citation="hf:meta-llama/Llama-4-Scout-17B-16E",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    mlp="swiglu",
    attn_kind="local_global",
    window=8192,
    global_period=4,
    n_experts=128,
    experts_per_token=1,
    moe_period=2,
    rope_theta=5e5,
)
