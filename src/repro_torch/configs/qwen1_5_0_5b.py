"""qwen1.5-0.5b [dense]: QKV bias.

[hf:Qwen/Qwen1.5-0.5B]  24L d_model=1024 16H (GQA kv=16) d_ff=2816
vocab=151936.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-0.5b",
    arch_type="dense",
    citation="hf:Qwen/Qwen1.5-0.5B",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=2816,
    vocab_size=151936,
    qkv_bias=True,
    mlp="swiglu",
    attn_kind="full",
    rope_theta=1e6,
)
