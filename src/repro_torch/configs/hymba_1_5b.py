"""hymba-1.5b [hybrid]: parallel attention + SSM heads in every layer.

[arXiv:2411.13676]  32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001,
ssm_state=16.  Sliding-window attention everywhere except three full-
attention layers (first, middle, last), mirroring the Hymba recipe -- this
plus the O(1) SSM state makes long_500k decode feasible.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b",
    arch_type="hybrid",
    citation="arXiv:2411.13676",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    mlp="swiglu",
    attn_kind="local_global",
    window=1024,
    full_attn_layers=(0, 16, 31),
    block="hymba",
    ssm_state=16,
    ssm_inner=3200,         # 2x d_model Mamba-style expansion
    rope_theta=1e4,
)
