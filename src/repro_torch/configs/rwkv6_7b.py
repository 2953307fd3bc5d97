"""rwkv6-7b "Finch" [ssm]: attention-free, data-dependent decay.

[arXiv:2404.05892]  32L d_model=4096 (64 heads of 64) d_ff=14336
vocab=65536.  O(1) recurrent state per layer -> long_500k decode is the
natural fit.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-7b",
    arch_type="ssm",
    citation="arXiv:2404.05892",
    n_layers=32,
    d_model=4096,
    n_heads=64,             # WKV heads (head_dim 64)
    n_kv_heads=64,
    d_ff=14336,
    vocab_size=65536,
    attn_kind="none",
    block="rwkv6",
    decay_rank=64,
)
