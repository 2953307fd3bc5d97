"""minicpm-2b [dense]: llama-like architecture trained with the WSD
(warmup-stable-decay) schedule -- the schedule lives in repro/training.

[arXiv:2404.06395]  40L d_model=2304 36H (GQA kv=36) d_ff=5760 vocab=122753.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="minicpm-2b",
    arch_type="dense",
    citation="arXiv:2404.06395",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    d_ff=5760,
    vocab_size=122753,
    mlp="swiglu",
    attn_kind="full",
    rope_theta=1e4,
)
