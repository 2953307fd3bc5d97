"""nemotron-4-15b [dense]: GQA + squared-ReLU MLP.

[arXiv:2402.16819]  32L d_model=6144 48H (GQA kv=8) d_ff=24576 vocab=256000.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-15b",
    arch_type="dense",
    citation="arXiv:2402.16819",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=256000,
    mlp="relu2",
    attn_kind="full",
    rope_theta=1e4,
)
