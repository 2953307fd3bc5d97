"""gemma3-1b [dense]: 5:1 local:global sliding-window attention, 128k ctx.

[hf:google/gemma-3-1b-pt]  26L d_model=1152 4H (GQA kv=1) d_ff=6912
vocab=262144, head_dim=256, 512-token sliding window with every 6th layer
global.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-1b",
    arch_type="dense",
    citation="hf:google/gemma-3-1b-pt",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262144,
    mlp="gelu",
    attn_kind="local_global",
    window=512,
    global_period=6,
    rope_theta=1e6,
)
