"""phi-3-vision-4.2b [vlm]: phi3-mini backbone + CLIP-style vision frontend.

[hf:microsoft/Phi-3-vision-128k-instruct]  32L d_model=3072 32H (GQA kv=32)
d_ff=8192 vocab=32064.  The ViT encoder is a stub per assignment; the
backbone consumes precomputed patch embeddings via a learned projector.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi-3-vision-4.2b",
    arch_type="vlm",
    citation="hf:microsoft/Phi-3-vision-128k-instruct",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    mlp="swiglu",
    attn_kind="full",
    frontend="vision",
    frontend_dim=1024,      # CLIP ViT-L/14 patch feature width
    n_patches=256,
    rope_theta=1e4,
)
