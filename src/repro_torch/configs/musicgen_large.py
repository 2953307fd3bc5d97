"""musicgen-large [audio]: decoder-only LM over EnCodec tokens.

[arXiv:2306.05284]  48L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=2048.
The EnCodec conv codec is a stub per assignment: input_specs provides
precomputed frame embeddings; the decoder predicts codebook tokens.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large",
    arch_type="audio",
    citation="arXiv:2306.05284",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    mlp="gelu",
    attn_kind="full",
    frontend="audio",
    frontend_dim=128,       # EnCodec latent frame width
    rope_theta=1e4,
)
