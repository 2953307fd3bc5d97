"""Modality-frontend stubs, input specs and random batches for every arch x shape.

Port of the JAX package's ``models/frontend.py``.  As in the reference, the
vision encoder (ViT/SigLIP) and the audio codec (EnCodec) are not
implemented: a batch carries precomputed patch or frame embeddings of the
right shape, and the learned projector that maps them into d_model
(``frontend_proj``) lives in the transformer's parameters.

The specs are ``torch.empty(..., device="meta")`` tensors, the counterpart
of ``jax.ShapeDtypeStruct``: shape and dtype, no storage.  Token ids and
labels are ``int64`` (torch's index type) where the reference has
``int32``; embeddings are ``EMBED_DTYPE`` (bfloat16) on both sides.  The
concrete batches draw from an explicit ``torch.Generator`` seeded with
``seed`` on ``device``, so their values are not the reference's threefry
draws: tests feed the same numpy-seeded inputs to both packages instead.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device

EMBED_DTYPE = torch.bfloat16
TOKEN_DTYPE = torch.int64


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_input_specs(cfg: ArchConfig, batch: int, seq_len: int) -> dict[str, torch.Tensor]:
    """Meta-tensor stand-ins for a train/prefill step (no allocation)."""
    if cfg.frontend == "vision":
        s_text = seq_len - cfg.n_patches
        return {
            "tokens": _spec((batch, s_text), TOKEN_DTYPE),
            "patch_embeds": _spec((batch, cfg.n_patches, cfg.frontend_dim), EMBED_DTYPE),
            "labels": _spec((batch, s_text), TOKEN_DTYPE),
        }
    if cfg.frontend == "audio":
        return {
            "frame_embeds": _spec((batch, seq_len, cfg.frontend_dim), EMBED_DTYPE),
            "labels": _spec((batch, seq_len), TOKEN_DTYPE),
        }
    return {
        "tokens": _spec((batch, seq_len), TOKEN_DTYPE),
        "labels": _spec((batch, seq_len), TOKEN_DTYPE),
    }


def decode_token_specs(cfg: ArchConfig, batch: int) -> torch.Tensor:
    if cfg.frontend == "audio":
        return _spec((batch, 1, cfg.frontend_dim), EMBED_DTYPE)
    return _spec((batch, 1), TOKEN_DTYPE)


def _draws(cfg: ArchConfig, spec: torch.Tensor, g: torch.Generator, dev: torch.device) -> torch.Tensor:
    if spec.dtype == EMBED_DTYPE:
        return torch.randn(spec.shape, generator=g, device=dev).to(EMBED_DTYPE)
    return torch.randint(0, cfg.vocab_size, spec.shape, generator=g, device=dev, dtype=spec.dtype)


def make_train_batch(
    cfg: ArchConfig,
    batch: int,
    seq_len: int,
    seed: int = 0,
    *,
    device: "str | torch.device" = "cuda",
) -> dict[str, torch.Tensor]:
    """A random batch of ``train_input_specs``' shapes and dtypes on
    ``device``: token ids uniform over the vocabulary, embeddings standard
    normal."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    return {name: _draws(cfg, spec, g, dev) for name, spec in train_input_specs(cfg, batch, seq_len).items()}


def make_decode_token(
    cfg: ArchConfig, batch: int, seed: int = 0, *, device: "str | torch.device" = "cuda"
) -> torch.Tensor:
    """One random decode input of ``decode_token_specs``' shape: a frame
    embedding for the audio frontend, else a token id."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    return _draws(cfg, decode_token_specs(cfg, batch), g, dev)
