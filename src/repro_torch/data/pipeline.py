"""Synthetic token data pipeline: deterministic, host-side.

Port of the JAX package's ``data/pipeline.py``.  ``DataConfig`` and
``SyntheticTokens`` are the reference's, line for line: Zipf-distributed
token streams with local n-gram structure (so a model can actually reduce
loss on it) from NumPy's ``default_rng``, so a seed gives the reference's
arrays.  ``batches_for_arch`` hands them to the port as tensors on a
device; the vision and audio frontends' stub inputs come from
``models/frontend.py::make_train_batch``.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models.frontend import TOKEN_DTYPE, make_train_batch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    batch_size: int
    seq_len: int
    vocab_size: int
    seed: int = 0
    zipf_a: float = 1.3


class SyntheticTokens:
    """Infinite iterator of {tokens, labels} numpy batches."""

    def __init__(self, dcfg: DataConfig):
        self.cfg = dcfg
        self.rng = np.random.default_rng(dcfg.seed)
        # Second-order structure: a random bigram transition "template".
        self._shift = self.rng.integers(1, dcfg.vocab_size, size=64)

    def _sample_stream(self, n: int) -> np.ndarray:
        c = self.cfg
        z = self.rng.zipf(c.zipf_a, size=n).astype(np.int64)
        base = np.clip(z, 1, c.vocab_size - 1)
        # Half the positions continue a deterministic bigram pattern --
        # learnable structure for the loss-goes-down tests/examples.
        out = base.copy()
        mask = self.rng.random(n) < 0.5
        prev = np.roll(out, 1)
        out[mask] = (prev[mask] + self._shift[prev[mask] % 64]) % c.vocab_size
        return out.astype(np.int32)

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        c = self.cfg
        while True:
            flat = self._sample_stream(c.batch_size * (c.seq_len + 1))
            arr = flat.reshape(c.batch_size, c.seq_len + 1)
            yield {"tokens": arr[:, :-1], "labels": arr[:, 1:]}


def batches_for_arch(
    cfg: ArchConfig,
    batch_size: int,
    seq_len: int,
    seed: int = 0,
    *,
    device: "str | torch.device" = "cuda",
) -> Iterator[dict[str, torch.Tensor]]:
    """Arch-aware batches on ``device``: ``SyntheticTokens``' arrays as
    ``TOKEN_DTYPE`` tensors for text archs; for the vision and audio
    frontends ``make_train_batch`` with seeds ``seed``, ``seed + 1``, ..."""
    dev = resolve_device(device)
    if cfg.frontend == "none":
        for batch in SyntheticTokens(DataConfig(batch_size, seq_len, cfg.vocab_size, seed)):
            yield {k: torch.from_numpy(a).to(device=dev, dtype=TOKEN_DTYPE) for k, a in batch.items()}
    else:
        i = 0
        while True:
            yield make_train_batch(cfg, batch_size, seq_len, seed=seed + i, device=dev)
            i += 1
