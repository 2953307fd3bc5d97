"""Learning-rate schedules: MiniCPM's WSD (warmup-stable-decay,
arXiv:2404.06395) and cosine.

Port of the JAX package's ``training/schedule.py``.  The arithmetic runs on
float32 tensors, as the reference's does on float32 arrays; a Python step
gives a Python float, a tensor step a float32 tensor on its device.
"""
from __future__ import annotations

import math

import torch


def _result(step, value: torch.Tensor):
    return value if isinstance(step, torch.Tensor) else float(value)


def wsd_schedule(
    step,
    *,
    total_steps: int,
    warmup_frac: float = 0.01,
    decay_frac: float = 0.1,
    final_scale: float = 0.1,
):
    """MiniCPM WSD: linear warmup -> flat -> sharp exponential-style decay.

    Returns a multiplicative scale in (0, 1]."""
    t = torch.as_tensor(step, dtype=torch.float32)
    warm = max(int(total_steps * warmup_frac), 1)
    decay_start = int(total_steps * (1.0 - decay_frac))
    warm_scale = t / warm
    decay_t = (t - decay_start) / max(total_steps - decay_start, 1)
    decay_scale = torch.pow(torch.tensor(final_scale, dtype=torch.float32, device=t.device), decay_t.clamp(0.0, 1.0))
    value = torch.where(t < warm, warm_scale, torch.where(t < decay_start, torch.ones_like(t), decay_scale))
    return _result(step, value)


def cosine_schedule(step, *, total_steps: int, warmup_frac: float = 0.01, final_scale: float = 0.1):
    t = torch.as_tensor(step, dtype=torch.float32)
    warm = max(int(total_steps * warmup_frac), 1)
    prog = ((t - warm) / max(total_steps - warm, 1)).clamp(0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    value = torch.where(t < warm, t / warm, final_scale + (1.0 - final_scale) * cos)
    return _result(step, value)
