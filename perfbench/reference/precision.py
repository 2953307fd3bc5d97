"""The arithmetic of the plain references: float32 with TF32 off, or, for
the control that a comparison has to fail, every matrix product's operands
rounded to fp8 (e4m3 forward, e5m2 for gradients, one scale a tensor) and
multiplied in float32.  Plain PyTorch; imports nothing of the program."""
from __future__ import annotations

import torch

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def plain_math() -> None:
    """float32 products in float32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def round_fp8(x: torch.Tensor, fmt=torch.float8_e4m3fn, fmax: float = E4M3_MAX) -> torch.Tensor:
    """x rounded to ``fmt`` under one scale that maps its largest magnitude
    to the format's largest value; returned in float32."""
    x = x.float()
    amax = x.abs().amax().clamp_min(1e-30)
    scale = fmax / amax
    return (x * scale).to(fmt).float() / scale


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        aq, bq = round_fp8(a), round_fp8(b)
        ctx.save_for_backward(aq, bq)
        return aq @ bq

    @staticmethod
    def backward(ctx, g):
        aq, bq = ctx.saved_tensors
        gq = round_fp8(g, torch.float8_e5m2, E5M2_MAX)
        return gq @ bq.transpose(-1, -2), aq.transpose(-1, -2) @ gq


def matmul(kind: str):
    """The product ``mm(a, b)`` of an arithmetic: ``"float32"`` or
    ``"fp8"``."""
    if kind == "float32":
        return lambda a, b: a.float() @ b.float()
    if kind == "fp8":
        return _Fp8Matmul.apply
    raise ValueError(f"unknown arithmetic {kind!r}")
