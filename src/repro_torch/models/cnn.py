"""Partitionable convolutional model families (the paper's Table II models)
in PyTorch.

Port of the JAX package's ``models/cnn.py``: each model is a chain of
*stages* (the paper's partition points) so the SwapLess planner can split
them between the accelerator worker and CPU pools.  A stage is a ``k x k``
``SAME`` convolution (stride 2 on even stages), ReLU, a 1x1 pointwise
convolution and ReLU.  Activations are NHWC and weights HWIO at a stage's
public edges, as in the reference.

The pointwise convolution over NHWC is the matrix product
``(N*H*W, C) @ (C, C)``, and the stage computes it with the hand-written
``block_matmul`` kernel (``kernels/matmul.py``).  The ``k x k`` convolution,
an XLA convolution in the reference, goes to ``F.conv2d`` in
``channels_last``.

A stage keeps its weights on the host and, when built for the GPU, a copy
on the GPU, and runs on the device its input lies on: the serving engine
moves the split between prefix and suffix without moving weights.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.kernels.matmul import matmul
from repro_torch.serving.engine import ExecutableModel


@dataclasses.dataclass(frozen=True)
class CNNSpec:
    name: str
    stage_channels: tuple[int, ...]   # output channels per stage
    in_size: int = 64                 # input spatial resolution
    in_channels: int = 3
    kernel: int = 3


def same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """XLA's ``SAME`` padding (low, high) of one spatial axis.

    The output has ``ceil(size / stride)`` positions; the total padding is
    split with the odd element on the high side, so a stride-2 3x3 conv of
    an even size pads (0, 1), not the symmetric (1, 1).
    """
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def init_cnn(
    spec: CNNSpec, generator: torch.Generator, dtype: torch.dtype = torch.float32
) -> list[dict[str, torch.Tensor]]:
    """One params dict per stage: ``conv`` (HWIO) + ``pw`` (1, 1, C, C), each
    drawn standard normal and scaled by 1/sqrt(fan-in), as the reference."""
    params = []
    c_in = spec.in_channels
    for c_out in spec.stage_channels:
        fan = spec.kernel * spec.kernel * c_in
        conv = torch.randn(
            (spec.kernel, spec.kernel, c_in, c_out), generator=generator
        ) / math.sqrt(fan)
        pw = torch.randn((1, 1, c_out, c_out), generator=generator) / math.sqrt(c_out)
        params.append({"conv": conv.to(dtype), "pw": pw.to(dtype)})
        c_in = c_out
    return params


def params_from_jax(params: Sequence[dict]) -> list[dict[str, torch.Tensor]]:
    """The reference's ``init_cnn`` output (one dict of arrays per stage,
    converted with ``np.asarray``) as torch tensors, layouts unchanged."""
    return [
        {name: torch.from_numpy(np.array(p[name], copy=True)) for name in ("conv", "pw")}
        for p in params
    ]


class Stage(torch.nn.Module):
    """One partition point: conv (stride 2 when ``downsample``), ReLU,
    pointwise conv, ReLU.  NHWC in and out."""

    def __init__(
        self, params: dict[str, torch.Tensor], downsample: bool, device: torch.device
    ):
        super().__init__()
        self.stride = 2 if downsample else 1
        self.kernel = params["conv"].shape[0]
        # HWIO -> OIHW for F.conv2d, in channels_last memory like the NHWC
        # activations; the pointwise HWIO (1, 1, C, C) is the (C_in, C_out)
        # right operand of the matrix product.
        conv = params["conv"].permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last
        )
        pw = params["pw"][0, 0].contiguous()
        self._weights = {"cpu": (conv, pw)}
        if device.type == "cuda":
            self._weights["cuda"] = (conv.to(device), pw.to(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv, pw = self._weights[x.device.type]
        n, h, w, _ = x.shape
        pad_h = same_pads(h, self.kernel, self.stride)
        pad_w = same_pads(w, self.kernel, self.stride)
        xc = F.pad(x.permute(0, 3, 1, 2), (*pad_w, *pad_h))
        xc = xc.contiguous(memory_format=torch.channels_last)
        y = F.relu(F.conv2d(xc, conv, stride=self.stride))
        y = y.permute(0, 2, 3, 1)                      # NHWC view
        ho, wo, c = y.shape[1], y.shape[2], y.shape[3]
        z = matmul(y.reshape(n * ho * wo, c).contiguous(), pw)
        return F.relu(z).reshape(n, ho, wo, c)


def pointwise_shapes(spec: CNNSpec) -> list[tuple[int, int, int]]:
    """(M, K, N) of every stage's pointwise matrix product, in stage order,
    for one input: M = H*W after the stage's conv, K = N = C."""
    size = spec.in_size
    shapes = []
    for i, c in enumerate(spec.stage_channels):
        if i % 2 == 0:
            size = -(-size // 2)
        shapes.append((size * size, c, c))
    return shapes


def build_executable(
    spec: CNNSpec,
    seed: int = 0,
    params: Sequence[dict[str, torch.Tensor]] | None = None,
    device: "str | torch.device" = "cuda",
) -> ExecutableModel:
    """The model as an ``ExecutableModel`` whose stages run on the host and,
    for ``device="cuda"``, on the GPU.  ``params`` (e.g. from
    ``params_from_jax``) replaces the weights drawn from ``seed``."""
    dev = resolve_device(device)
    if params is None:
        params = init_cnn(spec, torch.Generator().manual_seed(seed))

    def make_input(seed2: int) -> torch.Tensor:
        return torch.randn(
            (1, spec.in_size, spec.in_size, spec.in_channels),
            generator=torch.Generator().manual_seed(seed2),
        )

    stages = tuple(
        Stage(p, downsample=(i % 2 == 0), device=dev) for i, p in enumerate(params)
    )
    return ExecutableModel(name=spec.name, segments=stages, make_input=make_input)


# Reduced-scale counterparts of the paper's models (stage count == Table II
# partition points; widths grow with depth like the real families).
PAPER_CNN_SPECS: dict[str, CNNSpec] = {
    "squeezenet": CNNSpec("squeezenet", (16, 32)),
    "mobilenetv2": CNNSpec("mobilenetv2", (8, 16, 24, 32, 48)),
    "efficientnet": CNNSpec("efficientnet", (8, 16, 24, 32, 48, 64)),
    "mnasnet": CNNSpec("mnasnet", (8, 16, 16, 24, 32, 48, 64)),
    "gpunet": CNNSpec("gpunet", (16, 32, 48, 64, 96)),
    "densenet201": CNNSpec("densenet201", (16, 24, 32, 48, 64, 96, 128)),
    "resnet50v2": CNNSpec("resnet50v2", (16, 24, 32, 48, 64, 96, 128, 160)),
    "xception": CNNSpec("xception", (8, 16, 24, 32, 48, 64, 96, 128, 160, 192, 224)),
    "inceptionv4": CNNSpec("inceptionv4", (8, 16, 24, 32, 48, 64, 96, 128, 160, 192, 256)),
}
