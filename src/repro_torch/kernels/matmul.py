"""Matrix product through the hand-written ``block_matmul`` CUDA kernel.

Port of the JAX package's ``kernels/ops.py::matmul`` over the Pallas kernel
``kernels/block_matmul.py::block_matmul``, with ``matmul_plain`` as the
counterpart of ``kernels/ref.py::matmul_ref``.  The kernel masks ragged
edges itself, so there is no padding wrapper and no block-size argument.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

_DTYPES = (torch.float32, torch.bfloat16)
_INT32_MAX = 2**31 - 1
_MAX_GRID_Y = 65535 * 64   # the kernel tiles N by 64 over gridDim.y


@functools.cache
def _kernel():
    fn = build.load("block_matmul").block_matmul
    # Every pointer and the stream as c_void_p: ctypes would otherwise
    # pass a Python int as a 32-bit C int and cut the pointer.
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def matmul_plain(
    x: torch.Tensor, y: torch.Tensor, out_dtype: torch.dtype | None = None
) -> torch.Tensor:
    """(M, K) @ (K, N) of the upcast inputs in float32, cast to ``out_dtype``
    (default: ``x``'s dtype) -- the plain version of the kernel."""
    return torch.matmul(x.float(), y.float()).to(out_dtype or x.dtype)


def _check(x: torch.Tensor, y: torch.Tensor, out_dtype: torch.dtype) -> None:
    if x.dim() != 2 or y.dim() != 2:
        raise ValueError(f"matmul takes 2-D operands, got {tuple(x.shape)} @ {tuple(y.shape)}")
    if x.shape[1] != y.shape[0]:
        raise ValueError(f"inner dimensions differ: {tuple(x.shape)} @ {tuple(y.shape)}")
    if x.dtype != y.dtype or x.dtype not in _DTYPES:
        raise TypeError(f"operands must share float32 or bfloat16, got {x.dtype} and {y.dtype}")
    if out_dtype not in _DTYPES:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    if x.device != y.device:
        raise ValueError(f"operands on different devices: {x.device} and {y.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def matmul(
    x: torch.Tensor, y: torch.Tensor, out_dtype: torch.dtype | None = None
) -> torch.Tensor:
    """(M, K) @ (K, N) -> (M, N) with a float32 accumulator.

    Operands are float32 or bfloat16 (the same for both); the output is
    ``out_dtype``, float32 or bfloat16, by default ``x``'s dtype.  On CUDA
    tensors this launches the ``block_matmul`` kernel on the current stream
    (row-major contiguous operands of at least one element per dimension)
    and raises if it cannot; on CPU tensors it computes ``matmul_plain``.
    ``matmul.launches`` counts the kernel's launches.
    """
    out_dtype = out_dtype or x.dtype
    _check(x, y, out_dtype)
    if x.device.type == "cpu":
        return matmul_plain(x, y, out_dtype)

    m, k = x.shape
    n = y.shape[1]
    if min(m, n, k) < 1:
        raise ValueError(f"empty operand: {tuple(x.shape)} @ {tuple(y.shape)}")
    if max(m, k) > _INT32_MAX or n > _MAX_GRID_Y:
        raise ValueError(f"operand too large for the kernel: {tuple(x.shape)} @ {tuple(y.shape)}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("matmul's kernel takes row-major contiguous operands")
    kernel = _kernel()
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = kernel(
            x.data_ptr(), y.data_ptr(), out.data_ptr(), m, n, k,
            int(x.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"block_matmul launch failed with CUDA error {err}")
    matmul.launches += 1
    return out


matmul.launches = 0
