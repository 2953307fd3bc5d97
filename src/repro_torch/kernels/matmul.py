"""Matrix product through the hand-written ``block_matmul`` CUDA kernel.

Port of the JAX package's ``kernels/ops.py::matmul`` over the Pallas kernel
``kernels/block_matmul.py::block_matmul``, with ``matmul_plain`` as the
counterpart of ``kernels/ref.py::matmul_ref``.  The kernel masks ragged
edges itself, so there is no padding wrapper and no block-size argument.

The source holds two kernels, and ``route`` says which one a call takes, as
the C dispatch does: bfloat16 operands whose rows are whole 16-byte chunks
(K and N multiples of 8) and whose product is at least
``TENSOR_CORE_MIN_MNK`` multiply-adds run on the tensor cores (wgmma, fed
by TMA); every float32 call and the other bfloat16 ones run float32 FMAs on
the CUDA cores, with a tile chosen for latency (every product of the
serving path takes this route).  The routing is fixed; neither kernel
stands in for the other.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import tracing
from repro_torch.kernels import build

_DTYPES = (torch.float32, torch.bfloat16)
_INT32_MAX = 2**31 - 1
# bfloat16 products of at least this many multiply-adds (M * N * K) take the
# tensor cores: block_matmul.cu's BLOCK_MATMUL_TC_MIN_MNK.
TENSOR_CORE_MIN_MNK = 2**21


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


def route(dtype: torch.dtype, m: int, n: int, k: int) -> str:
    """Which kernel a CUDA call of ``(m, k) @ (k, n)`` in ``dtype`` launches:
    ``"tensor-core"`` or ``"cuda-core"``, as ``block_matmul.cu``'s dispatch
    decides."""
    if dtype == torch.bfloat16 and k % 8 == 0 and n % 8 == 0 and m * n * k >= TENSOR_CORE_MIN_MNK:
        return "tensor-core"
    return "cuda-core"


def check_alignment(kernel_route: str, *tensors: torch.Tensor) -> None:
    """The tensor-core kernel reads its operands with TMA, which takes only
    data that starts on a 16-byte boundary (a view into another tensor may
    not); raises ``ValueError`` otherwise."""
    if kernel_route != "tensor-core":
        return
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(
                f"the tensor-core block_matmul kernel takes 16-byte-aligned "
                f"operands; got data at {t.data_ptr():#x}"
            )


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
    tensors (row-major contiguous operands of at least one element per
    dimension; 16-byte-aligned on the tensor-core route) this launches the
    kernel that ``route`` names on the current stream and raises if it
    cannot; on CPU tensors it computes ``matmul_plain``.  A CUDA call that
    autograd would record (grad mode on and an operand requiring grad)
    raises ``NotImplementedError``: the kernel has no backward yet.
    The counter ``launches.matmul`` counts the launches of either
    kernel.  A DTensor on the card raises ``TypeError``.
    """
    build.refuse_dtensors("block_matmul", x, y)
    out_dtype = out_dtype or x.dtype
    _check(x, y, out_dtype)
    if x.device.type == "cpu":
        return matmul_plain(x, y, out_dtype)
    if torch.is_grad_enabled() and (x.requires_grad or y.requires_grad):
        raise NotImplementedError(
            "the block_matmul kernel has no backward kernel yet: a gradient "
            "through it cannot be computed on the card"
        )

    m, k = x.shape
    n = y.shape[1]
    if min(m, n, k) < 1:
        raise ValueError(f"empty operand: {tuple(x.shape)} @ {tuple(y.shape)}")
    if max(m, n, k) > _INT32_MAX:
        raise ValueError(f"operand too large for the kernel: {tuple(x.shape)} @ {tuple(y.shape)}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("matmul's kernel takes row-major contiguous operands")
    check_alignment(route(x.dtype, m, n, k), x, y)
    kernel = _kernel()
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    index = x.device.index
    stream = torch.cuda.current_stream(index).cuda_stream
    args = (
        x.data_ptr(), y.data_ptr(), out.data_ptr(), m, n, k,
        int(x.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16), stream,
    )
    # The kernel launches on the current device: switch only when the
    # operands lie on another one.
    if index == torch.cuda.current_device():
        err = kernel(*args)
    else:
        with torch.cuda.device(index):
            err = kernel(*args)
    if err != 0:
        raise RuntimeError(f"block_matmul launch failed with CUDA error {err}")
    tracing.count("launches.matmul")
    return out
