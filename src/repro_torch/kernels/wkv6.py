"""The RWKV6 WKV recurrence through the hand-written ``wkv6`` CUDA kernel.

Port of the JAX package's ``kernels/ops.py::wkv6`` over the Pallas kernel
``kernels/wkv6.py::wkv6_chunked``, with ``wkv6_plain`` as the step-by-step
recurrence (the counterpart of ``kernels/ref.py::wkv6_ref`` and of
``models/rwkv.py::wkv_scan``).  Unlike the Pallas kernel, the CUDA kernel
starts from a given state (zero by default) and returns the final state,
which the model's prefill keeps as its decode cache.

The source holds two kernels, and ``route`` says which one a call takes, as
the C dispatch does: bfloat16 r, k, v at head_dim 64 take the chunk kernel,
which works 64 tokens at a time with its products on the tensor cores (TF32
operands split into high and low parts, float32 accumulators); every
float32 shape and bfloat16 at head_dim 8, 16 or 32 take the token kernel,
the exact recurrence one token at a time on the CUDA cores.  The routing is
fixed; neither kernel stands in for the other.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

_DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (8, 16, 32, 64)   # the kernels' instantiations
CHUNK_HEAD_DIMS = (64,)       # bfloat16 ones on the chunk kernel


@functools.cache
def _kernel():
    fn = build.load("wkv6").wkv6
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def wkv6_plain(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,
    state: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The recurrence one token at a time, in float32:
    ``out_t = r_t^T (S + diag(u) k_t v_t^T)``, ``S = diag(w_t) S + k_t v_t^T``.
    Returns (out (B, T, H, hd), final state (B, H, hd, hd))."""
    b, t_len, h, hd = r.shape
    if state is None:
        s = torch.zeros((b, h, hd, hd), dtype=torch.float32, device=r.device)
    else:
        s = state.float()
    r, k, v, w = (a.float() for a in (r, k, v, w))
    bonus = u.float()[None, :, :, None]
    outs = []
    for t in range(t_len):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]          # (B, H, hd, hd)
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, t], s + bonus * kv))
        s = w[:, t, :, :, None] * s + kv
    return torch.stack(outs, dim=1), s


def route(dtype: torch.dtype, head_dim: int) -> str:
    """Which kernel a CUDA call with r, k, v of ``dtype`` and ``head_dim``
    launches: ``"chunk"`` (tensor cores) or ``"token"`` (CUDA cores), as
    ``wkv6.cu``'s dispatch decides."""
    if dtype == torch.bfloat16 and head_dim in CHUNK_HEAD_DIMS:
        return "chunk"
    return "token"


def check_alignment(kernel_route: str, *tensors: torch.Tensor) -> None:
    """The chunk kernel copies 16-byte chunks with ``cp.async``, so it takes
    only r, k, v, w whose data starts on a 16-byte boundary (a view into
    another tensor may not); raises ``ValueError`` otherwise."""
    if kernel_route != "chunk":
        return
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(
                f"the chunk wkv6 kernel takes 16-byte-aligned r, k, v, w; "
                f"got data at {t.data_ptr():#x}"
            )


def _check(r, k, v, w, u, state) -> None:
    if r.dim() != 4 or not (r.shape == k.shape == v.shape == w.shape):
        raise ValueError(
            f"wkv6 takes r, k, v, w of one shape (B, T, H, hd), got "
            f"{tuple(r.shape)}, {tuple(k.shape)}, {tuple(v.shape)}, {tuple(w.shape)}"
        )
    b, _, h, hd = r.shape
    if tuple(u.shape) != (h, hd):
        raise ValueError(f"u must be (H, hd) = {(h, hd)}, got {tuple(u.shape)}")
    if state is not None and tuple(state.shape) != (b, h, hd, hd):
        raise ValueError(f"state must be (B, H, hd, hd) = {(b, h, hd, hd)}, got {tuple(state.shape)}")
    if not (r.dtype == k.dtype == v.dtype) or r.dtype not in _DTYPES or w.dtype not in _DTYPES:
        raise TypeError(
            f"r, k, v must share float32 or bfloat16 and w be one of them, got "
            f"{r.dtype}, {k.dtype}, {v.dtype}, {w.dtype}"
        )
    tensors = [r, k, v, w, u] + ([] if state is None else [state])
    if len({a.device for a in tensors}) != 1:
        raise ValueError(f"wkv6 operands on different devices: {[str(a.device) for a in tensors]}")
    if r.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {r.device}")


def wkv6(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,
    state: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """WKV6 over r, k, v, w (B, T, H, hd) with bonus u (H, hd), from
    ``state`` (B, H, hd, hd; zero when None).  Returns (out (B, T, H, hd)
    float32, final state (B, H, hd, hd) float32).

    On CUDA tensors (contiguous; r, k, v float32 or bfloat16; w float32 or
    bfloat16; u and state float32; hd in ``HEAD_DIMS``; r, k, v, w
    16-byte-aligned on the chunk route) this launches the kernel that
    ``route`` names on the current stream and raises if it cannot; on CPU
    tensors it computes ``wkv6_plain``.  A CUDA call that autograd would
    record (grad mode on and an input requiring grad) raises
    ``NotImplementedError``: the kernel has no backward yet.
    ``wkv6.launches`` counts the launches of either kernel.
    """
    _check(r, k, v, w, u, state)
    if r.device.type == "cpu":
        return wkv6_plain(r, k, v, w, u, state)
    if torch.is_grad_enabled() and any(a.requires_grad for a in (r, k, v, w, u, state) if a is not None):
        raise NotImplementedError(
            "the wkv6 kernel has no backward kernel yet: a gradient through it "
            "cannot be computed on the card"
        )

    b, t_len, h, hd = r.shape
    if min(b, t_len, h) < 1:
        raise ValueError(f"empty wkv6 input {tuple(r.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head_dim in {HEAD_DIMS}, got {hd}")
    if u.dtype != torch.float32 or (state is not None and state.dtype != torch.float32):
        raise TypeError("the wkv6 kernel takes u and state in float32")
    tensors = [r, k, v, w, u] + ([] if state is None else [state])
    if not all(a.is_contiguous() for a in tensors):
        raise ValueError("the wkv6 kernel takes contiguous operands")
    check_alignment(route(r.dtype, hd), r, k, v, w)
    kernel = _kernel()
    out = torch.empty(r.shape, dtype=torch.float32, device=r.device)
    final = torch.empty((b, h, hd, hd), dtype=torch.float32, device=r.device)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = kernel(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
            None if state is None else state.data_ptr(), out.data_ptr(), final.data_ptr(),
            b, t_len, h, hd, int(r.dtype == torch.bfloat16), int(w.dtype == torch.bfloat16),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"wkv6 launch failed with CUDA error {err}")
    wkv6.launches += 1
    return out, final


wkv6.launches = 0
