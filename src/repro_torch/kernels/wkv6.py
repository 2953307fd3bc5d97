"""The RWKV6 WKV recurrence through the hand-written ``wkv6`` CUDA kernel.

Port of the JAX package's ``kernels/ops.py::wkv6`` over the Pallas kernel
``kernels/wkv6.py::wkv6_chunked``, with ``wkv6_plain`` as the step-by-step
recurrence (the counterpart of ``kernels/ref.py::wkv6_ref`` and of
``models/rwkv.py::wkv_scan``).  Unlike the Pallas kernel, the CUDA kernel
starts from a given state (zero by default) and returns the final state,
which the model's prefill keeps as its decode cache.

The source holds two kernels, and ``route`` says which one a call takes, as
the C dispatch does: head_dim 64, with r, k, v float32 or bfloat16, takes
the chunk kernel, which works 64 tokens at a time with its products on the
tensor cores (TF32 operands split into high and low parts, float32
accumulators; bfloat16 v, exact in TF32, is not split); head_dim 8, 16 or
32 takes the token kernel, the exact recurrence one token at a time on the
CUDA cores.  The routing is fixed; neither kernel stands in for the other.

The gradient is a kernel too: when autograd records a CUDA call, ``wkv6``
is the entry of the autograd function ``_WKV6``, whose forward is the
kernel above and whose backward launches the hand-written ``wkv6_bwd``
kernels (``csrc/wkv6_bwd.cu``, for every type and head_dim): each chunk of
``BWD_CHUNK`` tokens is summed on the tensor cores, a scan over the chunks
writes checkpoints of the state and of its gradient, and each chunk's dr,
dk, dv come from its two checkpoints as tensor-core products, with dw (the
row sums of G_t * S_{t-1}) taken from the same products term by term.
``wkv6_bwd_plain`` is their plain version.  The JAX package differentiates ``models/rwkv.py::wkv_scan``
with XLA instead; it has no backward kernel.  On CPU tensors ``wkv6``
computes ``wkv6_plain``, which autograd differentiates.

On fake tensors (a counted fake run of a step, ``roofline.counter``) the
forward and the backward take their fake forms, through ``_WKV6`` as on the
card: the checks and allocations of the CUDA path, the backward's
checkpoints included, with ``fake_launch``'s op in place of the launch,
counted at the plain versions' FLOPs.  Neither the kernels nor the plain
versions run, and the ``launches.*`` counters stay as they are.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import tracing
from repro_torch.kernels import build

_DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (8, 16, 32, 64)   # the kernels' instantiations
CHUNK_HEAD_DIMS = (64,)       # on the chunk kernel, r, k, v in either type; the rest on the token kernel
BWD_CHUNK = 64                # tokens a chunk of the backward, between its checkpoints (L in wkv6_bwd.cu)


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


@functools.cache
def _bwd_kernel():
    fn = build.load("wkv6_bwd").wkv6_bwd
    fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
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
    """The recurrence one token at a time, in float32 (float64 for float64
    r, a yardstick): ``out_t = r_t^T (S + diag(u) k_t v_t^T)``,
    ``S = diag(w_t) S + k_t v_t^T``.  Returns (out (B, T, H, hd), final
    state (B, H, hd, hd)) in that type."""
    build.refuse_fake_cuda("wkv6", r, k, v, w, u, state)
    b, t_len, h, hd = r.shape
    ct = torch.float64 if r.dtype == torch.float64 else torch.float32
    if state is None:
        s = torch.zeros((b, h, hd, hd), dtype=ct, device=r.device)
    else:
        s = state.to(ct)
    r, k, v, w = (a.to(ct) for a in (r, k, v, w))
    bonus = u.to(ct)[None, :, :, None]
    outs = []
    for t in range(t_len):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]          # (B, H, hd, hd)
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, t], s + bonus * kv))
        s = w[:, t, :, :, None] * s + kv
    return torch.stack(outs, dim=1), s


def wkv6_bwd_plain(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,
    state: torch.Tensor | None,
    dout: torch.Tensor,
    dfinal: torch.Tensor | None = None,
) -> tuple[torch.Tensor, ...]:
    """The gradient of ``wkv6_plain(r, k, v, w, u, state)`` for the output
    gradient ``dout`` (B, T, H, hd) and the final state's ``dfinal``
    (B, H, hd, hd; zero when None), by the reverse-time recurrence of the
    state's gradient G: with S_{t-1} the state before token t and G_t the
    gradient of the state after it (G_T = dfinal), ``dr_t = S_{t-1} dout_t
    + u k_t (v_t . dout_t)``, ``dk_t = G_t v_t + r_t u (v_t . dout_t)``,
    ``dv_t = G_t^T k_t + (r_t . u k_t) dout_t``, ``dw_t = rowsum(G_t *
    S_{t-1})``, ``du = sum_t r_t k_t (v_t . dout_t)``, ``G_{t-1} = diag(w_t)
    G_t + r_t dout_t^T`` and d(state) = G_0.

    Computes in float32 (float64 for float64 inputs, a yardstick).  Returns
    (dr, dk, dv in r's dtype, dw in w's, du (H, hd) and d(state)
    (B, H, hd, hd) in the compute type)."""
    build.refuse_fake_cuda("wkv6_bwd", r, k, v, w, u, state, dout, dfinal)
    b, t_len, h, hd = r.shape
    ct = torch.float64 if r.dtype == torch.float64 else torch.float32
    rc, kc, vc, wc, do = (a.to(ct) for a in (r, k, v, w, dout))
    uc = u.to(ct)
    s = torch.zeros((b, h, hd, hd), dtype=ct, device=r.device) if state is None else state.to(ct)
    prev = []                                                  # S_{t-1}
    for t in range(t_len):
        prev.append(s)
        s = wc[:, t, :, :, None] * s + kc[:, t, :, :, None] * vc[:, t, :, None, :]
    prev = torch.stack(prev)                                   # (T, B, H, hd, hd)
    g = torch.zeros_like(s) if dfinal is None else dfinal.to(ct).clone()
    dk, dv, dw = [], [], []                                    # in reverse time
    for t in reversed(range(t_len)):
        dk.append((g @ vc[:, t, :, :, None])[..., 0])
        dv.append((kc[:, t, :, None, :] @ g)[..., 0, :])
        dw.append((g * prev[t]).sum(-1))
        g = wc[:, t, :, :, None] * g + rc[:, t, :, :, None] * do[:, t, :, None, :]
    dk, dv, dw = (torch.stack(a[::-1], dim=1) for a in (dk, dv, dw))
    vd = (vc * do).sum(-1, keepdim=True)                       # (B, T, H, 1)
    dr = torch.einsum("tbhij,bthj->bthi", prev, do) + uc * kc * vd
    dk = dk + rc * uc * vd
    dv = dv + (rc * uc * kc).sum(-1, keepdim=True) * do
    du = (rc * kc * vd).sum((0, 1))
    return dr.to(r.dtype), dk.to(r.dtype), dv.to(r.dtype), dw.to(w.dtype), du, g


def _plain_flops(r_shape, *_) -> int:
    """``wkv6_plain``'s count: a (hd) x (hd, hd) product per token, head
    and sequence."""
    b, t_len, h, hd = r_shape
    return 2 * b * t_len * h * hd * hd


def _plain_bwd_flops(r_shape, *_) -> int:
    """``wkv6_bwd_plain``'s count: three such products per token (``G v``,
    ``k^T G`` and ``S_{t-1} dout``)."""
    return 3 * _plain_flops(r_shape)


_fake_forward = build.fake_launch("wkv6", _plain_flops)
_fake_backward = build.fake_launch("wkv6_bwd", _plain_bwd_flops)


def route(dtype: torch.dtype, head_dim: int) -> str:
    """Which kernel a CUDA call with r, k, v of ``dtype`` (float32 or
    bfloat16: both take the same route) and ``head_dim`` launches:
    ``"chunk"`` (tensor cores) or ``"token"`` (CUDA cores), as ``wkv6.cu``'s
    dispatch decides."""
    if dtype not in _DTYPES:
        raise TypeError(f"wkv6 takes r, k, v in float32 or bfloat16, got {dtype}")
    return "chunk" if head_dim in CHUNK_HEAD_DIMS else "token"


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


def _check_kernel(r, k, v, w, u, state) -> None:
    """What both kernels take beyond ``_check``: non-empty, hd in
    ``HEAD_DIMS``, u and state float32, contiguous."""
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


def _ptr(a: torch.Tensor | None):
    return None if a is None else a.data_ptr()


def _forward(r, k, v, w, u, state) -> tuple[torch.Tensor, torch.Tensor]:
    fake = build.is_fake(r)
    if r.device.type == "cpu" and not fake:
        return wkv6_plain(r, k, v, w, u, state)
    _check_kernel(r, k, v, w, u, state)
    b, t_len, h, hd = r.shape
    out = torch.empty(r.shape, dtype=torch.float32, device=r.device)
    final = torch.empty((b, h, hd, hd), dtype=torch.float32, device=r.device)
    if fake:
        _fake_forward([r, k, v, w, u] + ([] if state is None else [state]), [out, final])
        return out, final
    check_alignment(route(r.dtype, hd), r, k, v, w)
    kernel = _kernel()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = kernel(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
            _ptr(state), out.data_ptr(), final.data_ptr(),
            b, t_len, h, hd, int(r.dtype == torch.bfloat16), int(w.dtype == torch.bfloat16),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"wkv6 launch failed with CUDA error {err}")
    tracing.count("launches.wkv6")
    return out, final


def wkv6_bwd(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,
    state: torch.Tensor | None,
    dout: torch.Tensor,
    dfinal: torch.Tensor | None = None,
) -> tuple[torch.Tensor, ...]:
    """(dr, dk, dv, dw, du, d(state)) of ``wkv6(r, k, v, w, u, state)`` for
    the output gradient ``dout`` (B, T, H, hd) and the final state's
    ``dfinal`` (B, H, hd, hd; zero when None), both float32: dr, dk, dv in
    r's dtype, dw in w's, du (H, hd) and d(state) (B, H, hd, hd) float32.

    On CUDA tensors (as the forward kernel takes them; dout and dfinal
    float32 and contiguous; r, k, v, w, dout, state and dfinal starting on
    16-byte boundaries, or it raises ``ValueError``) this launches the
    ``wkv6_bwd`` kernels on the current stream and raises if it cannot; on
    CPU tensors it computes ``wkv6_bwd_plain``, and on fake tensors it takes
    its fake form.  The counter ``launches.wkv6_bwd`` counts the calls
    that launched them.
    """
    build.refuse_dtensors("wkv6_bwd", r, k, v, w, u, state, dout, dfinal)
    _check(r, k, v, w, u, state)
    b, t_len, h, hd = r.shape
    if tuple(dout.shape) != tuple(r.shape) or dout.dtype != torch.float32 or dout.device != r.device:
        raise ValueError(f"dout must be float32 {tuple(r.shape)} on {r.device}, got "
                         f"{dout.dtype} {tuple(dout.shape)} on {dout.device}")
    if dfinal is not None and (tuple(dfinal.shape) != (b, h, hd, hd) or dfinal.dtype != torch.float32
                               or dfinal.device != r.device):
        raise ValueError(f"dfinal must be float32 {(b, h, hd, hd)} on {r.device}, got "
                         f"{dfinal.dtype} {tuple(dfinal.shape)} on {dfinal.device}")
    fake = build.is_fake(r)
    if r.device.type == "cpu" and not fake:
        return wkv6_bwd_plain(r, k, v, w, u, state, dout, dfinal)
    _check_kernel(r, k, v, w, u, state)
    if not (dout.is_contiguous() and (dfinal is None or dfinal.is_contiguous())):
        raise ValueError("the wkv6 backward kernel takes contiguous dout and dfinal")
    dr, dk, dv = (torch.empty_like(r) for _ in range(3))
    dw = torch.empty_like(w)
    n_chunks = -(-t_len // BWD_CHUNK)
    du_part = torch.empty((b, h, n_chunks, hd), dtype=torch.float32, device=r.device)
    dstate = torch.empty((b, h, hd, hd), dtype=torch.float32, device=r.device)
    # The checkpoints of S and of G, (B, H, chunks, hd, hd) each, then the
    # chunks' total decays (B, H, chunks, hd).
    ckpt = torch.empty(b * h * n_chunks * hd * (2 * hd + 1), dtype=torch.float32, device=r.device)
    if fake:
        inputs = [r, k, v, w, u, dout] + [a for a in (state, dfinal) if a is not None]
        _fake_backward(inputs, [dr, dk, dv, dw, du_part, dstate, ckpt])
        return dr, dk, dv, dw, du_part.sum((0, 2)), dstate
    for name, a in (("r", r), ("k", k), ("v", v), ("w", w), ("dout", dout), ("state", state), ("dfinal", dfinal)):
        if a is not None and a.data_ptr() % 16:
            raise ValueError(f"the wkv6 backward kernels take 16-byte-aligned operands; {name} starts at "
                             f"{a.data_ptr():#x}")
    kernel = _bwd_kernel()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = kernel(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(), _ptr(state),
            dout.data_ptr(), _ptr(dfinal), dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dw.data_ptr(),
            du_part.data_ptr(), dstate.data_ptr(), ckpt.data_ptr(),
            b, t_len, h, hd, int(r.dtype == torch.bfloat16), int(w.dtype == torch.bfloat16),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"wkv6_bwd launch failed with CUDA error {err}")
    tracing.count("launches.wkv6_bwd")
    # du's per-(b, h, chunk) partials, summed in one fixed order (no atomics).
    return dr, dk, dv, dw, du_part.sum((0, 2)), dstate


class _WKV6(torch.autograd.Function):
    """``wkv6`` with its gradient: the forward kernel, then the backward
    kernels on the saved r, k, v, w, u and initial state (their plain
    versions on CPU tensors).  A final state whose gradient autograd does
    not pass counts as zero; an initial state of None gets no gradient."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(r, k, v, w, u, state)
        return _forward(r, k, v, w, u, state)

    @staticmethod
    def backward(ctx, dout, dfinal):
        r, k, v, w, u, state = ctx.saved_tensors
        dout = torch.zeros(r.shape, dtype=torch.float32, device=r.device) if dout is None else dout.contiguous()
        dr, dk, dv, dw, du, dstate = wkv6_bwd(
            r, k, v, w, u, state, dout, None if dfinal is None else dfinal.contiguous()
        )
        return dr, dk, dv, dw, du, None if state is None else dstate


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
    tensors it computes ``wkv6_plain``, and on fake tensors it takes its
    fake form.  When autograd records a CUDA or fake call
    (grad mode on and an input requiring grad) the call goes through
    ``_WKV6``, whose backward is ``wkv6_bwd``.  The counter
    ``launches.wkv6`` counts the launches of either forward kernel.  A
    DTensor on the card raises ``TypeError``.
    """
    build.refuse_dtensors("wkv6", r, k, v, w, u, state)
    _check(r, k, v, w, u, state)
    if r.device.type == "cpu" and not build.is_fake(r):
        return wkv6_plain(r, k, v, w, u, state)
    if torch.is_grad_enabled() and any(a.requires_grad for a in (r, k, v, w, u, state) if a is not None):
        return _WKV6.apply(r, k, v, w, u, state)
    return _forward(r, k, v, w, u, state)
