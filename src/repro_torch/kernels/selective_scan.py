"""Hymba's selective scan through the hand-written ``selective_scan`` CUDA
kernel.

The kernel replaces no TPU kernel: the JAX package runs
``models/ssm.py::selective_scan_chunked`` as jnp code.  It computes that
function, per batch b and channel d from the state ``h0``,

    h_t = exp(-softplus(dt_t) A_d) h_{t-1} + softplus(dt_t) u_t B_t
    y_t = C_t . h_t

in float32 over segments of ``segment_len`` tokens: each segment's map
``h -> P h + h_loc`` (P the product of its decays, h_loc its final state
from zero), the maps composed from ``h0`` into the state entering each
segment, and each segment walked again from that state for its outputs
(``csrc/selective_scan.cu`` says how).  ``selective_scan_plain`` is the same
segment algorithm in PyTorch.

``models/ssm.py::selective_scan_chunked`` calls ``selective_scan`` for real
CUDA tensors when no gradient is needed (prefill); the train step, fake
tensors and CPU tensors keep the chunked closed form.  The kernel has no
backward and no fake form.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch import tracing
from repro_torch.kernels import build

_DTYPES = (torch.float32, torch.bfloat16)
N_STATE = 16          # the kernel's state size (N in selective_scan.cu)
SEG_MAX = 128         # the longest segment (MAX_SEG in selective_scan.cu)
THREADS = 128         # channels a block of the walks (THREADS in selective_scan.cu)
MIN_BLOCKS = 8        # blocks of each walk an SM holds (MIN_BLOCKS, the launch bounds, in selective_scan.cu)
H100_SMS = 132        # the SMs a CPU call segments for: the card the port runs on


@functools.cache
def _kernel():
    fn = build.load("selective_scan").selective_scan
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _sms(device: torch.device) -> int:
    """The SMs of a CUDA device; an H100's for the CPU."""
    if device.type != "cuda":
        return H100_SMS
    return torch.cuda.get_device_properties(device).multi_processor_count


def segment_len(batch: int, seq: int, d_inner: int, sms: int) -> int:
    """Tokens a segment.  Each walk launches a block of THREADS channels per
    segment and batch row, and a wave of the card holds ``sms *
    MIN_BLOCKS`` blocks.  The segments are as many as one wave holds (at
    least one), times the fewest waves that keep a segment within SEG_MAX
    tokens, and as long as that makes them: one wave at hymba's prompts, so
    that no wave runs part-empty while every thread walks its segment."""
    per_wave = max(1, sms * MIN_BLOCKS // (batch * -(-d_inner // THREADS)))
    waves = -(-seq // (per_wave * SEG_MAX))
    return -(-seq // (per_wave * waves))


def _segments(u, B_t, C_t, dt, A, seg):
    """Decays a, inputs c = softplus(dt) u, B_t and C_t cut into segments,
    (B, segments, seg, d_inner or N), in float32.  A ragged last segment is
    padded with tokens that decay by 1 and add nothing."""
    b, s, _ = u.shape
    pad = -(-s // seg) * seg - s
    sp = F.softplus(dt.float())
    a = F.pad(torch.exp(-sp * A.float()), (0, 0, 0, pad), value=1.0)
    c = F.pad(sp * u.float(), (0, 0, 0, pad))
    bs, cs = (F.pad(m.float(), (0, 0, 0, pad)) for m in (B_t, C_t))
    return [m.reshape(b, -1, seg, m.shape[-1]) for m in (a, c, bs, cs)]


def _walk(a, c, bs, h, cs=None):
    """Every segment's tokens from the states ``h`` (B, segments, d, N);
    returns the states after them and, given ``cs``, each token's output
    (B, segments, seg, d)."""
    ys = []
    for t in range(a.shape[2]):
        h = a[:, :, t, :, None] * h + c[:, :, t, :, None] * bs[:, :, t, None, :]
        if cs is not None:
            ys.append(torch.einsum("bkdn,bkn->bkd", h, cs[:, :, t]))
    return h, (torch.stack(ys, dim=2) if ys else None)


def _entering_states(decay, local, h0):
    """The state entering each segment (B, segments, d, N), and the final
    state, from the segments' maps ``h -> decay h + local``."""
    h, h_in = h0, []
    for k in range(decay.shape[1]):
        h_in.append(h)
        h = decay[:, k, :, None] * h + local[:, k]
    return torch.stack(h_in, dim=1), h


def selective_scan_plain(
    u: torch.Tensor,      # (B, S, d_inner)
    B_t: torch.Tensor,    # (B, S, N)
    C_t: torch.Tensor,    # (B, S, N)
    dt: torch.Tensor,     # (B, S, d_inner) pre-softplus
    A: torch.Tensor,      # (d_inner,)
    h0: torch.Tensor,     # (B, d_inner, N)
) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's segment algorithm in PyTorch, in float32, segmented as
    the kernel would be on the tensors' card (on an H100 for CPU tensors).
    Returns (y (B, S, d_inner), final state (B, d_inner, N))."""
    build.refuse_fake_cuda("selective_scan", u, B_t, C_t, dt, A, h0)
    b, s, d = u.shape
    a, c, bs, cs = _segments(u, B_t, C_t, dt, A, segment_len(b, s, d, _sms(u.device)))
    zero = torch.zeros((*a.shape[:2], d, B_t.shape[-1]), device=a.device)
    local, _ = _walk(a, c, bs, zero)
    h_in, h_final = _entering_states(a.prod(dim=2), local, h0.float())
    _, y = _walk(a, c, bs, h_in, cs)
    return y.reshape(b, -1, d)[:, :s], h_final


def _check(u, B_t, C_t, dt, A, h0) -> None:
    if u.dim() != 3 or dt.shape != u.shape:
        raise ValueError(f"u and dt must be one (B, S, d_inner) shape, got {tuple(u.shape)}, {tuple(dt.shape)}")
    b, s, d = u.shape
    if min(b, s, d) < 1:
        raise ValueError(f"empty selective_scan input {tuple(u.shape)}")
    n = B_t.shape[-1] if B_t.dim() == 3 else -1
    if B_t.shape != C_t.shape or tuple(B_t.shape) != (b, s, n):
        raise ValueError(f"B_t and C_t must be (B, S, N) = ({b}, {s}, N), got {tuple(B_t.shape)}, {tuple(C_t.shape)}")
    if tuple(A.shape) != (d,) or tuple(h0.shape) != (b, d, n):
        raise ValueError(f"A must be ({d},) and h0 ({b}, {d}, {n}), got {tuple(A.shape)}, {tuple(h0.shape)}")
    if not (u.dtype == dt.dtype == B_t.dtype == C_t.dtype) or u.dtype not in _DTYPES:
        raise TypeError(f"u, dt, B_t, C_t must share float32 or bfloat16, got "
                        f"{u.dtype}, {dt.dtype}, {B_t.dtype}, {C_t.dtype}")
    if A.dtype != torch.float32 or h0.dtype != torch.float32:
        raise TypeError(f"A and h0 must be float32, got {A.dtype}, {h0.dtype}")
    tensors = (u, B_t, C_t, dt, A, h0)
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"selective_scan operands on different devices: {[str(t.device) for t in tensors]}")
    if u.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {u.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("selective_scan takes contiguous operands")


def selective_scan(
    u: torch.Tensor,
    B_t: torch.Tensor,
    C_t: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    h0: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The selective scan of u, dt (B, S, d_inner; dt before softplus) and
    B_t, C_t (B, S, N), all float32 or all bfloat16, with A (d_inner) and
    h0 (B, d_inner, N) float32, all contiguous.  Returns (y (B, S, d_inner),
    final state (B, d_inner, N)), float32.

    On CUDA tensors (N = ``N_STATE``) this launches the kernel's three
    launches on the current stream and raises if it cannot; on CPU tensors
    it computes ``selective_scan_plain``.  A CUDA call that autograd would
    record (grad mode on and an operand requiring grad) raises
    ``NotImplementedError``: the kernel has no backward.  The counter
    ``launches.selective_scan`` counts the calls that launched the kernel.
    A DTensor or a fake tensor on the card raises ``TypeError``.
    """
    build.refuse_dtensors("selective_scan", u, B_t, C_t, dt, A, h0)
    build.refuse_fake_cuda("selective_scan", u, B_t, C_t, dt, A, h0)
    _check(u, B_t, C_t, dt, A, h0)
    if u.device.type == "cpu":
        return selective_scan_plain(u, B_t, C_t, dt, A, h0)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (u, B_t, C_t, dt, A, h0)):
        raise NotImplementedError("the selective_scan kernel has no backward; a call that needs a gradient "
                                  "takes models/ssm.py's closed form")
    b, s, d = u.shape
    n = B_t.shape[-1]
    if n != N_STATE:
        raise ValueError(f"the selective_scan kernel takes a state of {N_STATE}, got {n}")
    seg = segment_len(b, s, d, _sms(u.device))
    n_seg = -(-s // seg)
    y = torch.empty((b, s, d), dtype=torch.float32, device=u.device)
    h_final = torch.empty((b, d, n), dtype=torch.float32, device=u.device)
    # The segments' maps: decays (B, segments, d), then states (B, segments, N, d).
    scratch = torch.empty(b * n_seg * d * (n + 1), dtype=torch.float32, device=u.device)
    decay_ptr = scratch.data_ptr()
    args = (
        u.data_ptr(), dt.data_ptr(), B_t.data_ptr(), C_t.data_ptr(), A.data_ptr(), h0.data_ptr(),
        y.data_ptr(), h_final.data_ptr(), decay_ptr, decay_ptr + 4 * b * n_seg * d,
        b, s, d, n, seg, int(u.dtype == torch.bfloat16),
    )
    kernel = _kernel()
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        # The profiler links a kernel launched outside PyTorch's dispatcher
        # only to an enclosing function-scope event (a user range sees none
        # of its device time); this one's name is no function's.
        with torch._C._profiler._RecordFunctionFast("repro_torch::selective_scan"):
            err = kernel(*args, stream)
    if err != 0:
        raise RuntimeError(f"selective_scan launch failed with CUDA error {err}")
    tracing.count("launches.selective_scan")
    return y, h_final
