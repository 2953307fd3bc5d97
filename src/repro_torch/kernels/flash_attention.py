"""Causal (optionally sliding-window) attention through the hand-written
``flash_attention`` CUDA kernel.

Port of the JAX package's ``kernels/ops.py::causal_attention`` over the
Pallas kernel ``kernels/flash_attention.py::flash_attention``, with
``causal_attention_plain`` as the counterpart of
``kernels/ref.py::attention_ref``.  The kernel takes the model's natural
``(B, S, H, hd)`` layout and reads KV head ``h // (H / KV)`` itself, so
there is no transposing, head-repeating or padding wrapper and no block-size
argument.  Positions are ``0 .. S-1`` for queries and keys alike, as on the
prefill and full-forward paths.

The source holds two kernels, both on the tensor cores, and ``route`` says
which one a call takes, as the C dispatch does: bfloat16 at head_dim 64,
96, 128 or 256 runs both products on ``wgmma`` (96 on 32-column,
64-byte-swizzle panels, the others on 64-column, 128-byte ones); every
float32 shape and bfloat16 at 16 or 32 run them on TF32 ``mma.sync`` with
every inexact operand split into a high and a low part, which keeps float32
accuracy.  The routing is fixed; neither kernel stands in for the other,
and no input is padded to another head_dim.  Both copy 16-byte chunks with
``cp.async`` and take 16-byte-aligned tensors only.

The gradient is a kernel too: ``causal_attention`` is the entry of the
autograd function ``_FlashAttention`` whenever a gradient is asked for, and
its backward launches the hand-written ``flash_attention_bwd`` kernels
(``csrc/flash_attention_bwd.cu``), with ``causal_attention_bwd_plain`` as
their plain version.  ``bwd_route`` says which of its two routes a call
takes, as its C dispatch does: bfloat16 at head_dim 64, 96, 128 or 256 on
``wgmma`` (bfloat16 operands, p and ds rounded to bfloat16, float32
sums); every float32 shape and bfloat16 at 16 or 32 on TF32 ``mma.sync``
with every inexact operand split into a high and a low part.  Their dK/dV
kernels walk a work list that ``dkdv_work`` builds in plain Python, once
per shape, for the route's tile rows (``bwd_tile_rows``).  The JAX package
differentiates ``attention_chunked`` with XLA instead; it has no backward
kernel.

On fake tensors (a counted fake run of a step, ``roofline.counter``) the
forward and the backward take their fake forms: the checks and allocations
of the CUDA path, workspaces included, with ``fake_launch``'s op in place of
the launch, counted at the plain versions' FLOPs.  Neither the kernels nor
the plain versions run, and the ``launches.*`` counters stay as they are.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.kernels import build

NEG_INF = -1e30
_DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (16, 32, 64, 96, 128, 256)   # the kernels' instantiations
TENSOR_CORE_HEAD_DIMS = (64, 96, 128, 256)   # bfloat16 ones on wgmma
_MAX_GRID_Y = 65535                  # B * H blocks on the backward kernels' gridDim.y

# The backward's dK/dV work list (``dkdv_work``): one row per item, these
# columns, int32.  An item is the (query tile x query head) steps
# [qtile0, qtile1) x [head0, head1) (heads within the KV head's group) of
# key tile ``key_tile`` of KV head row ``bkv`` = b * KV + kv head; ``slot``
# is -1 where the item is its key tile's only one (the kernel writes dk, dv)
# and otherwise the item's float32 partial in the scratch, a key tile's
# items taking consecutive slots in their order.
DKDV_ITEM_FIELDS = ("bkv", "key_tile", "head0", "head1", "qtile0", "qtile1", "slot")
# Streaming multiprocessors of an H100 SXM: the work list is cut so that no
# item holds more than the call's steps over this count.
NUM_SMS = 132
# The least cap on an item's steps, so that a small call, which need not
# fill the card, is not cut into single steps.
MIN_ITEM_STEPS = 16


def bwd_route(dtype: torch.dtype, head_dim: int) -> str:
    """Which backward kernels a CUDA call of ``dtype`` and ``head_dim``
    launches: ``"tensor-core"`` (bfloat16 ``wgmma``, ``tc::`` in
    ``flash_attention_bwd.cu``) or ``"tf32-mma"`` (split-TF32
    ``mma.sync``), as that file's dispatch decides: the forward's cases,
    so a call's gradient runs on the forward's route."""
    return route(dtype, head_dim)


def bwd_tile_rows(head_dim: int, dtype: torch.dtype) -> int:
    """Rows of the dK/dV kernel's key and query tiles at ``head_dim`` and
    ``dtype``: 64, wgmma's M, on the tensor-core route (``tc::TILE_ROWS``),
    and as ``KvTile`` sets them on the split-TF32 one."""
    if bwd_route(dtype, head_dim) == "tensor-core":
        return 64
    return 64 if head_dim <= 96 else 32


def visible_query_tiles(s_len: int, rows: int, window: int, key_tile: int) -> tuple[int, int]:
    """The query tiles [first, end) holding a query that sees a key of
    ``key_tile`` (tiles of ``rows`` positions; causal, and within the last
    ``window`` keys when ``window`` > 0).  Between a query tile and the key
    tile the position differences q - k run over one interval; the tile
    is visible where it meets [0, window)."""
    k0, n_tiles = key_tile * rows, -(-s_len // rows)
    first = key_tile
    end = first
    while end < n_tiles:
        q_last = min(end * rows + rows, s_len) - 1
        if q_last < k0 or (window > 0 and end * rows - (k0 + rows - 1) >= window):
            break
        end += 1
    return first, end


def dkdv_work(b: int, s_len: int, h: int, kv: int, rows: int, window: int) -> np.ndarray:
    """The dK/dV kernel's work list: int32 rows of ``DKDV_ITEM_FIELDS``.

    Each key tile's work is its visible query tiles (tiles of ``rows``
    positions) times the G = H / KV query heads of its group, one (query
    tile, head) step each.  With ``cap`` = the call's steps over
    ``NUM_SMS`` (at least ``MIN_ITEM_STEPS``), a key tile of at most
    ``cap`` steps is one item;
    a longer one is cut into the fewest near-equal runs of whole query
    tiles (runs of heads inside one query tile where G alone exceeds
    ``cap``) of at most ``cap`` steps, numbered 0, 1, ... in query-tile
    order, which the reduction sums in that order.  Items are ordered
    heaviest first (stable, so equal items keep their key tile order)."""
    g = h // kv
    n_tiles = -(-s_len // rows)
    ranges = [visible_query_tiles(s_len, rows, window, kt) for kt in range(n_tiles)]
    total = b * kv * g * sum(end - first for first, end in ranges)
    cap = max(MIN_ITEM_STEPS, total // NUM_SMS)
    pieces = []   # per key tile: (head0, head1, qtile0, qtile1) in order
    for first, end in ranges:
        n_q = end - first
        if g * n_q <= cap:
            pieces.append([(0, g, first, end)])
        elif g <= cap:
            k = -(-n_q // (cap // g))
            cuts = [first + i * n_q // k for i in range(k + 1)]
            pieces.append([(0, g, lo, hi) for lo, hi in zip(cuts, cuts[1:])])
        else:
            k = -(-g // cap)
            heads = [i * g // k for i in range(k + 1)]
            pieces.append([(h0, h1, qt, qt + 1) for qt in range(first, end) for h0, h1 in zip(heads, heads[1:])])
    items, slot = [], 0
    for bkv in range(b * kv):
        for kt, tile in enumerate(pieces):
            for h0, h1, q0, q1 in tile:
                items.append((bkv, kt, h0, h1, q0, q1, -1 if len(tile) == 1 else slot))
                slot += len(tile) > 1
    items.sort(key=lambda it: -(it[3] - it[2]) * (it[5] - it[4]))
    return np.asarray(items, dtype=np.int32).reshape(-1, len(DKDV_ITEM_FIELDS))


def dkdv_splits(items: np.ndarray) -> np.ndarray:
    """The key tiles that ``items`` cuts into several: int32 rows (bkv,
    key tile, first slot, items), in slot order; the reduction kernel sums
    slots first .. first + items - 1 in that order."""
    cut = items[items[:, 6] >= 0]
    rows = {}
    for bkv, kt, *_, slot in sorted(cut.tolist(), key=lambda it: it[6]):
        first, n = rows.get((bkv, kt), (slot, 0))
        rows[(bkv, kt)] = (first, n + 1)
    return np.asarray([(bkv, kt, first, n) for (bkv, kt), (first, n) in rows.items()],
                      dtype=np.int32).reshape(-1, 4)


@functools.cache
def _dkdv_items(b: int, s_len: int, h: int, kv: int, rows: int, window: int) -> tuple[np.ndarray, int]:
    """The work list of one shape at tiles of ``rows`` and the partial
    slots it needs; built once per shape."""
    items = dkdv_work(b, s_len, h, kv, rows, window)
    return items, int(items[:, 6].max()) + 1 if len(items) else 0


@functools.cache
def _dkdv_plan(b: int, s_len: int, h: int, kv: int, rows: int, window: int, device: torch.device):
    """The work list and split list of one shape on ``device``; built once
    per shape."""
    items, _ = _dkdv_items(b, s_len, h, kv, rows, window)
    return torch.from_numpy(items).to(device), torch.from_numpy(dkdv_splits(items)).to(device)


def _plain_flops(q_shape, *_) -> int:
    """``causal_attention_plain``'s count: two products over every
    (query, key) pair of every query head."""
    b, s, h, hd = q_shape
    return 2 * (2 * b * h * s * s * hd)


def _plain_bwd_flops(q_shape, *_) -> int:
    """``causal_attention_bwd_plain``'s count: five such products (the
    scores, ``do v^T``, dq, dk and dv)."""
    b, s, h, hd = q_shape
    return 5 * (2 * b * h * s * s * hd)


_fake_forward = build.fake_launch("flash_attention", _plain_flops)
_fake_backward = build.fake_launch("flash_attention_bwd", _plain_bwd_flops)


@functools.cache
def _kernel():
    fn = build.load("flash_attention").flash_attention
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_kernel():
    fn = build.load("flash_attention_bwd").flash_attention_bwd
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int] + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def causal_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: float, window: int = 0
) -> torch.Tensor:
    """The kernel's function in plain PyTorch: KV heads repeated, float32
    scores masked to ``NEG_INF``, softmax in float32, probabilities cast to
    v's dtype before the product with v; output in q's dtype."""
    build.refuse_fake_cuda("flash_attention", q, k, v)
    s_len, h = q.shape[1], q.shape[2]
    rep = h // k.shape[2]
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    scores = scores.masked_fill(~_mask(s_len, window, q.device), NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v).to(q.dtype)


def route(dtype: torch.dtype, head_dim: int) -> str:
    """Which kernel a CUDA call of ``dtype`` and ``head_dim`` launches:
    ``"tensor-core"`` (bfloat16 ``wgmma``) or ``"tf32-mma"`` (split-TF32
    ``mma.sync``), as ``flash_attention.cu``'s dispatch decides."""
    if dtype == torch.bfloat16 and head_dim in TENSOR_CORE_HEAD_DIMS:
        return "tensor-core"
    return "tf32-mma"


def check_alignment(*tensors: torch.Tensor) -> None:
    """Every flash_attention kernel, forward and backward, copies 16-byte
    chunks with ``cp.async``, so it takes only tensors whose data starts on
    a 16-byte boundary (a view into another tensor may not); raises
    ``ValueError`` otherwise."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(
                f"the flash_attention kernels take 16-byte-aligned "
                f"tensors; got data at {t.data_ptr():#x}"
            )


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"attention takes q (B, S, H, hd) and k, v (B, S, KV, hd), got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, s, h, hd = q.shape
    if k.shape[0] != b or k.shape[1] != s or k.shape[3] != hd:
        raise ValueError(f"q {tuple(q.shape)} and k, v {tuple(k.shape)} disagree")
    if k.shape[2] < 1 or h % k.shape[2]:
        raise ValueError(f"KV heads ({k.shape[2]}) must divide query heads ({h})")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"q, k, v must share float32 or bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on different devices: {q.device}, {k.device}, {v.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")


def _mask(s_len: int, window: int, device) -> torch.Tensor:
    """(S, S) boolean mask of the (query, key) pairs the kernels see."""
    pos = torch.arange(s_len, device=device)
    mask = pos[None, :] <= pos[:, None]
    if window > 0:
        mask &= pos[:, None] - pos[None, :] < window
    return mask


def causal_attention_bwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    do: torch.Tensor,
    *,
    scale: float,
    window: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels' function in plain PyTorch: (dq, dk, dv) of
    ``causal_attention`` at q, k, v, given its output ``o`` and the output's
    gradient ``do``, in float32 arithmetic (float64 for float64 inputs, a
    yardstick for both) and the inputs' dtypes.  Each row's log-sum-exp
    over its visible keys gives ``p`` (0 on masked pairs), ``delta = do .
    o`` gives ``ds = p (do v^T - delta)``; dk and dv are summed over the
    query heads of each KV head."""
    build.refuse_fake_cuda("flash_attention_bwd", q, k, v, o, do)
    b, s_len, h, hd = q.shape
    kv = k.shape[2]
    rep = h // kv
    acc = torch.float64 if q.dtype == torch.float64 else torch.float32
    qf, of, dof = q.to(acc), o.to(acc), do.to(acc)
    kf = k.to(acc).repeat_interleave(rep, dim=2)
    vf = v.to(acc).repeat_interleave(rep, dim=2)
    mask = _mask(s_len, window, q.device)
    scores = (torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale).masked_fill(~mask, NEG_INF)
    lse = torch.logsumexp(scores, dim=-1, keepdim=True)
    p = torch.exp(scores - lse).masked_fill(~mask, 0.0)
    delta = (dof * of).sum(dim=-1).transpose(1, 2)[..., None]          # (B, H, S, 1)
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", dof, vf) - delta)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)

    def group_sum(a):
        return a.reshape(b, s_len, kv, rep, hd).sum(dim=3)

    return dq.to(q.dtype), group_sum(dk).to(k.dtype), group_sum(dv).to(v.dtype)


def _check_kernel_shape(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """What both kernels take beyond ``_check``: non-empty, hd in
    ``HEAD_DIMS``, B * H within the grid, contiguous."""
    b, s, h, hd = q.shape
    if s < 1 or b < 1:
        raise ValueError(f"empty attention input {tuple(q.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head_dim in {HEAD_DIMS}, got {hd}")
    if b * h > _MAX_GRID_Y:
        raise ValueError(f"attention input too large for the kernel: {tuple(q.shape)}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("the flash_attention kernel takes contiguous q, k, v")


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, window: int) -> torch.Tensor:
    fake = build.is_fake(q)
    if q.device.type == "cpu" and not fake:
        return causal_attention_plain(q, k, v, scale=scale, window=window)
    _check_kernel_shape(q, k, v)
    b, s, h, hd = q.shape
    out = torch.empty_like(q)
    if fake:
        _fake_forward([q, k, v], [out])
        return out
    check_alignment(q, k, v)
    kernel = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = kernel(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, s, h, k.shape[2], hd, scale, int(window), int(q.dtype == torch.bfloat16),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed with CUDA error {err}")
    tracing.count("launches.causal_attention")
    return out


def causal_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    do: torch.Tensor,
    *,
    scale: float,
    window: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``causal_attention(q, k, v, scale=scale,
    window=window)``, whose output was ``o``, for the output gradient
    ``do``; each in its input's dtype.

    On CUDA tensors (as the forward kernel takes them; o and do of q's
    shape, dtype and device, contiguous; all five 16-byte-aligned, as the
    kernels copy 16-byte chunks with ``cp.async``) this launches the
    ``flash_attention_bwd`` kernels of the route ``bwd_route`` names on the
    current stream and raises if it cannot; on CPU tensors it computes
    ``causal_attention_bwd_plain``, and on fake tensors it takes its fake
    form, which allocates what the launch would.
    The counter ``launches.causal_attention_bwd`` counts the calls that
    launched them.
    """
    build.refuse_dtensors("flash_attention_bwd", q, k, v, o, do)
    _check(q, k, v)
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(
                f"{name} must match q ({tuple(q.shape)}, {q.dtype}, {q.device}), got "
                f"{tuple(t.shape)}, {t.dtype}, {t.device}"
            )
    fake = build.is_fake(q)
    if q.device.type == "cpu" and not fake:
        return causal_attention_bwd_plain(q, k, v, o, do, scale=scale, window=window)
    _check_kernel_shape(q, k, v)
    if not (o.is_contiguous() and do.is_contiguous()):
        raise ValueError("the flash_attention backward kernel takes contiguous o and do")
    b, s, h, hd = q.shape
    kv = k.shape[2]
    rows = bwd_tile_rows(hd, q.dtype)
    _, slots = _dkdv_items(b, s, h, kv, rows, int(window))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    stats = torch.empty((2, b, h, s), dtype=torch.float32, device=q.device)   # lse, delta
    # One float32 (dk, dv) tile of partial sums per slot of a cut key tile.
    partial = torch.empty((max(slots, 1), 2, rows, hd), dtype=torch.float32, device=q.device)
    if fake:
        _fake_backward([q, k, v, o, do], [dq, dk, dv, stats, partial])
        return dq, dk, dv
    check_alignment(q, k, v, o, do)
    kernel = _bwd_kernel()
    items, splits = _dkdv_plan(b, s, h, kv, rows, int(window), q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = kernel(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats[0].data_ptr(), stats[1].data_ptr(),
            partial.data_ptr(), items.data_ptr(), len(items), splits.data_ptr(), len(splits),
            b, s, h, kv, hd, scale, int(window), int(q.dtype == torch.bfloat16),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd launch failed with CUDA error {err}")
    tracing.count("launches.causal_attention_bwd")
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """``causal_attention`` with its gradient: the forward kernel, then the
    backward kernels on the saved q, k, v and output (their plain versions
    on CPU tensors)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, window):
        out = _forward(q, k, v, scale, window)
        ctx.save_for_backward(q, k, v, out)
        ctx.scale, ctx.window = scale, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = causal_attention_bwd(
            q, k, v, out, dout.contiguous(), scale=ctx.scale, window=ctx.window
        )
        return dq, dk, dv, None, None


def causal_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: float, window: int = 0
) -> torch.Tensor:
    """Causal GQA attention: q (B, S, H, hd), k and v (B, S, KV, hd) with KV
    dividing H; ``window`` > 0 keeps the last ``window`` keys of each query.
    Returns (B, S, H, hd) in q's dtype.

    On CUDA tensors (contiguous, float32 or bfloat16, hd in ``HEAD_DIMS``,
    16-byte-aligned) this launches the kernel that
    ``route`` names on the current stream and raises if it cannot; on CPU
    tensors it computes ``causal_attention_plain``, and on fake tensors it
    takes its fake form.  When autograd records
    (grad mode on and an input requiring grad) the call goes through
    ``_FlashAttention``, whose backward is ``causal_attention_bwd``.
    The counter ``launches.causal_attention`` counts the launches of
    either forward kernel.  A DTensor on the card raises ``TypeError``.
    """
    build.refuse_dtensors("flash_attention", q, k, v)
    _check(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v, scale, window)
    return _forward(q, k, v, scale, window)
