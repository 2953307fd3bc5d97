"""Selective state-space mixer (Mamba/SSD-style), used by Hymba's parallel
SSM heads (arXiv:2411.13676).

Port of the JAX package's ``models/ssm.py``.  Per channel d with state size
N:

    h_t = exp(-softplus(dt_t) * A) * h_{t-1} + (softplus(dt_t) * x_t) B_t^T
    y_t = C_t^T h_t + D * x_t

with B_t, C_t, dt_t data-dependent projections of the input.
``selective_scan`` steps it token by token (decode, and the reference's
baseline); ``selective_scan_chunked`` is the closed form over chunks of L
tokens, with its products over whole chunks.  For real CUDA tensors that
need no gradient (prefill) ``selective_scan_chunked`` launches the
hand-written kernel ``kernels/selective_scan.py`` instead, which walks
segments of tokens with each channel's state in registers.

The reference's chunked form scales by ``exp(-cumsum(log a))``, which
grows without bound and overflows float32 once a chunk's
``sum softplus(dt) * A`` passes about 88.  The port forms only decay factors
``exp(lca_t - lca_s)`` with ``s <= t`` (``lca`` the running sum of
``log a = -softplus(dt) * A`` within the chunk, which never rises), so every
factor lies in [0, 1]; pairs with ``s > t`` are masked to ``-inf`` before
the ``exp``, never after, so no ``inf * 0`` can make a NaN.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import tracing
from repro_torch.device import resolve_device
from repro_torch.kernels import selective_scan as scan_kernel
from repro_torch.models.layers import Params, normal
from repro_torch.models.sharding_utils import _is_dtensor, head_placements, is_fake, like, on_shards

# Bytes of the (B, chunks, L, L, d_inner) float32 decay tensor that
# ``selective_scan_chunked`` holds at once (hymba-1.5b: 26 MB per chunk).
_DECAY_BLOCK_BYTES = 1 << 28


def ssm_init(
    generator: torch.Generator,
    d_model: int,
    d_inner: int,
    state: int,
    dtype: torch.dtype,
    device: "str | torch.device" = "cuda",
) -> Params:
    dev = resolve_device(device)
    s = 1.0 / np.sqrt(d_model)
    return {
        "w_in": normal((d_model, d_inner), s, generator, dtype, dev),
        "w_gate": normal((d_model, d_inner), s, generator, dtype, dev),
        "w_B": normal((d_model, state), s, generator, dtype, dev),
        "w_C": normal((d_model, state), s, generator, dtype, dev),
        "w_dt": normal((d_model, d_inner), s, generator, dtype, dev),
        "A_log": torch.zeros((d_inner,), dtype=torch.float32, device=dev),   # A = exp(A_log) > 0
        "D": torch.ones((d_inner,), dtype=torch.float32, device=dev),
        "w_out": normal((d_inner, d_model), 1.0 / np.sqrt(d_inner), generator, dtype, dev),
    }


def ssm_param_count(d_model: int, d_inner: int, state: int) -> int:
    return (
        3 * d_model * d_inner
        + 2 * d_model * state
        + 2 * d_inner
        + d_inner * d_model
    )


def _scan_step(h, x_t, b_t, c_t, dt_t, A):
    """One token of the scan: the new state and its output (B, d_inner)."""
    decay = torch.exp(-dt_t * A)                               # (B, d_inner)
    h = h * decay[..., None] + (dt_t * x_t)[..., None] * b_t[:, None, :]
    return h, torch.einsum("bdn,bn->bd", h, c_t)


def selective_scan(
    x: torch.Tensor,      # (B, S, d_inner)
    B_t: torch.Tensor,    # (B, S, N)
    C_t: torch.Tensor,    # (B, S, N)
    dt: torch.Tensor,     # (B, S, d_inner) pre-softplus
    A: torch.Tensor,      # (d_inner,)
    h0: torch.Tensor,     # (B, d_inner, N)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sequential selective scan in float32; returns (y (B, S, d_inner),
    h_final).  On fake tensors (a counted dry run) of more than three
    tokens it runs ``_counted_scan``, which the counter counts as the loop."""
    dt = F.softplus(dt.float())
    x, B_t, C_t = x.float(), B_t.float(), C_t.float()
    h = h0.float()
    if is_fake(x) and x.shape[1] > 3:
        return _counted_scan(x, B_t, C_t, dt, A, h)
    ys = []
    for x_t, b_t, c_t, dt_t in zip(x.unbind(1), B_t.unbind(1), C_t.unbind(1), dt.unbind(1)):
        h, y = _scan_step(h, x_t, b_t, c_t, dt_t, A)
        ys.append(y)
    return torch.stack(ys, dim=1), h


class _Columns(torch.autograd.Function):
    """Columns 0, 1 and S-1 of x (B, S, ...), views as ``unbind`` gives
    them; the gradient is the stack of S columns' gradients with column
    1's standing for columns 1 .. S-2, which costs what ``unbind``'s
    backward costs for S columns."""

    @staticmethod
    def forward(ctx, x):
        ctx.n = x.shape[1]
        return x.select(1, 0), x.select(1, 1), x.select(1, -1)

    @staticmethod
    def backward(ctx, g0, g1, g2):
        return torch.stack([g0, *[g1] * (ctx.n - 2), g2], dim=1)


class _Rows(torch.autograd.Function):
    """The (B, S, d) output of S step outputs, from the first, one middle
    one standing for S-2 and the last, allocated whole: a copy of the
    middle one broadcast over S reads and writes what ``stack`` of S
    outputs does (the values are fake), and the gradient is ``unbind``'s
    views, as the loop's."""

    @staticmethod
    def forward(ctx, n, y0, y1, y2):
        return y1[:, None].expand(-1, n, *y1.shape[1:]).contiguous()

    @staticmethod
    def backward(ctx, g):
        cols = g.unbind(1)
        return None, cols[0], cols[1], cols[-1]


class _Region:
    """The backward pass's view of the repeated middle step: ``_Open``
    (after it in the forward pass, so first in the backward pass) opens a
    region of its multiplicity in the counter, ``_Close`` (before it)
    closes it.  That brackets exactly the step's backward nodes only
    because the autograd engine runs the ready nodes of one device in
    decreasing order of creation, an engine detail and no API: the two
    raise where that order would break the bracket (a close with no open
    region, or with another region opened inside it), and
    ``counter.count`` raises on a region left open."""

    def __init__(self, n: int):
        self.n, self.depth, self.steps = n, None, None


class _Close(torch.autograd.Function):
    @staticmethod
    def forward(ctx, region, h):
        ctx.region = region
        return h.view_as(h)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.roofline import counter

        region = ctx.region
        if region.depth is None or counter.open_regions() != region.depth:
            raise RuntimeError("the scan's backward region closes out of order: "
                               "the autograd engine did not run the repeated step's nodes in a bracket")
        # g, the gradient the step hands the step before it, is held once:
        # the backward pass saves no gradient.
        region.steps.carry(g)
        counter.pop_repeats()
        region.depth = region.steps = None
        return None, g


class _Open(torch.autograd.Function):
    @staticmethod
    def forward(ctx, region, h, y):
        ctx.region = region
        ctx.set_materialize_grads(False)
        return h.view_as(h), y.view_as(y)

    @staticmethod
    def backward(ctx, gh, gy):
        from repro_torch.roofline import counter

        if ctx.region.depth is not None:
            raise RuntimeError("the scan's backward region opens twice")
        ctx.region.steps = counter.push_repeats(ctx.region.n)
        ctx.region.depth = counter.open_regions()
        return None, gh, gy


def _counted_scan(x, B_t, C_t, dt, A, h):
    """The sequential scan as the roofline counter should see it, on fake
    tensors of S > 3 tokens: the first step, one middle step counted S-2
    times over (``counter.repeated``, and in the backward pass a region of
    the same multiplicity), and the last step, between the column split
    and the output stack that the loop has.  Every token's ops are the
    loop's: FLOPs and bytes equal the loop's on one rank, and a step's
    backward sees the gradient accumulations the loop's interior steps do
    (the state's two uses, ``A``'s).  The (B, S, d_inner) output is
    allocated whole, as the loop's stack (the reference's while loop's
    buffer) is.  Memory is the loop's too: what the middle step leaves live
    (the tensors it saves for the backward pass, its output) is charged
    S-2 times, and its new state S-2 times only where it outlives the last
    step (saved for the backward pass, not dropped by remat's first
    forward or by a pass without gradients)."""
    from repro_torch.roofline import counter

    s = x.shape[1]
    cols = [_Columns.apply(a) for a in (x, B_t, C_t, dt)]
    h, y0 = _scan_step(h, *(c[0] for c in cols), A)
    region = _Region(s - 2)
    h = _Close.apply(region, h)
    with counter.repeated(s - 2) as steps:
        h, y1 = _scan_step(h, *(c[1] for c in cols), A)
        steps.carry(h)
    h, y1 = _Open.apply(region, h, y1)
    h, y2 = _scan_step(h, *(c[2] for c in cols), A)
    steps.settle()
    return _Rows.apply(s, y0, y1, y2), h


def _chunk_states(a: torch.Tensor, u: torch.Tensor, h0: torch.Tensor):
    """States entering each chunk, and the final state.  Chunk c maps a
    state h to ``a_c h + u_c`` (a (B, C, d), u (B, C, d, N)); an inclusive
    scan composes those maps (Hillis-Steele, log2 C steps), where
    ``(a2, u2) o (a1, u1) = (a1 a2, a2 u1 + u2)`` multiplies decays in
    [0, 1] only."""
    n = a.shape[1]
    step = 1
    while step < n:
        a_prev, u_prev = a[:, :-step], u[:, :-step]
        a_cur, u_cur = a[:, step:], u[:, step:]
        u = torch.cat([u[:, :step], a_cur[..., None] * u_prev + u_cur], dim=1)
        a = torch.cat([a[:, :step], a_prev * a_cur], dim=1)
        step *= 2
    after = a[..., None] * h0[:, None] + u                     # state after chunk c
    return torch.cat([h0[:, None], after[:, :-1]], dim=1), after[:, -1]


def _takes_kernel(*tensors: torch.Tensor) -> bool:
    """Whether the scan runs the hand-written kernel: real (not fake) CUDA
    tensors, and no gradient needed."""
    x = tensors[0]
    if x.device.type != "cuda" or is_fake(x):
        return False
    return not (torch.is_grad_enabled() and any(t.requires_grad for t in tensors))


def selective_scan_chunked(
    x: torch.Tensor,      # (B, S, d_inner)
    B_t: torch.Tensor,    # (B, S, N)
    C_t: torch.Tensor,    # (B, S, N)
    dt: torch.Tensor,     # (B, S, d_inner) pre-softplus
    A: torch.Tensor,      # (d_inner,)
    h0: torch.Tensor,     # (B, d_inner, N)
    *,
    chunk: int = 32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The scan over the whole sequence, float32.  Real CUDA tensors that
    need no gradient take the ``selective_scan`` kernel, at any S
    (``_takes_kernel``); the train step, fake tensors (a counted dry run)
    and CPU tensors take the chunked closed form (``_closed_form``)."""
    if _takes_kernel(x, B_t, C_t, dt, A, h0):
        return _kernel_scan(x, B_t, C_t, dt, A, h0)
    return _closed_form(x, B_t, C_t, dt, A, h0, chunk)


def _kernel_scan(x, B_t, C_t, dt, A, h0):
    """The ``selective_scan`` kernel; on DTensors, on each rank's shards:
    batch rows and d_inner channels are independent, so the batch keeps
    its shards and d_inner its split where the split divides it (a
    sequence shard is gathered)."""
    if not _is_dtensor(x):
        return scan_kernel.selective_scan(x, B_t, C_t, dt, A, h0)
    px = head_placements(x, 0, 2, (x.shape[2],))
    pb, pa, ph = like(px, {0: 0}), like(px, {2: 0}), like(px, {0: 0, 2: 1})
    return on_shards(scan_kernel.selective_scan, [x, B_t, C_t, dt, A, h0], [px, pb, pb, px, pa, ph], [px, ph])


def _closed_form(x, B_t, C_t, dt, A, h0, chunk):
    """Chunked closed form, float32; falls back to ``selective_scan`` when
    the chunk does not divide S, as the reference does.

    With ``lca`` the inclusive running sum of ``-softplus(dt) * A`` within a
    chunk of L tokens, ``u'_s = softplus(dt_s) x_s`` and ``h`` the state
    entering the chunk:

        y_t = sum_{s <= t} exp(lca_t - lca_s) (B_s . C_t) u'_s + exp(lca_t) C_t^T h
        h'  = exp(lca_L) h + sum_s exp(lca_L - lca_s) u'_s B_s^T

    The states entering the chunks come from a scan over the chunks' maps
    (``_chunk_states``).  The (B, chunks, L, L, d_inner) decay tensor is
    formed a block of chunks at a time, at most ``_DECAY_BLOCK_BYTES``.
    """
    b, s, d = x.shape
    L = min(chunk, s)
    if s % L:
        return selective_scan(x, B_t, C_t, dt, A, h0)
    nc = s // L

    def chunks(a):
        return a.float().reshape(b, nc, L, -1)

    xc, bc, cc, dtc = map(chunks, (x, B_t, C_t, dt))
    dtc = F.softplus(dtc)
    lca = torch.cumsum(-dtc * A, dim=2)                        # (b, nc, L, d), <= 0
    up = dtc * xc                                              # u'_s
    last = lca[:, :, -1:]                                      # lca_L
    u = torch.einsum("bcsd,bcsn->bcdn", torch.exp(last - lca) * up, bc)
    h_in, h_final = _chunk_states(torch.exp(last[:, :, 0]), u, h0.float())
    y = torch.exp(lca) * torch.einsum("bcdn,bctn->bctd", h_in, cc)

    causal = torch.ones((L, L), dtype=torch.bool, device=x.device).triu()   # [s, t]: s <= t
    block = max(1, _DECAY_BLOCK_BYTES // (b * L * L * d * 4))
    for c0 in range(0, nc, block):
        sl = slice(c0, c0 + block)
        diff = lca[:, sl, None, :, :] - lca[:, sl, :, None, :]             # [b, c, s, t, d] = lca_t - lca_s
        w = torch.exp(diff.masked_fill_(~causal[:, :, None], float("-inf")))
        m = torch.einsum("bcsn,bctn->bcst", bc[:, sl], cc[:, sl])
        # Not in place: exp's backward reads w, and under remat autograd
        # does not see an in-place change to a saved output.
        y[:, sl] += (w * (m[..., None] * up[:, sl, :, None, :])).sum(dim=2)
    return y.reshape(b, s, d), h_final


def ssm_forward(
    x: torch.Tensor,
    p: Params,
    h0: torch.Tensor | None = None,
    *,
    chunked: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (B, S, D); returns (y, final_state).  ``chunked``
    takes the chunked form for S > 1, as the reference does."""
    with tracing.span("ssm"):
        B, S, _ = x.shape
        d_inner = p["w_in"].shape[-1]
        N = p["w_B"].shape[-1]
        if h0 is None:
            h0 = torch.zeros((B, d_inner, N), dtype=torch.float32, device=x.device)
        u = x @ p["w_in"]
        z = F.silu(x @ p["w_gate"])
        B_t = x @ p["w_B"]
        C_t = x @ p["w_C"]
        dt = x @ p["w_dt"]
        A = torch.exp(p["A_log"])
        with tracing.span("ssm.scan"):
            if chunked and S > 1:
                y, h = selective_scan_chunked(u, B_t, C_t, dt, A, h0)
            else:
                y, h = selective_scan(u, B_t, C_t, dt, A, h0)
        y = (y + p["D"] * u.float()).to(x.dtype)
        return (y * z) @ p["w_out"], h


def ssm_state_init(
    batch: int, d_inner: int, state: int, device: "str | torch.device" = "cuda"
) -> torch.Tensor:
    return torch.zeros((batch, d_inner, state), dtype=torch.float32, device=resolve_device(device))
