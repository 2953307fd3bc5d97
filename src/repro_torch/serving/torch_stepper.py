"""Lindley stepper on the device: the vectorized fast path in torch ops.

``TorchStepper`` is ``RuntimeSimulator`` with the two sequential-bottleneck
recurrences -- the TPU FCFS Lindley pass and the single-core CPU-pool
passes -- evaluated by a chunked max-plus scan on a torch device instead of
the NumPy guess/classify/fixpoint of ``_server_ends``.  Everything order- or
integer-valued (routing, SRAM miss replay, recording, cache stamps,
multi-core CPU heaps) is inherited unchanged from the parent, so the two
backends differ *only* in float rounding of the busy-period recurrence.

Contract (the reference's standing invariant): the NumPy paths are the
bitwise references; this path is **statistically equivalent** -- float32
recurrences, means/p99 within tolerance on seeded replicas, identical
integer observables.  The scan works in *delay space* precisely to make
float32 safe: absolute completion clocks (thousands of seconds) would lose
the microsecond-scale service times to cancellation, while queueing delays
and inter-arrival gaps stay small.

Mathematics
-----------
The FCFS busy-period recurrence over enqueue times ``tau`` and services
``s`` is ``end[j] = max(tau[j], end[j-1]) + s[j]``.  Substituting the
*delay* ``d[j] = end[j] - tau[j]`` and the gap ``g[j] = tau[j] -
tau[j-1]`` gives

    d[j] = max(0, d[j-1] - g[j]) + s[j]
         = max(A[j], d[j-1] + B[j]),   A[j] = s[j],  B[j] = s[j] - g[j].

Each request is thus an element of the max-plus affine semigroup
``f(x) = max(A, x + B)`` with the associative composition

    (f2 . f1)(x) = max(max(A2, A1 + B2), x + (B1 + B2)).

The trace reshapes into ``C`` contiguous chunks of length ``L``.  A
log-depth (Hillis-Steele) scan composes the ``(A, B)`` pairs themselves,
first along each chunk (9 steps at L = 512), then over the ``C`` chunk
carries (11 steps at C = 2048), and an elementwise resolve applies the
backlog entering each chunk.  The reference's prefix-sum identity
(``pB = cumsum(B)``, ``pA = pB + cummax(A - pB)``) is not used at either
level: ``pB`` is the span of time the prefix covers, and recovering a
small delay from ``pB + (A - pB)`` costs a float32 ulp of that span --
~3e-6 s for a 30 s re-plan span of a few hundred requests, ~1e-4 s for
the carries of 2^20 requests -- where the composition keeps ~1e-7 s.

``TorchStepper.run_trace_replicas`` is the Monte-Carlo engine this buys:
``R`` per-model service-jitter replicas of one arrival order resolve in a
handful of device passes -- arrival order, routing, and the SRAM miss
pattern are shared (service jitter cannot reorder FCFS enqueues), so they
are hoisted out of the replica loop, while the NumPy stepper must pay the
full pipeline per replica.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.serving.simulator import RuntimeSimulator
from repro_torch.serving.workload import Trace

__all__ = ["TorchStepper", "ReplicaStats", "lindley_ends"]

# Identity element of the max-plus affine semigroup: max(NEG, x + 0) == x
# for every finite float32 x.  Finite (not -inf) so composition arithmetic
# on padded lanes never produces inf - inf = nan.
_NEG = np.float32(-3e38)


def _grid(n: int) -> tuple[int, int]:
    """Chunk grid ``(C, L)`` with ``C * L >= n``, both powers of two.

    The reference's blocking, kept as it is: C ~ 2048 chunks of L >= 512,
    so each scan level stays at most 11 doubling steps deep.
    """
    padded = 1 << max(10, (n - 1).bit_length())
    c = min(2048, max(1, padded // 512))
    return c, padded // c


def _scan(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Inclusive max-plus composition scan along the last axis.

    Hillis-Steele: after the step of stride ``s``, entry ``k`` holds the
    elements ``k - 2s + 1 .. k`` composed, the earlier block applied first
    (``(A2, B2) . (A1, B1) = (max(A2, A1 + B2), B1 + B2)``).  Every term
    that wins a ``max`` is a delay or a busy-period backlog, so nothing
    small is ever recovered from a difference of two large sums.
    """
    n = a.shape[-1]
    shift = 1
    while shift < n:
        a_next = torch.empty_like(a)
        b_next = torch.empty_like(b)
        a_next[..., :shift] = a[..., :shift]
        b_next[..., :shift] = b[..., :shift]
        torch.maximum(a[..., shift:], a[..., :-shift] + b[..., shift:], out=a_next[..., shift:])
        torch.add(b[..., :-shift], b[..., shift:], out=b_next[..., shift:])
        a, b = a_next, b_next
        shift *= 2
    return a, b


def _delays(a: torch.Tensor, b: torch.Tensor, x_init: torch.Tensor, c: int, l: int) -> torch.Tensor:
    """Batched Lindley delays: ``[R, c*l]`` elements -> ``[R, c*l]``.

    ``x_init`` is the per-replica initial backlog ``free0 - tau[0]``,
    shape ``[R]``.  Three stages (see module docstring): the prefix
    compositions within each chunk, the same scan over the C chunk
    carries, and the elementwise resolve against the backlog entering
    each chunk.
    """
    pa, pb = _scan(a.reshape(-1, c, l), b.reshape(-1, c, l))
    ca, cb = _scan(pa[:, :, -1], pb[:, :, -1])
    x_out = torch.maximum(ca, x_init[:, None] + cb)  # backlog leaving chunk k
    xc = torch.cat((x_init[:, None], x_out[:, :-1]), dim=1)
    d = torch.maximum(pa, xc[:, :, None] + pb)
    return d.reshape(a.shape)


def _elements(enqueue: np.ndarray, service: np.ndarray):
    """Host-side float32 (A, B) build from float64 columns.

    A, B, and the initial backlog are all *small* (services and gaps);
    the cast here is the only precision loss in the pass -- the absolute
    clock never enters a device tensor.
    """
    gaps = np.empty_like(enqueue)
    gaps[0] = 0.0
    np.subtract(enqueue[1:], enqueue[:-1], out=gaps[1:])
    return service.astype(np.float32), (service - gaps).astype(np.float32)


def _pad(arr: np.ndarray, size: int, fill) -> np.ndarray:
    if arr.shape[-1] == size:
        return arr
    out = np.full(arr.shape[:-1] + (size,), fill, dtype=arr.dtype)
    out[..., : arr.shape[-1]] = arr
    return out


def lindley_ends(
    enqueue: np.ndarray,
    service: np.ndarray,
    free0: float,
    device: "str | torch.device" = "cuda",
) -> np.ndarray:
    """FCFS completion times via the max-plus scan on ``device``.

    Drop-in for ``simulator._server_ends`` under the statistical contract:
    delays are float32, the absolute clock is restored in float64 on the
    host (``ends = tau + d``), padded tail lanes carry identity elements
    so real prefixes are unaffected.
    """
    dev = resolve_device(device)
    n = enqueue.size
    if n == 0:
        return np.empty(0)
    a, b = _elements(enqueue, service)
    c, l = _grid(n)
    a = torch.from_numpy(_pad(a, c * l, _NEG)[None]).to(dev)
    b = torch.from_numpy(_pad(b, c * l, np.float32(0.0))[None]).to(dev)
    x_init = torch.tensor([free0 - enqueue[0]], dtype=torch.float32, device=dev)
    d = _delays(a, b, x_init, c, l)[0, :n].cpu().numpy()
    return enqueue + d.astype(np.float64)


def _tpu_replicas(
    base: torch.Tensor,
    miss_load: torch.Tensor,
    g: torch.Tensor,
    tm: torch.Tensor,
    scales: torch.Tensor,
    x_init: torch.Tensor,
    c: int,
    l: int,
    n_models: int,
):
    """TPU stage for R replicas: service build + delays + per-model delay
    sums + busy time.  ``scales`` is ``[R, n_models]`` (per-model jitter --
    the ``Trace.service_scale`` semantics applied model-wise), everything
    else is one shared padded column.

    Dead lanes carry ``base = miss_load = g = 0`` and ``tm = n_models``.
    Torch raises on an index past the end (JAX clamps), so ``scales`` gains
    a zero column and the per-model sums run over ``n_models + 1`` bins,
    the last of which (the dead lanes') is dropped.  A dead lane's element
    ``f(x) = max(0, x)`` is not the semigroup identity, but dead lanes sit
    strictly *after* every real request, so no real prefix composes
    through one.  Sums accumulate in float64.
    """
    svc = base * F.pad(scales, (0, 1))[:, tm] + miss_load  # [R, P]
    d = _delays(svc, svc - g, x_init, c, l)
    sums = torch.zeros((d.shape[0], n_models + 1), dtype=torch.float64, device=d.device)
    sums.index_add_(1, tm, d.double())
    busy = svc.sum(dim=1, dtype=torch.float64)
    return d, sums[:, :n_models], busy


def _cpu_replicas(
    d_tpu: torch.Tensor,
    sel: torch.Tensor,
    g_host: torch.Tensor,
    svc: torch.Tensor,
    x0_host: float,
    c: int,
    l: int,
):
    """Single-core CPU-pool stage for one model across R replicas.

    The pool's enqueue column is ``t_in = ends[sel] + out_xfer``; only its
    *gap* structure matters, which splits into the shared host part
    (enqueue-time diffs) plus the replica-dependent part (TPU delay
    diffs) -- both small, both float32-safe.  ``svc`` is the replica's
    constant service ``s_cpu * scale_r`` (per-model jitter), ``x0_host``
    the shared part of the initial backlog ``-(enq[sel[0]] + out_xfer)``
    (an idle pool at t=0); the replica part is gathered on the device.
    """
    dsel = d_tpu[:, sel]  # [R, n_i]
    dd = torch.diff(dsel, dim=1, prepend=dsel[:, :1])
    g = g_host[None, :] + dd
    x_init = x0_host - dsel[:, 0]
    n_i = sel.shape[0]
    a = torch.full((dsel.shape[0], c * l), float(_NEG), device=dsel.device)
    a[:, :n_i] = svc[:, None]
    b = torch.zeros((dsel.shape[0], c * l), device=dsel.device)
    b[:, :n_i] = svc[:, None] - g
    d = _delays(a, b, x_init, c, l)[:, :n_i]
    return d, d.sum(dim=1, dtype=torch.float64)


@dataclasses.dataclass(frozen=True)
class ReplicaStats:
    """Per-replica summaries from ``TorchStepper.run_trace_replicas``.

    ``mean_latency[r, m]`` matches ``SimResult.mean_latency(m)`` of the
    NumPy stepper run on the same replica's trace to float32 tolerance;
    ``counts``/``misses`` are exact and shared across replicas (service
    jitter cannot change arrival order or the SRAM access sequence).
    """

    mean_latency: np.ndarray   # [R, n_models] float64
    counts: np.ndarray         # [n_models] int64
    misses: np.ndarray         # [n_models] int64
    tpu_busy: np.ndarray       # [R] float64


class TorchStepper(RuntimeSimulator):
    """``RuntimeSimulator`` with its Lindley recurrences on a torch device.

    Overrides exactly one hook -- ``_lindley`` -- so every other mechanism
    (scalar ``step`` fallback, deferred disciplines, SRAM replay, heap CPU
    pools, recording) is the parent's, behaviorally *and* textually.
    Integer observables are bitwise identical to the NumPy stepper; float
    observables agree to float32 tolerance.  ``device`` defaults to the
    GPU and raises without one unless ``"cpu"`` is asked for.
    """

    def __init__(self, profiles, plan, platform, *, faults=None, device: "str | torch.device" = "cuda"):
        self.device = resolve_device(device)
        super().__init__(profiles, plan, platform, faults=faults)

    def _lindley(
        self, enqueue: np.ndarray, service: np.ndarray, free0: float
    ) -> np.ndarray:
        return lindley_ends(enqueue, service, free0, device=self.device)

    def _put(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    # -- Monte-Carlo replica engine ---------------------------------------
    def run_trace_replicas(
        self, trace: Trace, scales: np.ndarray
    ) -> ReplicaStats:
        """Resolve ``R`` per-model service-jitter replicas of one trace.

        ``scales`` is ``[R, n_models]``: replica r scales every request of
        model m by ``scales[r, m]`` (measurement-uncertainty Monte Carlo
        over the profiled service times -- the ``Trace.service_scale``
        column ``scales[r, trace.model_idx]`` gives the identical model on
        the NumPy stepper, which is exactly what the equivalence self-
        check replays).  Requirements: a fresh simulator (no prior
        offers), FCFS discipline, unit-scale sorted trace, and k <= 1 CPU
        pools -- the regime where both stages are pure Lindley scans.  The
        arrival order, routing, enqueue clock, and SRAM miss pattern are
        replica-invariant and hoisted; only the busy-period scans and the
        summary reductions run per replica (in one device pass per stage).
        """
        scales = np.asarray(scales, dtype=np.float64)
        if scales.ndim != 2 or scales.shape[1] != self.n:
            raise ValueError("scales must be [n_replicas, n_models]")
        if self._disc is not None:
            raise ValueError("replica engine supports FCFS plans only")
        if any(len(pool) > 1 for pool in self._cpu_pools):
            raise ValueError("replica engine supports k<=1 CPU pools only")
        if self.tpu_free != 0.0 or self.tpu_busy != 0.0:
            raise ValueError("replica engine requires a fresh simulator")
        if not trace.is_sorted:
            raise ValueError("run_trace_replicas requires a sorted Trace")
        if not trace.scale_is_unit:
            raise ValueError(
                "per-request service_scale and per-model replica scales "
                "would compose ambiguously; pass a unit-scale trace"
            )
        n_req = len(trace)
        r_rep = scales.shape[0]
        m = trace.model_idx
        arr = trace.arrival
        has_tpu = self._part_arr > 0
        has_cpu = self._part_arr < self._points_arr

        counts = np.bincount(m, minlength=self.n)
        mean_lat = np.zeros((r_rep, self.n))
        misses_out = np.zeros(self.n, dtype=np.int64)
        busy = np.zeros(r_rep)
        if n_req == 0:
            return ReplicaStats(mean_lat, counts, misses_out, busy)

        # -- shared TPU-stage structure (replica-invariant) --------------
        if bool(has_tpu.all()):
            ti, tm = None, m
        else:
            ti = np.flatnonzero(has_tpu[m])
            tm = m[ti]
        d_tpu = None
        scales32 = scales.astype(np.float32)
        if tm.size:
            arr_t = arr if ti is None else arr[ti]
            enq = arr_t + self._in_xfer_arr[tm]
            last = np.full(self.n, -1, dtype=np.int64)
            last[tm] = np.arange(tm.size)
            first = np.full(self.n, -1, dtype=np.int64)
            first[tm[::-1]] = np.arange(tm.size - 1, -1, -1)
            miss, _ = self._replay_lru(tm, first, last)
            misses_out += np.bincount(tm[miss], minlength=self.n)

            gaps = np.empty_like(enq)
            gaps[0] = 0.0
            np.subtract(enq[1:], enq[:-1], out=gaps[1:])
            base = self._s_tpu_arr[tm].astype(np.float32)
            miss_load = np.where(miss, self._t_load_arr[tm], 0.0).astype(
                np.float32
            )
            c, l = _grid(tm.size)
            pad_n = c * l
            x_init = np.full(
                r_rep, 0.0 - enq[0], dtype=np.float32
            )
            d_tpu, sums, busy_dev = _tpu_replicas(
                self._put(_pad(base, pad_n, np.float32(0.0))),
                self._put(_pad(miss_load, pad_n, np.float32(0.0))),
                self._put(_pad(gaps.astype(np.float32), pad_n, np.float32(0.0))),
                self._put(_pad(tm.astype(np.int64), pad_n, np.int64(self.n))),
                self._put(scales32),
                self._put(x_init),
                c, l, self.n,
            )
            busy += busy_dev.cpu().numpy()
            # TPU-stage latency = in_xfer + delay (enqueue - arrival is
            # exactly the input transfer).
            sums_np = sums.cpu().numpy()
            tpu_counts = np.bincount(tm, minlength=self.n)
            nz = tpu_counts > 0
            mean_lat[:, nz] += (
                self._in_xfer_arr[nz][None, :]
                + sums_np[:, nz] / tpu_counts[nz][None, :]
            )

        # -- per-model single-core CPU pools ------------------------------
        for i in np.flatnonzero(has_cpu).tolist():
            if ti is None:
                sel = np.flatnonzero(m == i)
                sel_t = sel
            else:
                sel = np.flatnonzero(m == i)
                # Position of model i's requests inside the TPU trace (all
                # of model i is TPU-routed when has_tpu[i]).
                sel_t = np.flatnonzero(tm == i) if has_tpu[i] else None
            if sel.size == 0:
                continue
            svc_cpu = (self._s_cpu[i] * scales[:, i]).astype(np.float32)
            if has_tpu[i]:
                # t_in = enq[sel_t] + d[sel_t] + out_xfer: split gaps into
                # the shared enqueue part and the replica delay part.
                enq_i = enq[sel_t]
                g_host = np.empty_like(enq_i)
                g_host[0] = 0.0
                np.subtract(enq_i[1:], enq_i[:-1], out=g_host[1:])
                c2, l2 = _grid(sel_t.size)
                x0_host = float(np.float32(
                    0.0 - (enq_i[0] + self._out_eff_arr[i])
                ))
                _, cpu_sums = _cpu_replicas(
                    d_tpu,
                    self._put(sel_t.astype(np.int64)),
                    self._put(g_host.astype(np.float32)),
                    self._put(svc_cpu),
                    x0_host,
                    c2, l2,
                )
                # Total latency = in_xfer + d_tpu + out_xfer + d_cpu.
                mean_lat[:, i] += self._out_eff_arr[i] + cpu_sums.cpu().numpy() / sel.size
            else:
                # Full-CPU route: the pool's enqueue column is the arrival
                # itself, shared across replicas; its operands are built on
                # the host.
                arr_i = arr[sel]
                a32, b32 = _elements(arr_i, np.zeros(sel.size))
                c2, l2 = _grid(sel.size)
                pad_n = c2 * l2
                g_i = (a32 - b32)  # recovers the float32 gaps
                a_k = np.full((r_rep, pad_n), _NEG, dtype=np.float32)
                b_k = np.zeros((r_rep, pad_n), dtype=np.float32)
                a_k[:, : sel.size] = svc_cpu[:, None]
                b_k[:, : sel.size] = svc_cpu[:, None] - g_i[None, :]
                x0 = np.full(r_rep, 0.0 - arr_i[0], dtype=np.float32)
                d_cpu = _delays(
                    self._put(a_k), self._put(b_k), self._put(x0), c2, l2,
                )[:, : sel.size]
                mean_lat[:, i] += d_cpu.sum(dim=1, dtype=torch.float64).cpu().numpy() / sel.size

        return ReplicaStats(mean_lat, counts, misses_out, busy)
