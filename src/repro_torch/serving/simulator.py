"""Sequential per-request simulator of the SwapLess runtime.

Plays the role of the physical testbed in the paper's evaluation: the
analytic model *predicts* latency, the simulator *observes* it.  The
simulated system matches Section IV's runtime:

* a single global TPU worker with an FCFS queue (M/G/1 discipline),
* per-model CPU pools with ``k_i`` single-request workers (M/D/k),
* an explicit SRAM cache with model-granularity LRU eviction
  (ground truth for the paper's conservative alpha approximation),
* intra-model swap streaming folded into TPU service time,
* input/boundary transfer latencies that do not occupy either server
  (matching the additive d/B terms of Eq. 4).

``RuntimeSimulator`` is a *stepper*: it walks the trace in arrival order
and resolves each request's full timeline with ``max(t, server_free)``
recurrences.  Two execution paths share that definition:

* the scalar ``step``/``offer`` path, one pure-Python iteration per
  request -- the seed semantics and the differential reference;
* ``run_trace``, a vectorized fast path over a columnar ``Trace`` that
  resolves a whole constant-plan segment at once with the Lindley
  recurrence identity ``end = cumsum(s) + maximum.accumulate(arrival -
  shifted cumsum(s))`` plus a cheap exact sequential replay for SRAM miss
  accounting.  ``simulate()`` and ``run_adaptive()`` dispatch to it
  automatically between re-plan boundaries.  It is a *replay* of the
  scalar semantics, not a new model: every quantity matches the scalar
  path to float round-off (integer observables exactly), enforced by
  ``tests/test_sim_fastpath.py``.

The stepper shares structure with the analytic recurrences, so the
independent event-driven backend (``repro_torch.serving.des``) is the ground
truth the model is validated against; both implement the same driver
surface (``offer`` / ``advance_to`` / ``set_plan`` / ``drain`` /
``result``) over the shared ``Request`` trace and ``SimResult`` record,
and ``simulate(..., backend=...)`` / ``run_adaptive(..., backend=...)``
pick between them.
"""
from __future__ import annotations

import heapq
import itertools
import math
from typing import TYPE_CHECKING, Sequence

import numpy as np

from repro_torch.core.planner import (
    ModelProfile,
    Plan,
    route_tables,
    TenantSpec,
)
from repro_torch.hw.specs import Platform
from repro_torch.serving.cache import SramCache
from repro_torch.serving.faults import FaultStats, as_view
from repro_torch.serving.result import SimResult
from repro_torch.serving.scheduling import (
    FcfsDiscipline,
    WeightedFairDiscipline,
    make_discipline,
)
from repro_torch.serving.workload import Request, Trace

if TYPE_CHECKING:
    import torch

__all__ = ["RuntimeSimulator", "SimResult", "simulate", "make_backend"]


def _lindley_guess(enqueue: np.ndarray, service: np.ndarray, free0: float) -> np.ndarray:
    """Completion times of a single FCFS server via the Lindley identity.

    Unrolls ``end[j] = max(enqueue[j], end[j-1]) + service[j]`` (with the
    server initially free at ``free0``) into

        end = cumsum(service)
              + maximum.accumulate(enqueue - shifted_cumsum(service))

    where the initial free time folds into position 0 of the accumulate.
    Associativity differs from the scalar recurrence, so this agrees with
    it only to round-off -- it is the *guess* that classifies busy-period
    boundaries for the bit-exact ``_server_ends`` below.
    """
    cu = np.cumsum(service)
    shifted = np.empty_like(cu)
    shifted[0] = 0.0
    shifted[1:] = cu[:-1]
    d = enqueue - shifted
    if d[0] < free0:
        d[0] = free0
    return cu + np.maximum.accumulate(d)


def _segmented_ends(
    enqueue: np.ndarray,
    service: np.ndarray,
    free0: float,
    resets: np.ndarray,
) -> np.ndarray:
    """Server completion times given busy-period boundaries ``resets``.

    ``resets[j]`` asserts job ``j`` found the server idle (``enqueue[j] >=
    end[j-1]``), so its busy period restarts from ``enqueue[j]`` exactly and
    every later end in the period is the *left-to-right* float sum
    ``fl(...fl(fl(root + s_r) + s_r+1)... )`` -- the very association the
    scalar recurrence produces.  Busy periods are mutually independent, so
    they all resolve in parallel: segments are bucketed by power-of-two
    length and each bucket is one padded 2-D ``cumsum`` along rows (NumPy's
    ``accumulate`` is sequential, giving the exact association per row).
    Bitwise equal to the scalar stepper iff ``resets`` is classified as the
    scalar run would.
    """
    n = enqueue.size
    starts = np.flatnonzero(resets)
    roots = enqueue[starts].copy()
    if starts[0] == 0 and roots[0] < free0:
        roots[0] = free0  # max(enqueue[0], free0): selection, no arithmetic
    seg_len = np.empty(starts.size, dtype=np.int64)
    seg_len[:-1] = starts[1:] - starts[:-1]
    seg_len[-1] = n - starts[-1]
    ends = np.empty(n)
    bexp = np.ceil(np.log2(seg_len)).astype(np.int64)
    for b in range(int(bexp.max()) + 1):
        sel = np.flatnonzero(bexp == b)
        if not sel.size:
            continue
        r, l = starts[sel], seg_len[sel]
        if b == 0:
            ends[r] = roots[sel] + service[r]
            continue
        if b == 1:
            # Length-2 segments, the bulk at moderate load: two adds.
            e0 = roots[sel] + service[r]
            ends[r] = e0
            ends[r + 1] = e0 + service[r + 1]
            continue
        w = 1 << b
        cols = np.arange(w)
        idx = r[:, None] + cols[None, :]
        valid = cols[None, :] < l[:, None]
        mat = np.zeros((r.size, w + 1))
        mat[:, 0] = roots[sel]
        mat[:, 1:] = np.where(valid, service[np.where(valid, idx, 0)], 0.0)
        cs = np.cumsum(mat, axis=1)
        ends[idx[valid]] = cs[:, 1:][valid]
    return ends


def _server_ends(enqueue: np.ndarray, service: np.ndarray, free0: float) -> np.ndarray:
    """Completion times of a single FCFS server, vectorized *and* bit-exact.

    The scalar recurrence ``end[j] = max(enqueue[j], end[j-1]) + service[j]``
    only couples jobs within a busy period; across an idle gap the clock
    restarts from the enqueue time exactly.  So: guess the ends with the
    Lindley identity, classify busy-period boundaries from the guess,
    recompute each period with the scalar association (``_segmented_ends``),
    and re-check the classification against the recomputed ends.  A
    consistent fixpoint satisfies the scalar recurrence elementwise and is
    therefore *bitwise* the scalar result.  Misclassifications only occur
    where the guess's round-off straddles a near-tie, so the loop almost
    always exits on the first pass; a pathological non-converging tie chain
    falls back to the plain sequential recurrence.
    """
    ends = _lindley_guess(enqueue, service, free0)
    resets = np.empty(enqueue.size, dtype=bool)
    for _ in range(8):
        resets[0] = True
        np.greater_equal(enqueue[1:], ends[:-1], out=resets[1:])
        if resets.all():
            # Fully idle server (zero queueing): end = enqueue + service
            # elementwise, trivially consistent.
            ends = enqueue + service
            if enqueue[0] < free0:
                ends[0] = free0 + service[0]
            if np.array_equal(enqueue[1:] >= ends[:-1], resets[1:]):
                return ends
            continue
        ends = _segmented_ends(enqueue, service, free0, resets)
        if np.array_equal(enqueue[1:] >= ends[:-1], resets[1:]):
            return ends
    out = np.empty(enqueue.size)
    free = free0
    for j, (e, s) in enumerate(zip(enqueue.tolist(), service.tolist())):
        free = (e if e > free else free) + s
        out[j] = free
    return out


# Deferred-TPU job tuple of the discipline path (same field layout as the
# DES ``_J_*`` map; the two simulators never exchange jobs, but one layout
# keeps the mechanics recognizably parallel).
_DJ_MODEL = 0
_DJ_ARR = 1
_DJ_RECORD = 2
_DJ_TPU_S = 3
_DJ_CPU_S = 4
_DJ_OUT_X = 5
_DJ_PBYTES = 6
_DJ_TLOAD = 7
_DJ_SUFFIX = 8


class RuntimeSimulator:
    """Steppable two-stage (TPU -> CPU) system over profiled tenants.

    The TPU queue runs under ``plan.discipline``: with the default FCFS the
    seed scalar ``step`` path resolves each request fully at arrival (queue
    order == arrival order, so no queue state is needed); any other
    discipline defers TPU service decisions through a pending queue
    (``repro_torch.serving.scheduling``) that is drained as the offered clock
    advances -- see ``_advance_tpu``.
    """

    def __init__(
        self,
        profiles: Sequence[ModelProfile],
        plan: Plan,
        platform: Platform,
        *,
        faults=None,
    ):
        self.profiles = list(profiles)
        self.platform = platform
        self.n = len(self.profiles)
        self.cache = SramCache(platform.sram_bytes)
        self.tpu_free = 0.0
        self.tpu_busy = 0.0
        self.last_completion = 0.0
        self.latencies: list[list[float]] = [[] for _ in range(self.n)]
        self.arrivals: list[list[float]] = [[] for _ in range(self.n)]
        self.misses = [0] * self.n
        self.tpu_requests = [0] * self.n
        self._plan: Plan | None = None
        self._cpu_pools: list[list[float]] = [[0.0] for _ in range(self.n)]
        # Non-FCFS discipline state (all dormant under the default FCFS,
        # whose scalar/vectorized paths stay bitwise-pinned):
        self._disc = None                     # scheduling.Discipline | None
        self._wf: WeightedFairDiscipline | None = None
        self._tpu_arrivals: list[tuple] = []  # (enqueue_t, seq, job) heap
        self._arr_seq = itertools.count()
        self._run_model: int | None = None
        self._run_len = 0
        # Fault injection (serving.faults): a trivial view (no windows)
        # normalizes to None so an empty schedule takes the exact pre-fault
        # code paths, and faults=None stays bitwise the pre-fault simulator.
        fv = as_view(faults)
        self._faults = fv if fv is not None and fv.has_faults else None
        self._fault_lost = [0] * self.n
        self._fault_requeued = [0] * self.n
        self.set_plan(plan, now=0.0)

    # -- plan management ----------------------------------------------------
    def set_plan(self, plan: Plan, now: float) -> None:
        """Switch to a new (P, K) configuration at time ``now``.

        CPU pools are resized preserving the most-loaded workers' busy
        horizons (a worker mid-request finishes its request).  The paper
        preloads candidate partitions so switching cost is negligible; we
        model it as free.
        """
        if len(plan.partition) != self.n:
            raise ValueError("plan size mismatch")
        old = self._plan
        if self._disc is not None:
            # Resolve TPU decisions up to the switch instant so queued work
            # bound under the old plan is ordered before the change.
            self._advance_tpu(now)
        if old is None or plan.discipline != old.discipline:
            if self._disc is None:
                # FCFS -> non-FCFS (or the initial install): the scalar path
                # leaves nothing pending, so no migration is needed.
                self._disc = make_discipline(plan.discipline, self.n)
            else:
                # Between discipline objects, queued jobs migrate in global
                # enqueue order.  A switch back to FCFS keeps the deferred
                # machinery (as an FcfsDiscipline) -- the scalar fast path
                # cannot absorb already-queued jobs, and mixed-discipline
                # runs are outside the bitwise-pinned FCFS contract anyway.
                new = make_discipline(plan.discipline, self.n) or FcfsDiscipline(
                    plan.discipline, self.n
                )
                for _, t, job in self._disc.drain_rows():
                    new.push(job, t)
                self._disc = new
            self._wf = (
                self._disc
                if isinstance(self._disc, WeightedFairDiscipline)
                else None
            )
        if self._disc is not None and self._faults is not None:
            # Fault gates are defined on the scalar FCFS recurrence (and
            # mirrored by the DES); composing them with deferred-discipline
            # service orders is unspecified, so refuse loudly.
            raise ValueError(
                "fault injection supports the FCFS discipline only"
            )
        self._plan = plan
        self._derive(plan)
        new_pools: list[list[float]] = []
        for i, k in enumerate(plan.cores):
            size = max(k, 1)
            prev = self._cpu_pools[i] if old is not None else [now]
            busy = sorted(prev, reverse=True)[:size]
            while len(busy) < size:
                busy.append(now)
            heapq.heapify(busy)
            new_pools.append(busy)
        self._cpu_pools = new_pools

    def _derive(self, plan: Plan) -> None:
        pf = self.profiles
        p = plan.partition
        rt = route_tables(pf, plan, self.platform)
        self._prefix_bytes = rt.prefix_bytes
        self._s_tpu = rt.s_tpu
        self._t_load = rt.t_load
        self._s_cpu = rt.s_cpu
        self._in_xfer = rt.in_xfer
        self._out_xfer = rt.out_xfer
        # Columnar mirrors of the per-model tables for the vectorized path
        # (same float values -- np.array of python floats is exact).
        self._part_arr = np.array(p, dtype=np.int64)
        self._points_arr = np.array(
            [f.num_partition_points for f in pf], dtype=np.int64
        )
        self._s_tpu_arr = np.array(self._s_tpu)
        self._t_load_arr = np.array(self._t_load)
        self._in_xfer_arr = np.array(self._in_xfer)
        self._out_xfer_arr = np.array(self._out_xfer)
        # Boundary transfer charged only on split routes (0 < p < P); a
        # masked copy lets the fast path add it unconditionally (x + 0.0
        # is exact) instead of scattering through boolean masks.
        self._out_eff_arr = np.where(
            (self._part_arr > 0) & (self._part_arr < self._points_arr),
            self._out_xfer_arr,
            0.0,
        )
        self._want = [
            min(b, self.cache.capacity) for b in self._prefix_bytes
        ]

    @property
    def plan(self) -> Plan:
        assert self._plan is not None
        return self._plan

    # -- event processing ---------------------------------------------------
    def step(self, req: Request, *, record: bool = True) -> float:
        """Process one request; returns its end-to-end latency (s).

        FCFS only: the scalar recurrence resolves each request fully at
        arrival, which is exactly the property non-FCFS disciplines give
        up.  Under a non-default ``plan.discipline`` drive the simulator
        through ``offer``/``advance_to``/``drain`` instead.
        """
        if self._disc is not None:
            raise ValueError(
                "step() resolves a request at arrival; non-FCFS disciplines "
                "defer service order -- drive via offer()/advance_to()/drain()"
            )
        if self._faults is not None:
            return self._step_faulted(req, record)
        i = req.model_idx
        p = self.plan.partition[i]
        P_i = self.profiles[i].num_partition_points
        t = req.arrival
        if p > 0:
            t += self._in_xfer[i]
            start = max(t, self.tpu_free)
            miss = self.cache.access(i, self._prefix_bytes[i], start)
            service = self._s_tpu[i] * req.service_scale + (
                self._t_load[i] if miss else 0.0
            )
            self.tpu_free = start + service
            self.tpu_busy += service
            t = self.tpu_free
            if record:
                self.tpu_requests[i] += 1
                if miss:
                    self.misses[i] += 1
            if p < P_i:
                t += self._out_xfer[i]
        if p < P_i:
            pool = self._cpu_pools[i]
            free = heapq.heappop(pool)
            start = max(t, free)
            end = start + self._s_cpu[i] * req.service_scale
            heapq.heappush(pool, end)
            t = end
        self.last_completion = max(self.last_completion, t)
        lat = t - req.arrival
        if record:
            self.latencies[i].append(lat)
            self.arrivals[i].append(req.arrival)
        return lat

    def _step_faulted(self, req: Request, record: bool) -> float:
        """Scalar ``step`` with the device-fault gates applied.

        The fault semantics live in ``serving.faults``: the dropout gate
        fires at the arrival instant and again at each service start
        (requeue defers to the recovery instant; lost drops and counts,
        leaving server state untouched); speed factors bind at the instant
        each service or transfer begins.  The DES applies the same gates at
        the same instants with the same float ops, so DES == stepper stays
        elementwise under any schedule (``tests/test_faults.py``).  Returns
        ``nan`` for a lost request.
        """
        fv = self._faults
        i = req.model_idx
        p = self.plan.partition[i]
        P_i = self.profiles[i].num_partition_points
        t = req.arrival
        if fv.is_down(t):
            if fv.lost:
                if record:
                    self._fault_lost[i] += 1
                return math.nan
            t = fv.down_until(t)
            if record:
                self._fault_requeued[i] += 1
        if p > 0:
            t += self._in_xfer[i] / fv.swap_factor(t)
            start = max(t, self.tpu_free)
            if fv.is_down(start):
                if fv.lost:
                    if record:
                        self._fault_lost[i] += 1
                    return math.nan
                start = fv.down_until(start)
                if record:
                    self._fault_requeued[i] += 1
            miss = self.cache.access(i, self._prefix_bytes[i], start)
            service = self._s_tpu[i] * req.service_scale / fv.tpu_factor(start)
            if miss:
                service += self._t_load[i] / fv.swap_factor(start)
            self.tpu_free = start + service
            self.tpu_busy += service
            t = self.tpu_free
            if record:
                self.tpu_requests[i] += 1
                if miss:
                    self.misses[i] += 1
            if p < P_i:
                t += self._out_xfer[i] / fv.swap_factor(self.tpu_free)
        if p < P_i:
            pool = self._cpu_pools[i]
            free = heapq.heappop(pool)
            start = max(t, free)
            if fv.is_down(start):
                if fv.lost:
                    heapq.heappush(pool, free)
                    if record:
                        self._fault_lost[i] += 1
                    return math.nan
                start = fv.down_until(start)
                if record:
                    self._fault_requeued[i] += 1
            end = start + self._s_cpu[i] * req.service_scale / fv.cpu_factor(start)
            heapq.heappush(pool, end)
            t = end
        self.last_completion = max(self.last_completion, t)
        lat = t - req.arrival
        if record:
            self.latencies[i].append(lat)
            self.arrivals[i].append(req.arrival)
        return lat

    # -- deferred TPU machinery (non-FCFS disciplines) -----------------------
    def _offer_deferred(self, req: Request, record: bool) -> None:
        """Discipline-path ``offer``: bind the route at arrival, defer the
        TPU service decision to ``_advance_tpu``.

        Full-CPU routes resolve immediately (they never touch the TPU and
        per-model pools see them in arrival order either way); TPU-bound
        jobs enter a future-enqueue heap keyed by ``arrival + input_xfer``
        so the discipline queue receives them in enqueue-time order exactly
        as the DES's enqueue events fire.
        """
        i = req.model_idx
        p = self.plan.partition[i]
        suffix = p < self.profiles[i].num_partition_points
        if p > 0:
            enq = req.arrival + self._in_xfer[i]
            # Advance only to the *arrival*: it lower-bounds every future
            # enqueue (offers come in arrival order and input transfers are
            # non-negative), so no decision is finalized before a job the
            # DES would already have queued.  Advancing to this job's own
            # enqueue time would over-run it whenever another model's
            # smaller input transfer lands an enqueue inside (arrival, enq].
            self._advance_tpu(req.arrival)
            job = (
                i,
                req.arrival,
                record,
                self._s_tpu[i] * req.service_scale,
                self._s_cpu[i] * req.service_scale,
                self._out_xfer[i] if suffix else 0.0,
                self._prefix_bytes[i],
                self._t_load[i],
                suffix,
            )
            heapq.heappush(self._tpu_arrivals, (enq, next(self._arr_seq), job))
            return
        self._advance_tpu(req.arrival)
        pool = self._cpu_pools[i]
        free = heapq.heappop(pool)
        start = max(req.arrival, free)
        end = start + self._s_cpu[i] * req.service_scale
        heapq.heappush(pool, end)
        self.last_completion = max(self.last_completion, end)
        if record:
            self.latencies[i].append(end - req.arrival)
            self.arrivals[i].append(req.arrival)

    def _advance_tpu(self, until: float) -> None:
        """Resolve every TPU service decision at or before time ``until``.

        Replays the DES event interleaving with two pending structures: the
        future-enqueue heap (jobs still in input transfer) and the
        discipline queue (jobs waiting for the server).  The server is busy
        exactly through ``tpu_free`` whenever the discipline queue is
        nonempty -- jobs only queue behind a busy server -- so the next
        decision is either ingesting the earliest future enqueue (when it
        lands at or before the completion) or letting the discipline pick
        at the completion instant.  Exact ties between an enqueue and a
        completion resolve enqueue-first here, where the DES orders them by
        event sequence; like FCFS multi-tenant tie order, that difference
        is legitimate between the two backends (ROADMAP "DES is ground
        truth").
        """
        disc = self._disc
        heap = self._tpu_arrivals
        while True:
            next_enq = heap[0][0] if heap else math.inf
            if len(disc):
                if next_enq <= self.tpu_free:
                    if next_enq > until:
                        return
                    enq_t, _, job = heapq.heappop(heap)
                    disc.push(job, enq_t)
                    continue
                if self.tpu_free > until:
                    return
                job = disc.pop(self.tpu_free, self._run_model, self._run_len)
                self._begin_tpu_job(job, self.tpu_free)
                continue
            if not heap or next_enq > until:
                return
            enq_t, _, job = heapq.heappop(heap)
            if enq_t >= self.tpu_free:
                # Idle server: work-conserving start, no discipline choice.
                self._begin_tpu_job(job, enq_t)
            else:
                disc.push(job, enq_t)

    def _begin_tpu_job(self, job: tuple, start: float) -> None:
        """Serve one TPU job at ``start`` and resolve its full timeline
        (same per-request float ops as the scalar ``step`` TPU/CPU path)."""
        i = job[_DJ_MODEL]
        if i == self._run_model:
            self._run_len += 1
        else:
            self._run_model = i
            self._run_len = 1
        miss = self.cache.access(i, job[_DJ_PBYTES], start)
        service = job[_DJ_TPU_S] + (job[_DJ_TLOAD] if miss else 0.0)
        self.tpu_free = start + service
        self.tpu_busy += service
        if self._wf is not None:
            self._wf.charge(i, service)
        if job[_DJ_RECORD]:
            self.tpu_requests[i] += 1
            if miss:
                self.misses[i] += 1
        t = self.tpu_free
        if job[_DJ_SUFFIX]:
            t += job[_DJ_OUT_X]
            pool = self._cpu_pools[i]
            free = heapq.heappop(pool)
            start_c = max(t, free)
            end = start_c + job[_DJ_CPU_S]
            heapq.heappush(pool, end)
            t = end
        self.last_completion = max(self.last_completion, t)
        if job[_DJ_RECORD]:
            self.latencies[i].append(t - job[_DJ_ARR])
            self.arrivals[i].append(job[_DJ_ARR])

    # -- vectorized fast path -----------------------------------------------
    def _lindley(
        self, enqueue: np.ndarray, service: np.ndarray, free0: float
    ) -> np.ndarray:
        """Single-server FCFS completion times for one constant-plan span.

        The one recurrence hook backends may re-implement: the NumPy
        stepper uses the exact ``_server_ends`` fixpoint (bitwise-pinned
        reference); ``serving.torch_stepper.TorchStepper`` overrides it with
        a float32 max-plus scan on the device under the statistical-equivalence
        contract.  Everything else in ``run_trace`` is shared.
        """
        return _server_ends(enqueue, service, free0)

    def _replay_lru(
        self, tm: np.ndarray, first: np.ndarray, last: np.ndarray
    ) -> tuple[np.ndarray, list[tuple[int, int]]]:
        """Exact SRAM miss accounting for a TPU access sequence.

        Misses depend only on the *order* of accesses (LRU recency order
        equals processing order: TPU starts are strictly increasing), never
        on the clock, so they resolve before the Lindley pass.  ``first`` /
        ``last`` map each model to its first/last position in ``tm`` (-1
        when absent).  Returns the per-access miss flags plus the final
        ``(model, bytes)`` residency in recency order; the caller stamps
        ``last_used`` from the computed start times and restores the cache.

        Two regimes:
        * *no possible eviction* (worst-case residency fits capacity): a
          model can miss only on its first access -- fully vectorized;
        * otherwise an O(#tenant-switches) run-compressed LRU replay
          (within a run of one model only the first access can miss).
        """
        cap = self.cache.capacity
        want = self._want
        old_state = self.cache.state()
        old_bytes = {m: b for m, b, _ in old_state}
        miss = np.zeros(tm.size, dtype=bool)

        first_l = first.tolist()
        accessed = [g for g, f in enumerate(first_l) if f >= 0]
        grow = sum(max(0, want[g] - old_bytes.get(g, 0)) for g in accessed)
        if self.cache.used + grow <= cap:
            # No eviction can occur: first-touch misses only.
            miss[[f for g, f in enumerate(first_l)
                  if f >= 0 and old_bytes.get(g, -1) < want[g]]] = True
            # Recency: untouched entries keep their order, accessed models
            # move to the back ordered by last occurrence.
            by_last = sorted((last[g], g) for g in accessed)
            accessed_set = set(accessed)
            order = [
                (g, b) for g, b, _ in old_state if g not in accessed_set
            ] + [
                (g, max(old_bytes.get(g, 0), want[g])) for _, g in by_last
            ]
            return miss, order

        # General LRU replay over tenant-switch points.
        runs = np.flatnonzero(
            np.concatenate(([True], tm[1:] != tm[:-1]))
        )
        od: dict[int, int] = {m: b for m, b, _ in old_state}
        od_get, od_pop = od.get, od.pop
        used = self.cache.used
        miss_at: list[int] = []
        append = miss_at.append
        for pos, g in zip(runs.tolist(), tm[runs].tolist()):
            w = want[g]
            b = od_get(g)
            if b is not None and b >= w:
                del od[g]          # move-to-end: dict keeps insertion order
                od[g] = b
                continue
            append(pos)
            if b is not None:
                del od[g]
                used -= b
            while used + w > cap and od:
                used -= od_pop(next(iter(od)))
            od[g] = w
            used += w
        miss[miss_at] = True
        return miss, list(od.items())

    def run_trace(self, trace: Trace, *, record_from: float = 0.0) -> None:
        """Resolve a whole arrival-sorted, constant-plan trace segment.

        Semantically identical to ``for r in trace: self.offer(r,
        record=r.arrival >= record_from)`` -- same state evolution, same
        recorded observations -- but vectorized: the TPU stage is one
        exact Lindley pass over the merged trace (``_server_ends``), SRAM
        misses replay exactly from access order alone, and each CPU pool
        resolves per model (the same exact Lindley for one core; the scalar
        heap recurrence, op-for-op, for multi-core pools, whose service
        order depends on the heap state).  Every float observable is
        *bitwise* identical to the scalar path except the aggregate
        ``tpu_busy`` (pairwise vs sequential summation, equal to round-off).
        """
        n_req = len(trace)
        if n_req == 0:
            return
        if not trace.is_sorted:
            # Same misuse the scalar driver surfaces per request; an
            # unsorted trace would silently corrupt the Lindley order and
            # the searchsorted warmup boundary.  O(1) for generator traces.
            raise ValueError("run_trace requires an arrival-sorted Trace")
        if self._disc is not None or self._faults is not None:
            # Non-FCFS disciplines defer service decisions, which the
            # Lindley identity (strict FCFS order) cannot express; a fault
            # schedule makes service times depend on each request's start
            # instant, which the identity likewise cannot see.  Both fall
            # back transparently to the scalar reference loop -- same
            # observables, scalar speed.  Default FCFS with faults=None
            # keeps the vectorized path below.
            for r in trace:
                self.offer(r, record=r.arrival >= record_from)
            return
        m = trace.model_idx
        arr = trace.arrival
        sc = trace.service_scale
        unit = trace.scale_is_unit
        has_tpu = self._part_arr > 0
        has_cpu = self._part_arr < self._points_arr
        # Arrival-sorted segment: the record predicate (arrival >=
        # record_from) is a suffix starting at k0 -- no boolean mask needed.
        k0 = int(np.searchsorted(arr, record_from, side="left"))

        all_tpu = bool(has_tpu.all())
        any_cpu = bool(has_cpu.any())
        if all_tpu:
            ti, tm, arr_t = None, m, arr
            kt = k0
        else:
            ti = np.flatnonzero(has_tpu[m])
            tm, arr_t = m[ti], arr[ti]
            kt = int(np.searchsorted(ti, k0, side="left"))

        if all_tpu and not any_cpu:
            completion = None  # pure-TPU segment: completion == ends
        else:
            completion = arr.copy()  # p==0 models enqueue to CPU at arrival

        if tm.size:
            enq = arr_t + self._in_xfer_arr[tm]
            # First/last occurrence per model via scatter (last write wins):
            # O(n), no sort.
            last = np.full(self.n, -1, dtype=np.int64)
            last[tm] = np.arange(tm.size)
            first = np.full(self.n, -1, dtype=np.int64)
            first[tm[::-1]] = np.arange(tm.size - 1, -1, -1)
            miss, residency = self._replay_lru(tm, first, last)
            any_miss = bool(miss.any())
            if unit:
                service = self._s_tpu_arr[tm]  # fancy index -> fresh array
            elif ti is None:
                service = self._s_tpu_arr[tm] * sc
            else:
                service = self._s_tpu_arr[tm] * sc[ti]
            if any_miss:
                mi = np.flatnonzero(miss)
                service[mi] += self._t_load_arr[tm[mi]]
            free0 = self.tpu_free
            ends = self._lindley(enq, service, free0)
            # Cache handoff: each accessed model's last_used is the start of
            # its last access; untouched residents keep their old stamps.
            old_stamp = {g: lu for g, _, lu in self.cache.state()}
            last_l = last.tolist()
            rows = []
            for g, b in residency:
                j = last_l[g]
                if j >= 0:
                    prev = ends[j - 1] if j else free0
                    e = enq[j]
                    stamp = float(e if e >= prev else prev)
                else:
                    stamp = old_stamp.get(g, 0.0)
                rows.append((g, b, stamp))
            self.cache.restore(rows)
            self.tpu_free = float(ends[-1])
            self.tpu_busy += float(service.sum())
            rec_tm = tm[kt:]
            for i, c in enumerate(np.bincount(rec_tm, minlength=self.n)):
                self.tpu_requests[i] += int(c)
            if any_miss:
                for i, c in enumerate(
                    np.bincount(rec_tm[miss[kt:]], minlength=self.n)
                ):
                    self.misses[i] += int(c)
            if completion is None:
                completion = ends
            elif ti is None:
                completion = ends + self._out_eff_arr[tm]
            else:
                completion[ti] = ends + self._out_eff_arr[tm]

        if any_cpu:
            for i in np.flatnonzero(has_cpu).tolist():
                sel = np.flatnonzero(m == i)
                if sel.size == 0:
                    continue
                t_in = completion[sel]
                svc = (
                    np.full(sel.size, self._s_cpu[i])
                    if unit
                    else self._s_cpu[i] * sc[sel]
                )
                pool = self._cpu_pools[i]
                if len(pool) == 1:
                    ends_c = self._lindley(t_in, svc, pool[0])
                    pool[0] = float(ends_c[-1])
                else:
                    # Multi-server FCFS: replay the scalar heap ops exactly.
                    ends_l: list[float] = []
                    push, pop = heapq.heappush, heapq.heappop
                    for t, s in zip(t_in.tolist(), svc.tolist()):
                        free = pop(pool)
                        end = (t if t > free else free) + s
                        push(pool, end)
                        ends_l.append(end)
                    ends_c = np.array(ends_l)
                completion[sel] = ends_c

        self.last_completion = max(
            self.last_completion, float(completion.max())
        )
        # Record columnar chunks; result() flattens them (tolist-ing a
        # million floats into Python lists would dominate the whole pass).
        if k0 < n_req:
            lat_r = completion[k0:] - arr[k0:]
            arr_r = arr[k0:]
            if self.n == 1:
                self.latencies[0].append(lat_r)
                self.arrivals[0].append(arr_r)
            else:
                m_r = m[k0:]
                for i in range(self.n):
                    keep = m_r == i
                    if keep.any():
                        self.latencies[i].append(lat_r[keep])
                        self.arrivals[i].append(arr_r[keep])

    # -- shared driver surface (see repro_torch.serving.des) -----------------
    def offer(self, req: Request, *, record: bool = True) -> None:
        """Driver-contract entry: requests must be offered in arrival order.

        Under FCFS this is an alias of ``step`` (each request resolves
        fully on arrival); under a non-FCFS discipline the TPU decision is
        deferred to the pending-queue machinery.
        """
        if self._disc is None:
            self.step(req, record=record)
        else:
            self._offer_deferred(req, record)

    def advance_to(self, t: float) -> None:
        """Resolve deferred TPU decisions up to ``t`` (no-op under FCFS,
        where the stepper has no pending events between requests)."""
        if self._disc is not None:
            self._advance_tpu(t)

    def drain(self) -> float:
        """Run any deferred TPU work dry; reports the last completion
        (under FCFS nothing is ever in flight between steps)."""
        if self._disc is not None:
            self._advance_tpu(math.inf)
        return self.last_completion

    def result(self, duration: float) -> SimResult:
        return SimResult(
            latencies=[_flat(ls) for ls in self.latencies],
            arrivals=[_flat(a) for a in self.arrivals],
            tpu_busy=self.tpu_busy,
            duration=duration,
            misses=self.misses,
            tpu_requests=self.tpu_requests,
            fault=self._fault_stats(),
        )

    def _fault_stats(self) -> "FaultStats | None":
        if self._faults is None:
            return None
        return FaultStats(
            lost=list(self._fault_lost),
            requeued=list(self._fault_requeued),
            down_windows=self._faults.down_windows,
            degraded_windows=self._faults.degraded_windows,
        )


def _flat(parts: list):
    """Flatten mixed scalar/chunk observation storage.

    The scalar path appends floats, ``run_trace`` appends NumPy chunks;
    pure-scalar lists pass through untouched (the seed's live-list
    behavior), anything chunked concatenates to one float64 array.
    """
    if not any(isinstance(p, np.ndarray) for p in parts):
        return parts
    return np.concatenate(
        [p if isinstance(p, np.ndarray) else np.array([p]) for p in parts]
    )


def _stepper_factory(profiles, plan, platform, faults=None, device=None):
    return RuntimeSimulator(profiles, plan, platform, faults=faults)


def _torch_factory(profiles, plan, platform, faults=None, device="cuda"):
    # Local import: the host backends must not pay the device stepper's
    # import unless the caller opted in.
    from repro_torch.serving.torch_stepper import TorchStepper

    return TorchStepper(profiles, plan, platform, faults=faults, device=device)


def _des_factory(profiles, plan, platform, faults=None, device=None):
    # Local import: des.py imports the shared result/workload modules
    # only, so the dependency stays one-way at module-load time.
    from repro_torch.serving.des import DiscreteEventSimulator

    return DiscreteEventSimulator(profiles, plan, platform, faults=faults)


# Name -> lazy constructor.  The registry is the single source of truth for
# what `backend=` accepts everywhere (simulate / run_adaptive / the fleet
# layer); the error path lists its keys so a typo names every valid choice.
_BACKENDS = {
    "stepper": _stepper_factory,
    "des": _des_factory,
    "torch": _torch_factory,
}


def make_backend(
    backend: str,
    profiles: Sequence[ModelProfile],
    plan: Plan,
    platform: Platform,
    *,
    faults=None,
    device: "str | torch.device" = "cuda",
):
    """Instantiate a serving-simulation backend by name.

    ``"stepper"`` is the sequential ``RuntimeSimulator``; ``"des"`` the
    event-driven ``DiscreteEventSimulator`` (the validation ground truth);
    ``"torch"`` the ``TorchStepper`` -- the stepper with its Lindley
    recurrences evaluated on ``device`` (float32, statistically equivalent,
    opt-in).  Only ``"torch"`` reads ``device``: the host backends need no
    card, and nothing imports the device stepper unless asked for.
    """
    try:
        factory = _BACKENDS[backend]
    except KeyError:
        valid = ", ".join(repr(k) for k in _BACKENDS)
        raise ValueError(
            f"unknown backend {backend!r}: valid backends are {valid}"
        ) from None
    return factory(profiles, plan, platform, faults=faults, device=device)


def ensure_sorted(requests: "Trace | Sequence[Request]"):
    """The trace in arrival order, skipping the copy when already sorted.

    Every generator returns sorted traces (``Trace`` carries the flag, so
    the check is O(1)); ``Request`` sequences are verified linearly --
    cheaper than the unconditional ``sorted()`` copy either way.
    """
    if isinstance(requests, Trace):
        return requests.sorted_by_arrival()
    if all(a.arrival <= b.arrival for a, b in zip(requests, requests[1:])):
        return requests
    return sorted(requests, key=lambda r: r.arrival)


def sorted_trace_and_horizon(requests: "Trace | Sequence[Request]"):
    """``(arrival-sorted trace, last arrival time)`` -- the shared preamble
    of ``simulate`` and ``run_adaptive`` (the horizon anchors the warmup
    cutoff and the minimum reported duration; 0.0 for an empty trace)."""
    reqs = ensure_sorted(requests)
    if not len(reqs):
        return reqs, 0.0
    if isinstance(reqs, Trace):
        return reqs, float(reqs.arrival[-1])
    return reqs, reqs[-1].arrival


def simulate(
    tenants: Sequence[TenantSpec],
    plan: Plan,
    platform: Platform,
    requests: "Trace | Sequence[Request]",
    *,
    warmup_frac: float = 0.05,
    backend: str = "stepper",
    vectorize: bool = True,
    faults=None,
    device: "str | torch.device" = "cuda",
) -> SimResult:
    """Run a static-plan simulation over a request trace.

    ``warmup_frac``: leading fraction of the trace excluded from statistics
    (cold-start cache fills; the paper measures steady state).
    ``backend``: ``"stepper"`` (default), ``"des"`` or ``"torch"`` -- same
    contract, independent mechanics; ``device`` is where ``"torch"`` runs.
    ``vectorize``: with a columnar ``Trace``, resolve the whole trace through
    the fast driver -- the vectorized ``run_trace`` on the stepper, the
    inlined columnar ``offer_trace`` on the DES (default); ``False`` forces
    the scalar per-request reference path.
    ``faults``: optional ``serving.faults`` schedule/view injected into the
    backend (dropout / throttle / swap degradation; forces the scalar path);
    the ``None`` default is bitwise the pre-fault simulator.
    """
    sim = make_backend(
        backend, [t.profile for t in tenants], plan, platform, faults=faults,
        device=device,
    )
    reqs, horizon = sorted_trace_and_horizon(requests)
    warmup_t = horizon * warmup_frac
    if vectorize and isinstance(reqs, Trace):
        if backend in ("stepper", "torch"):
            sim.run_trace(reqs, record_from=warmup_t)
        else:
            sim.offer_trace(reqs, record_from=warmup_t)
    else:
        for req in reqs:
            sim.offer(req, record=req.arrival >= warmup_t)
    # Duration runs to the last completion, not the last arrival: under
    # backlog the servers keep draining after arrivals stop, and clipping
    # the horizon at the last arrival let tpu_utilization exceed 1.0.
    return sim.result(max(horizon, sim.drain()))
