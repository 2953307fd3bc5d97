"""Event-driven ground-truth simulator of the SwapLess runtime.

The sequential ``RuntimeSimulator`` stepper shares most of its structure with
the analytic model it is supposed to validate (it literally walks requests
through ``max(t, server_free)`` recurrences).  This module is the
independent check: a classic discrete-event simulation with

* an event heap ordered by (time, insertion sequence),
* one TPU server with explicit swap state -- parameter residency tracked by
  the model-granularity LRU ``SramCache``, the inter-model swap-in cost
  ``T_load`` charged at service start when the tenant switch evicted the
  weights, intra-model swap streaming folded into the bound service time,
* ``k_i`` CPU-core servers per model under the active ``Plan``,
* global FCFS in front of the TPU and a per-tenant FIFO in front of each
  CPU pool,
* mid-flight plan changes: ``set_plan`` re-routes *future* arrivals while
  queued and in-service work bound under the old plan drains unchanged.

The DES and the stepper implement the same system contract (same
``Request`` traces in, same ``SimResult`` out) with disjoint mechanics, so
agreement between them -- and between either and Eq. 1-5 -- is evidence,
not tautology.  ``tests/test_des.py`` pins the correspondence:
deterministic single-tenant latencies match the closed-form static terms to
float round-off, and seeded Poisson waits converge to ``mg1_wait``.

Hot-loop notes (the optimization pass measured by
``benchmarks/sim_throughput.py`` and pinned bit-identical to the frozen
pre-optimization snapshot in ``benchmarks/des_baseline.py``):

* swap costs (``prefix_weight_bytes`` / ``load_time``) bind onto the job at
  arrival instead of being recomputed from the profile on every TPU start;
* jobs are plain tuples (see the ``_J_*`` field map): with routing bound at
  arrival no field ever mutates, and tuple construction/indexing beats a
  record class in the loop that runs once per event;
* events carry their *handler* (bound method) instead of a kind tag --
  the (time, seq) prefix alone orders the heap, so the handler slot is
  never compared;
* the TPU ready queue is a single global FIFO deque.  Jobs enter it in
  nondecreasing (event time, event sequence) order -- the heap pops events
  in that order and the enqueue stamp a job would carry is assigned at that
  very moment -- so popping the front IS the "earliest-enqueued head across
  per-tenant FIFOs" selection the baseline computed with an O(n_tenants)
  scan, for exactly the same job;
* ``offer`` inlines the arrival: ``advance_to(arrival)`` has already
  drained every event at or before that instant, so dispatching the arrival
  directly equals pushing-then-immediately-popping it (one heap round-trip
  saved per request).
"""
from __future__ import annotations

import collections
import heapq
import itertools
from typing import Sequence

from repro_torch.core.planner import (
    ModelProfile,
    Plan,
    route_tables,
)
from repro_torch.hw.specs import Platform
from repro_torch.serving.cache import SramCache
from repro_torch.serving.faults import FaultStats, as_view
from repro_torch.serving.result import SimResult
from repro_torch.serving.scheduling import WeightedFairDiscipline, make_discipline
from repro_torch.serving.workload import Request

_heappush = heapq.heappush
_heappop = heapq.heappop

# _Job tuple field map: one request in flight, route bound at arrival time.
# (Plain tuple, not a class: nothing mutates after binding, and the loop
# that builds/reads one runs once per event.)
_J_MODEL = 0        # model index
_J_ARR = 1          # arrival stamp (for latency + the arrivals timeline)
_J_RECORD = 2       # include in reported statistics?
_J_TPU_S = 3        # prefix compute + intra-swap stream (jitter-scaled)
_J_CPU_S = 4        # 1-core suffix time (jitter-scaled)
_J_OUT_X = 5        # boundary activation transfer (0 when no suffix)
_J_PBYTES = 6       # resident-footprint bytes under the bound route
_J_TLOAD = 7        # swap-in cost charged when the prefix was evicted
_J_SUFFIX = 8       # p < P under the bound route (has a CPU suffix)


class DiscreteEventSimulator:
    """Event-heap serving simulator; drop-in backend for ``simulate`` and
    ``run_adaptive`` (same driver surface as ``RuntimeSimulator``:
    ``offer`` / ``advance_to`` / ``set_plan`` / ``drain`` / ``result``)."""

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
        self.now = 0.0
        self.tpu_busy = 0.0
        self.last_completion = 0.0
        self.latencies: list[list[float]] = [[] for _ in range(self.n)]
        self.arrivals: list[list[float]] = [[] for _ in range(self.n)]
        self.misses = [0] * self.n
        self.tpu_requests = [0] * self.n
        self._points = [f.num_partition_points for f in self.profiles]
        self._heap: list[tuple] = []
        self._seq = itertools.count()
        self._tpu_ready: collections.deque[tuple] = collections.deque()
        self._tpu_job: tuple | None = None
        self._cpu_queues: list[collections.deque[tuple]] = [
            collections.deque() for _ in range(self.n)
        ]
        self._cpu_busy = [0] * self.n
        self._plan: Plan | None = None
        # TPU service discipline (repro_torch.serving.scheduling).  ``None`` is the
        # native FCFS deque hot path, bitwise-pinned to the PR-3 baseline;
        # a non-default Plan.discipline installs a queue object instead.
        self._disc = None
        self._wf: WeightedFairDiscipline | None = None
        self._run_model: int | None = None
        self._run_len = 0
        # Fault injection (serving.faults): mirrors the stepper's gates at
        # the same event instants with the same float ops, so DES == stepper
        # stays elementwise under any schedule.  A trivial view normalizes
        # to None so faults=None (and an empty schedule) take the exact
        # pre-fault event handlers.
        fv = as_view(faults)
        self._faults = fv if fv is not None and fv.has_faults else None
        self._fault_lost = [0] * self.n
        self._fault_requeued = [0] * self.n
        self.set_plan(plan, now=0.0)

    # -- plan management ----------------------------------------------------
    def set_plan(self, plan: Plan, now: float) -> None:
        """Switch to a new (P, K) configuration at simulated time ``now``.

        Pending events up to ``now`` are processed first, so the switch is
        causally ordered against the workload.  Routing is bound per job at
        its arrival: jobs already past arrival keep their old partition and
        service times (a mid-flight request is not re-split), while new
        arrivals see the new plan.  CPU pools resize in place -- running
        suffixes finish on their core; a pool shrunk below its busy count
        just stops admitting new work until it drains (the paper preloads
        candidate partitions, so the switch itself is free).
        """
        if len(plan.partition) != self.n:
            raise ValueError("plan size mismatch")
        self.advance_to(now)
        old_spec = self._plan.discipline if self._plan is not None else None
        if plan.discipline != old_spec:
            # Discipline switch: queued jobs migrate between queue
            # representations in global enqueue order.  Jobs coming off the
            # native FCFS deque carry no enqueue stamps, so they re-enter
            # stamped at the switch instant (staleness clocks restart; the
            # relative order -- the thing correctness rests on -- is exact).
            new = make_discipline(plan.discipline, self.n)
            if new is not None:
                for job in self._tpu_ready:
                    new.push(job, now)
                self._tpu_ready.clear()
            if self._disc is not None:
                for _, t, job in self._disc.drain_rows():
                    if new is None:
                        self._tpu_ready.append(job)
                    else:
                        new.push(job, t)
            self._disc = new
            self._wf = new if isinstance(new, WeightedFairDiscipline) else None
            # Run state is only maintained under a discipline; restart it
            # at the switch (same legitimacy class as the staleness-clock
            # restart above).
            self._run_model = None
            self._run_len = 0
        if self._disc is not None and self._faults is not None:
            # Same refusal as the stepper: fault gates are specified on the
            # FCFS service order only.
            raise ValueError(
                "fault injection supports the FCFS discipline only"
            )
        self._plan = plan
        rt = route_tables(self.profiles, plan, self.platform)
        self._prefix_bytes = rt.prefix_bytes
        self._s_tpu = rt.s_tpu
        self._t_load = rt.t_load
        self._s_cpu = rt.s_cpu
        self._in_xfer = rt.in_xfer
        self._out_xfer = rt.out_xfer
        # Suffix-bearing jobs always have somewhere to run, even if a plan
        # change dropped the model's allocation to 0 cores mid-flight (the
        # stepper sizes its pools max(k, 1) for the same reason).
        self._k_eff = [max(k, 1) for k in plan.cores]
        # A grown pool can admit queued work immediately.
        for i in range(self.n):
            self._start_cpu(i)

    @property
    def plan(self) -> Plan:
        assert self._plan is not None
        return self._plan

    # -- driver surface -----------------------------------------------------
    def submit(self, req: Request, *, record: bool = True) -> None:
        """Schedule one request; its route binds when the arrival fires."""
        if not 0 <= req.model_idx < self.n:
            raise ValueError(f"model_idx {req.model_idx} out of range")
        if req.arrival < self.now:
            raise ValueError(
                f"arrival {req.arrival} is in the simulator's past ({self.now})"
            )
        _heappush(
            self._heap,
            (req.arrival, next(self._seq), self._on_arrival, (req, record)),
        )

    def offer(self, req: Request, *, record: bool = True) -> None:
        """Advance to the request's arrival, then process it (the shared
        in-order driver contract of ``simulate``/``run_adaptive``).

        ``advance_to`` drains every event stamped at or before the arrival,
        so handling the arrival inline is event-order-identical to
        ``submit`` + another advance -- minus a heap round-trip.
        """
        if req.arrival < self.now:
            raise ValueError(
                f"arrival {req.arrival} is in the simulator's past ({self.now})"
            )
        if not 0 <= req.model_idx < self.n:
            raise ValueError(f"model_idx {req.model_idx} out of range")
        self.advance_to(req.arrival)
        self._on_arrival((req, record))

    def advance_to(self, t: float) -> None:
        """Process every event with timestamp <= ``t``; clock ends at ``t``."""
        if t < self.now:
            raise ValueError(f"cannot rewind the clock from {self.now} to {t}")
        heap = self._heap
        if heap and heap[0][0] <= t:
            pop = _heappop
            while heap and heap[0][0] <= t:
                et, _, handler, payload = pop(heap)
                if et > self.now:
                    self.now = et
                handler(payload)
        self.now = t

    def drain(self) -> float:
        """Run the event loop dry; returns the last completion time."""
        heap, pop = self._heap, _heappop
        while heap:
            et, _, handler, payload = pop(heap)
            if et > self.now:
                self.now = et
            handler(payload)
        return self.last_completion

    def result(self, duration: float) -> SimResult:
        fault = None
        if self._faults is not None:
            fault = FaultStats(
                lost=list(self._fault_lost),
                requeued=list(self._fault_requeued),
                down_windows=self._faults.down_windows,
                degraded_windows=self._faults.degraded_windows,
            )
        return SimResult(
            latencies=self.latencies,
            arrivals=self.arrivals,
            tpu_busy=self.tpu_busy,
            duration=duration,
            misses=self.misses,
            tpu_requests=self.tpu_requests,
            fault=fault,
        )

    # -- columnar driver ----------------------------------------------------
    def offer_trace(self, trace, *, record_from: float = 0.0) -> None:
        """Offer a whole arrival-sorted columnar ``Trace`` under a static
        plan: semantically ``for r in trace: self.offer(r, record=...)``,
        with the per-request ``offer``/arrival plumbing inlined and every
        plan-derived table bound to a local (valid because the plan cannot
        change mid-call -- ``run_adaptive`` drives plan changes through the
        scalar ``offer``).  Event processing order -- hence every observable
        -- is identical to the scalar driver.
        """
        mi_col = trace.model_idx
        if mi_col.size == 0:
            return
        if self._faults is not None:
            # The inlined loop binds no-fault mechanics to locals; fault
            # gates live in the scalar handlers, so fall back to them.
            for r in trace:
                self.offer(r, record=r.arrival >= record_from)
            return
        if mi_col.min() < 0 or mi_col.max() >= self.n:
            raise ValueError("model_idx out of range in trace")
        if not trace.is_sorted:
            # The scalar offer() raises per request on a clock rewind; the
            # inlined driver must surface the same misuse, not corrupt the
            # event order silently.  O(1) for generator-produced traces.
            raise ValueError("offer_trace requires an arrival-sorted Trace")
        if trace.arrival[0] < self.now:
            raise ValueError(
                f"arrival {trace.arrival[0]} is in the simulator's past "
                f"({self.now})"
            )
        heap, pop = self._heap, _heappop
        push, seq = _heappush, self._seq
        s_tpu, s_cpu = self._s_tpu, self._s_cpu
        in_xfer, out_xfer = self._in_xfer, self._out_xfer
        pbytes, t_load = self._prefix_bytes, self._t_load
        points, partition = self._points, self._plan.partition
        enq = self._on_tpu_enqueue
        for i, a, scale in zip(
            mi_col.tolist(),
            trace.arrival.tolist(),
            trace.service_scale.tolist(),
        ):
            # Inlined advance_to(a) (sorted trace: the clock never rewinds).
            while heap and heap[0][0] <= a:
                et, _, handler, payload = pop(heap)
                if et > self.now:
                    self.now = et
                handler(payload)
            self.now = a
            p = partition[i]
            suffix = p < points[i]
            job = (
                i,
                a,
                a >= record_from,
                s_tpu[i] * scale,
                s_cpu[i] * scale,
                out_xfer[i] if 0 < p and suffix else 0.0,
                pbytes[i],
                t_load[i],
                suffix,
            )
            if p > 0:
                push(heap, (a + in_xfer[i], next(seq), enq, job))
            else:
                self._on_cpu_enqueue(job)

    # -- event machinery ----------------------------------------------------
    def _on_arrival(self, payload) -> None:
        req, record = payload
        i = req.model_idx
        if self._faults is not None:
            self._on_arrival_faulted(req, record)
            return
        p = self._plan.partition[i]
        scale = req.service_scale
        suffix = p < self._points[i]
        job = (
            i,
            req.arrival,
            record,
            self._s_tpu[i] * scale,
            self._s_cpu[i] * scale,
            self._out_xfer[i] if 0 < p and suffix else 0.0,
            self._prefix_bytes[i],
            self._t_load[i],
            suffix,
        )
        if p > 0:
            # Input transfer is a pure delay: it occupies neither server
            # (the additive d/B term of Eq. 4).
            _heappush(
                self._heap,
                (
                    self.now + self._in_xfer[i],
                    next(self._seq),
                    self._on_tpu_enqueue,
                    job,
                ),
            )
        else:
            self._on_cpu_enqueue(job)

    def _on_arrival_faulted(self, req: Request, record: bool) -> None:
        """Arrival with the ``serving.faults`` dropout gate applied.

        Lost policy drops at the arrival instant; requeue admits the
        request at the recovery instant (every same-route request arriving
        inside the same chained outage defers to the *same* instant, so
        queue entry keeps arrival order -- the property the stepper's
        in-arrival-order scalar loop gives for free).  The input transfer
        runs at the swap factor in effect when it begins.
        """
        fv = self._faults
        i = req.model_idx
        t = self.now
        if fv.is_down(t):
            if fv.lost:
                if record:
                    self._fault_lost[i] += 1
                return
            t = fv.down_until(t)
            if record:
                self._fault_requeued[i] += 1
        p = self._plan.partition[i]
        scale = req.service_scale
        suffix = p < self._points[i]
        job = (
            i,
            req.arrival,
            record,
            self._s_tpu[i] * scale,
            self._s_cpu[i] * scale,
            self._out_xfer[i] if 0 < p and suffix else 0.0,
            self._prefix_bytes[i],
            self._t_load[i],
            suffix,
        )
        if p > 0:
            _heappush(
                self._heap,
                (
                    t + self._in_xfer[i] / fv.swap_factor(t),
                    next(self._seq),
                    self._on_tpu_enqueue,
                    job,
                ),
            )
        elif t > self.now:
            _heappush(
                self._heap, (t, next(self._seq), self._on_cpu_enqueue, job)
            )
        else:
            self._on_cpu_enqueue(job)

    def _on_tpu_enqueue(self, job: tuple) -> None:
        # Ready jobs are appended in nondecreasing (event time, sequence)
        # order -- the heap's pop order -- so the deque front is always the
        # global-FCFS earliest-enqueued job.  Whenever the server is idle
        # the ready queue is empty (an idle server always drained it), so
        # starting the arriving job directly equals append-then-popleft.
        # An idle server grabs the arriving job no matter the discipline
        # (all disciplines are work-conserving); a busy one parks it in the
        # discipline queue, which for FCFS is the native deque.
        if self._tpu_job is None:
            self._begin_tpu(job)
        elif self._disc is None:
            self._tpu_ready.append(job)
        else:
            self._disc.push(job, self.now)

    def _begin_tpu(self, job: tuple) -> None:
        if self._faults is not None:
            self._begin_tpu_faulted(job)
            return
        self._tpu_job = job
        i = job[_J_MODEL]
        # Same-tenant run state: what swap_batch amortization extends.
        # Tracked only under a discipline -- the native FCFS hot loop stays
        # op-for-op the PR-3 baseline; a mid-flight switch *into* a
        # discipline starts with a cleared run (set_plan resets it), which
        # costs at most one head-ordered first decision.
        if self._disc is not None:
            if i == self._run_model:
                self._run_len += 1
            else:
                self._run_model = i
                self._run_len = 1
        # Swap state transition: touching this tenant's weights may evict
        # another's; a miss (weights not resident) charges the swap-in.
        miss = self.cache.access(i, job[_J_PBYTES], self.now)
        service = job[_J_TPU_S] + (job[_J_TLOAD] if miss else 0.0)
        self.tpu_busy += service
        if self._wf is not None:
            self._wf.charge(i, service)
        if job[_J_RECORD]:
            self.tpu_requests[i] += 1
            if miss:
                self.misses[i] += 1
        _heappush(
            self._heap,
            (self.now + service, next(self._seq), self._on_tpu_done, job),
        )

    def _begin_tpu_faulted(self, job: tuple) -> None:
        """TPU service start with fault gates: the dropout gate fires at
        the would-be start instant (lost drops and lets the server take the
        next ready job at the same instant; requeue pushes the start to the
        recovery instant, occupying the server through the stretched
        completion -- exactly the stepper's ``tpu_free`` evolution), and
        throttle/swap factors bind at the actual start."""
        fv = self._faults
        while True:
            start = self.now
            if fv.is_down(start):
                if fv.lost:
                    if job[_J_RECORD]:
                        self._fault_lost[job[_J_MODEL]] += 1
                    if self._tpu_ready:
                        job = self._tpu_ready.popleft()
                        continue
                    self._tpu_job = None
                    return
                start = fv.down_until(start)
                if job[_J_RECORD]:
                    self._fault_requeued[job[_J_MODEL]] += 1
            self._tpu_job = job
            i = job[_J_MODEL]
            miss = self.cache.access(i, job[_J_PBYTES], start)
            service = job[_J_TPU_S] / fv.tpu_factor(start)
            if miss:
                service += job[_J_TLOAD] / fv.swap_factor(start)
            self.tpu_busy += service
            if job[_J_RECORD]:
                self.tpu_requests[i] += 1
                if miss:
                    self.misses[i] += 1
            _heappush(
                self._heap,
                (start + service, next(self._seq), self._on_tpu_done, job),
            )
            return

    def _on_tpu_done(self, job: tuple) -> None:
        now = self.now
        if self._faults is not None:
            self._on_tpu_done_faulted(job, now)
            return
        if job[_J_SUFFIX]:
            _heappush(
                self._heap,
                (now + job[_J_OUT_X], next(self._seq), self._on_cpu_enqueue, job),
            )
        else:
            # Complete (inlined): full-TPU route ends here.
            if now > self.last_completion:
                self.last_completion = now
            if job[_J_RECORD]:
                i = job[_J_MODEL]
                self.latencies[i].append(now - job[_J_ARR])
                self.arrivals[i].append(job[_J_ARR])
        if self._disc is not None:
            # Discipline-managed queue: the selection hook replaces the
            # baseline's FCFS popleft (this is the one decision point a
            # service discipline owns).
            nxt = self._disc.pop(now, self._run_model, self._run_len)
            if nxt is None:
                self._tpu_job = None
            else:
                self._begin_tpu(nxt)
            return
        ready = self._tpu_ready
        if ready:
            # _begin_tpu, inlined at the hottest call site (the back-to-back
            # service chain of a busy server).
            nxt = ready.popleft()
            self._tpu_job = nxt
            i = nxt[_J_MODEL]
            miss = self.cache.access(i, nxt[_J_PBYTES], now)
            service = nxt[_J_TPU_S] + (nxt[_J_TLOAD] if miss else 0.0)
            self.tpu_busy += service
            if nxt[_J_RECORD]:
                self.tpu_requests[i] += 1
                if miss:
                    self.misses[i] += 1
            _heappush(
                self._heap,
                (now + service, next(self._seq), self._on_tpu_done, nxt),
            )
        else:
            self._tpu_job = None

    def _on_tpu_done_faulted(self, job: tuple, now: float) -> None:
        fv = self._faults
        if job[_J_SUFFIX]:
            _heappush(
                self._heap,
                (
                    now + job[_J_OUT_X] / fv.swap_factor(now),
                    next(self._seq),
                    self._on_cpu_enqueue,
                    job,
                ),
            )
        else:
            if now > self.last_completion:
                self.last_completion = now
            if job[_J_RECORD]:
                i = job[_J_MODEL]
                self.latencies[i].append(now - job[_J_ARR])
                self.arrivals[i].append(job[_J_ARR])
        ready = self._tpu_ready
        if ready:
            self._begin_tpu_faulted(ready.popleft())
        else:
            self._tpu_job = None

    def _on_cpu_enqueue(self, job: tuple) -> None:
        i = job[_J_MODEL]
        self._cpu_queues[i].append(job)
        self._start_cpu(i)

    def _start_cpu(self, i: int) -> None:
        if self._faults is not None:
            self._start_cpu_faulted(i)
            return
        queue = self._cpu_queues[i]
        while queue and self._cpu_busy[i] < self._k_eff[i]:
            job = queue.popleft()
            self._cpu_busy[i] += 1
            _heappush(
                self._heap,
                (
                    self.now + job[_J_CPU_S],
                    next(self._seq),
                    self._on_cpu_done,
                    job,
                ),
            )

    def _start_cpu_faulted(self, i: int) -> None:
        """CPU admission with fault gates: lost drops at the would-be start
        (the worker stays free); requeue admits the worker with a start
        deferred to the recovery instant (busy through the stretched end,
        matching the stepper's pool-heap evolution); the suffix runs at the
        CPU factor in effect at its actual start."""
        fv = self._faults
        queue = self._cpu_queues[i]
        while queue and self._cpu_busy[i] < self._k_eff[i]:
            job = queue.popleft()
            start = self.now
            if fv.is_down(start):
                if fv.lost:
                    if job[_J_RECORD]:
                        self._fault_lost[i] += 1
                    continue
                start = fv.down_until(start)
                if job[_J_RECORD]:
                    self._fault_requeued[i] += 1
            self._cpu_busy[i] += 1
            _heappush(
                self._heap,
                (
                    start + job[_J_CPU_S] / fv.cpu_factor(start),
                    next(self._seq),
                    self._on_cpu_done,
                    job,
                ),
            )

    def _on_cpu_done(self, job: tuple) -> None:
        i = job[_J_MODEL]
        self._cpu_busy[i] -= 1
        now = self.now
        if now > self.last_completion:
            self.last_completion = now
        if job[_J_RECORD]:
            self.latencies[i].append(now - job[_J_ARR])
            self.arrivals[i].append(job[_J_ARR])
        self._start_cpu(i)
