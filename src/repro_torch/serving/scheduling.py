"""Pluggable TPU service disciplines for the serving simulators.

Every layer of the repro used to hardwire a single global FCFS queue in
front of the TPU, which forfeits the paper's biggest latency lever after
partitioning itself: with the inter-model swap-in (Eq. 2's ``T_load``)
charged on every tenant switch, *service order* decides how often the
switch happens.  Serving same-tenant requests back-to-back amortizes one
swap-in over the whole run -- the scheduling/placement-order effect that
prior edge multi-tenancy work (Subedi et al.; Villarrubia et al.) treats
as a first-class design axis.

This module is the one implementation of queue mechanics both simulators
share:

* the event-heap DES (the reference's ``repro.serving.des``) calls ``pop`` from its
  TPU-completion handler (the only point where the baseline popped its
  global FIFO deque);
* the sequential stepper (``repro_torch.serving.simulator``) drives the same
  objects from its deferred-TPU decision loop.

The *selection* of a discipline is data, not code: ``DisciplineSpec``
(``repro_torch.core.planner``) rides on the ``Plan``, so the planner co-optimizes
it with (P, K) and ``set_plan`` can change it mid-flight.  ``fcfs`` is the
permanent reference -- both simulators keep their native bitwise-pinned
FCFS hot paths and only instantiate these objects for non-default specs
(``make_discipline`` returns ``None`` for plain FCFS).

Contract every discipline obeys (relied on by tests/test_scheduling.py):

* **per-tenant FIFO**: within one tenant, jobs are served strictly in
  enqueue order -- a discipline chooses *which tenant* goes next, never
  reorders inside a tenant;
* **work-conserving**: ``pop`` returns a job whenever one is queued;
* **bounded unfairness** (swap_batch): between two services of the global
  FCFS head's tenant, at most ``batch_cap - 1`` same-tenant services are
  inserted, so no tenant starves.

Jobs are opaque tuples whose field 0 is the model index (the shared
``_J_MODEL`` layout of both simulators); disciplines read nothing else.
"""
from __future__ import annotations

import collections
import itertools
import math

from repro_torch.core.planner import DisciplineSpec, FCFS  # noqa: F401  (re-export)

__all__ = [
    "FCFS",
    "DisciplineSpec",
    "Discipline",
    "FcfsDiscipline",
    "SwapBatchDiscipline",
    "PriorityDiscipline",
    "WeightedFairDiscipline",
    "make_discipline",
]


class Discipline:
    """Base of every TPU queue discipline: per-tenant FIFO deques of
    ``(seq, enqueue_time, job)`` rows plus a global arrival sequence.

    Subclasses override ``_choose`` to pick the tenant served next;
    ``push``/``pop``/``drain_rows`` and the per-tenant FIFO invariant are
    shared.  ``pop`` receives the simulated time plus the server's current
    same-tenant run state (last model begun and the length of its
    consecutive run) so run-extending disciplines can amortize swaps.
    """

    def __init__(self, spec: DisciplineSpec, n_models: int):
        if spec.weights is not None and len(spec.weights) != n_models:
            # validate_plan checks this too, but the simulators construct
            # disciplines without it -- fail at build time, not with an
            # IndexError deep inside the first contended pop.
            raise ValueError(
                f"discipline weights length {len(spec.weights)} != "
                f"{n_models} models"
            )
        self.spec = spec
        self.n = n_models
        self._queues: list[collections.deque] = [
            collections.deque() for _ in range(n_models)
        ]
        self._seq = itertools.count()
        self._len = 0

    def __len__(self) -> int:
        return self._len

    def push(self, job: tuple, enqueue_time: float) -> None:
        """Enqueue one job; callers push in nondecreasing enqueue time."""
        self._queues[job[0]].append((next(self._seq), enqueue_time, job))
        self._len += 1

    def _head_model(self) -> int:
        """Tenant holding the globally earliest-enqueued job (FCFS head)."""
        best, best_seq = -1, math.inf
        for i, q in enumerate(self._queues):
            if q and q[0][0] < best_seq:
                best, best_seq = i, q[0][0]
        return best

    def _choose(self, now: float, run_model: int | None, run_len: int) -> int:
        raise NotImplementedError

    def pop(self, now: float, run_model: int | None, run_len: int):
        """Job served next, or ``None`` when nothing is queued."""
        if not self._len:
            return None
        i = self._choose(now, run_model, run_len)
        _, _, job = self._queues[i].popleft()
        self._len -= 1
        self._served(i, job)
        return job

    def _served(self, model_idx: int, job: tuple) -> None:
        """Post-pop bookkeeping hook (weighted-fair service accounting)."""

    def drain_rows(self) -> list[tuple[int, float, tuple]]:
        """Remove and return every queued ``(seq, enqueue_time, job)`` row in
        global enqueue order -- the migration path when ``set_plan`` switches
        disciplines mid-flight (relative order is preserved)."""
        rows = sorted(
            row for q in self._queues for row in q
        )
        for q in self._queues:
            q.clear()
        self._len = 0
        return rows


class FcfsDiscipline(Discipline):
    """Global FCFS through the shared interface.

    The simulators never run plain FCFS through this object (their native
    deque hot paths stay bitwise-pinned); it exists as the reference the
    other disciplines are tested against and as the drain-out queue after
    a mid-flight switch *back* to FCFS.
    """

    def _choose(self, now: float, run_model: int | None, run_len: int) -> int:
        return self._head_model()


class SwapBatchDiscipline(Discipline):
    """Swap-amortizing batching: keep serving the resident tenant.

    On each completion the server extends the current same-tenant run --
    popping that tenant's earliest queued job, whose weights are already
    resident so the service pays no ``T_load`` -- until one of three
    fairness triggers ends the run and FCFS order resumes at the global
    head:

    * the run reaches ``batch_cap`` consecutive services,
    * the tenant has nothing queued,
    * the globally oldest queued job has waited more than ``staleness``
      seconds (``inf`` by default: the cap alone bounds unfairness).
    """

    def _choose(self, now: float, run_model: int | None, run_len: int) -> int:
        head = self._head_model()
        if (
            run_model is not None
            and run_model != head
            and run_len < self.spec.batch_cap
            and self._queues[run_model]
        ):
            head_q = self._queues[head]
            if now - head_q[0][1] <= self.spec.staleness:
                return run_model
        return head


class PriorityDiscipline(Discipline):
    """Strict non-preemptive priority: highest ``weights[i]`` first, global
    FCFS order among tenants of equal weight.  Unweighted tenants default
    to priority 0; a starving low-priority tenant is the discipline working
    as specified, not a bug -- the planner's co-optimization only commits
    it when the predicted objective still wins."""

    def _choose(self, now: float, run_model: int | None, run_len: int) -> int:
        w = self.spec.weights
        best, best_key = -1, None
        for i, q in enumerate(self._queues):
            if not q:
                continue
            key = (-(w[i] if w is not None else 0.0), q[0][0])
            if best_key is None or key < best_key:
                best, best_key = i, key
        return best


class WeightedFairDiscipline(Discipline):
    """Weighted fair queueing over accumulated TPU service time.

    The nonempty tenant with the smallest ``served_time / weight`` goes
    next (ties: global FCFS order), which converges to weight-proportional
    TPU shares under backlog.  The simulator charges realized service via
    ``charge`` when it begins the job (the miss-dependent swap cost is only
    known there); the single-server loop pops at most one job per
    completion, so the charge always lands before the next ``pop``.
    """

    def __init__(self, spec: DisciplineSpec, n_models: int):
        super().__init__(spec, n_models)
        self._served_time = [0.0] * n_models

    def _choose(self, now: float, run_model: int | None, run_len: int) -> int:
        w = self.spec.weights
        best, best_key = -1, None
        for i, q in enumerate(self._queues):
            if not q:
                continue
            wi = w[i] if w is not None else 1.0
            credit = self._served_time[i] / wi if wi > 0 else math.inf
            key = (credit, q[0][0])
            if best_key is None or key < best_key:
                best, best_key = i, key
        return best

    def charge(self, model_idx: int, service: float) -> None:
        """Record realized TPU service time for fairness accounting."""
        self._served_time[model_idx] += service


def make_discipline(spec: DisciplineSpec, n_models: int) -> Discipline | None:
    """Instantiate the queue mechanics for a spec.

    Returns ``None`` for plain FCFS (including ``swap_batch`` with
    ``batch_cap == 1``, which cannot batch): the simulators keep their
    native bitwise-pinned FCFS paths and only pay the discipline
    indirection when a spec actually changes service order.
    """
    if spec.kind == "fcfs" or (spec.kind == "swap_batch" and not spec.batches):
        return None
    if spec.kind == "swap_batch":
        return SwapBatchDiscipline(spec, n_models)
    if spec.kind == "priority":
        return PriorityDiscipline(spec, n_models)
    if spec.kind == "weighted_fair":
        return WeightedFairDiscipline(spec, n_models)
    raise ValueError(f"unknown discipline kind {spec.kind!r}")
