"""Pluggable planning objectives: mean (Eq. 5), tail latency, deadline miss.

The paper's planner minimizes the *mean* end-to-end response time (Eq. 5,
``sum_i lambda_i * T_i``).  Real multi-tenant deployments contract on SLOs
-- per-tenant p99 budgets and deadline-miss rates -- so every evaluator
(``latency.penalized_objective`` scalar reference, the ``EvalTables``
batched + delta paths, ``TorchPlanEvaluator``, ``fleet_plan_objective``) and
both adaptive controllers accept an ``objective=`` spec:

* ``MEAN`` (or ``objective=None``, the default): Eq. 5 exactly.  The
  ``None`` default routes through the pre-refactor code paths untouched --
  "objectives are opt-in; mean stays pinned" (ROADMAP standing invariant).
* ``p_tail(q)``: ``sum_i lambda_i * T_i(q)`` where ``T_i(q)`` adds the
  q-quantile of each queueing delay (``queueing.wait_tail_quantile``, the
  M/G/1 exponential-tail model) instead of its mean.  Summing marginal
  quantiles is conservative (the waits are positively associated through
  the shared TPU queue but the quantile of a sum is below the sum of
  quantiles); ``benchmarks/model_vs_sim.py`` maps the approximation error
  against the DES ground truth.
* ``deadline_miss()``: ``sum_i lambda_i * P(T_i > d_i)`` against the
  per-tenant latency budgets carried on the mix (``TenantSpec.deadline``).
  Tenants without a deadline never miss (they contribute 0); a tenant
  whose *static* latency already exceeds its budget misses with
  probability 1, making the objective monotone in the budget.

Objective identity (including the deadline vector, which the mix
fingerprint does not cover) must enter every memoization key -- see
``objective_key`` and ``core.plan_cache``.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

_KINDS = ("mean", "p_tail", "deadline_miss")


@dataclasses.dataclass(frozen=True)
class Objective:
    """Planning-objective spec consumed by every evaluator.

    ``kind`` is one of ``mean`` / ``p_tail`` / ``deadline_miss``; ``q`` is
    the tail quantile (only meaningful for ``p_tail``, kept at its default
    elsewhere so specs hash and compare predictably).
    """

    kind: str = "mean"
    q: float = 0.99

    def __post_init__(self) -> None:
        if self.kind not in _KINDS:
            raise ValueError(
                f"unknown objective kind {self.kind!r}: valid kinds are "
                f"{', '.join(_KINDS)}"
            )
        if not (0.0 < self.q < 1.0):
            raise ValueError(f"quantile q must be in (0, 1), got {self.q}")

    @property
    def is_mean(self) -> bool:
        return self.kind == "mean"


MEAN = Objective()


def p_tail(q: float = 0.99) -> Objective:
    """Tail-latency objective: minimize ``sum_i lambda_i * T_i(q)``."""
    return Objective("p_tail", q)


def deadline_miss() -> Objective:
    """Deadline objective: minimize the rate of deadline misses."""
    return Objective("deadline_miss")


def is_default(objective: Objective | None) -> bool:
    """True when ``objective`` selects the pinned Eq. 5 mean path.

    Both ``None`` and an explicit mean spec route through the exact
    pre-refactor code -- the bitwise standing invariant.
    """
    return objective is None or objective.is_mean


def deadlines_of(tenants) -> np.ndarray:
    """Per-tenant deadline vector; no-deadline tenants get ``inf``.

    ``inf`` budgets make the miss probability exactly 0 through the
    ``wait_exceed_prob`` conventions, so deadline-free tenants contribute
    nothing to a ``deadline_miss`` objective without special-casing.
    """
    return np.array(
        [
            math.inf if t.deadline is None else float(t.deadline)
            for t in tenants
        ],
        dtype=np.float64,
    )


def objective_key(objective: Objective | None, tenants):
    """Hashable objective-identity component for plan-cache keys.

    ``None`` for the default mean (keeps the pinned keyspace); otherwise
    the kind plus whatever extra state the objective reads -- the quantile
    for ``p_tail``, the full per-tenant deadline vector for
    ``deadline_miss`` (the mix fingerprint excludes deadlines, so without
    this two mixes differing only in budgets would collide and
    verify-then-reuse would compare different metrics).
    """
    if is_default(objective):
        return None
    if objective.kind == "p_tail":
        return ("p_tail", objective.q)
    return (
        "deadline_miss",
        tuple(None if t.deadline is None else float(t.deadline) for t in tenants),
    )
