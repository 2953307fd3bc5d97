"""Shared observation record for every serving backend.

``SimResult`` is the one metrics container produced by the sequential
``RuntimeSimulator`` stepper, the event-driven ``DiscreteEventSimulator``,
and ``run_adaptive`` -- a model-vs-simulation comparison never depends on
which backend observed the trace.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np


@dataclasses.dataclass
class SimResult:
    # Per model, per completed request.  Scalar backends fill plain float
    # lists; the vectorized stepper fast path hands over NumPy arrays --
    # every metric below handles either (len/indexing/np reductions only).
    latencies: list[Sequence[float]]
    arrivals: list[Sequence[float]]            # arrival stamps (for timelines)
    tpu_busy: float
    duration: float
    misses: list[int]
    tpu_requests: list[int]
    # Fault bookkeeping (serving.faults.FaultStats) when the backend ran
    # under a FaultSchedule; None on every fault-free run -- the default
    # keeps the pre-fault construction paths byte-identical.
    fault: object | None = None

    def mean_latency(self, model_idx: int) -> float:
        """Mean observed latency; ``nan`` when the model completed nothing
        (an unknown mean, not a zero-latency one)."""
        ls = self.latencies[model_idx]
        return float(np.sum(ls)) / len(ls) if len(ls) else math.nan

    def overall_mean(self) -> float:
        """Mean over all completions; ``nan`` when nothing completed at all
        (same unknown-not-zero convention as ``mean_latency``)."""
        count = sum(len(ls) for ls in self.latencies)
        if not count:
            return math.nan
        return sum(float(np.sum(ls)) for ls in self.latencies) / count

    def request_weighted_mean(self, rates: Sequence[float] | None = None) -> float:
        """Per-model rate-weighted mean latency, Eq. 5's
        ``sum_i lambda_i T_i / sum_i lambda_i``.

        With ``rates`` given, the weights are the *offered* per-model rates
        (what the objective optimizes); without them, the observed request
        counts stand in, which recovers the plain overall mean.  Models with
        no recorded samples (e.g. all arrivals inside the warmup window)
        have an unknown mean and are excluded from both numerator and
        denominator rather than counted as zero latency.
        """
        if rates is None:
            weights: Sequence[float] = [len(ls) for ls in self.latencies]
        else:
            if len(rates) != len(self.latencies):
                raise ValueError("rates length must match model count")
            weights = rates
        pairs = [
            (w, self.mean_latency(i))
            for i, (w, ls) in enumerate(zip(weights, self.latencies))
            if len(ls)
        ]
        if not pairs:
            return math.nan  # nothing completed: the mean is unknown
        tot = sum(w for w, _ in pairs)
        if tot <= 0:
            # All-zero weights leave the weighted mean undefined, not zero
            # (the class-wide unknown-not-zero nan convention: a 0.0 here
            # silently wins comparisons and poisons downstream averages).
            return math.nan
        return sum(w * m for w, m in pairs) / tot

    def p99(self, model_idx: int) -> float:
        """Nearest-rank 99th percentile: the smallest latency with at least
        99% of samples at or below it (``ceil(0.99 n)``-th order statistic).
        ``nan`` when the model completed no requests.

        Selection (``np.partition``), not a sort: million-request traces
        from the vectorized fast path make the full Python sort the most
        expensive line of a sweep.  Same order statistic, no float math.

        The rank is computed in exact integer arithmetic:
        ``ceil(99 n / 100) == (99 n + 99) // 100``, which is the
        nearest-rank definition with no float product that could round
        across an integer boundary at large ``n`` (``ceil(0.99 * n)``
        agrees everywhere we could scan, but only by luck of the
        double-precision grid -- the integer form is correct by
        construction).  Boundary pins: n=1 and n=2 select the max
        (rank 1 of n), n=99 and n=100 select the 98th/99th order
        statistic (index 97/98), n=101 index 99.
        """
        ls = self.latencies[model_idx]
        n = len(ls)
        if not n:
            return math.nan
        rank = (99 * n + 99) // 100 - 1
        return float(np.partition(np.asarray(ls), rank)[rank])

    def per_model_p99(self) -> list[float]:
        """Per-model nearest-rank p99 drill-down: ``p99(i)`` for every
        model, ``nan`` for models with no completions (the class-wide
        unknown-not-zero convention).  On ``FleetSimResult`` the columns
        are the pooled fleet samples, so this is the merged per-model p99
        an external client observes."""
        return [self.p99(i) for i in range(len(self.latencies))]

    def deadline_misses(self, deadlines: Sequence[float | None]) -> list[int]:
        """Per-model count of completed requests that missed their
        deadline (observed latency strictly above the budget).

        Resolved post-hoc from the recorded latency columns -- identical
        across every backend by construction, and deadline tracking costs
        nothing on runs that never ask.  Models with no deadline (``None``
        or ``inf``) never miss.  Requests dropped by a fault policy are not
        completions and are counted separately (``requests_lost``), so a
        renege analysis reads both.
        """
        if len(deadlines) != len(self.latencies):
            raise ValueError("deadlines length must match model count")
        out = []
        for d, ls in zip(deadlines, self.latencies):
            if d is None or not len(ls) or math.isinf(d):
                out.append(0)
            else:
                out.append(int(np.sum(np.asarray(ls) > float(d))))
        return out

    def per_model_deadline_miss_rate(
        self, deadlines: Sequence[float | None]
    ) -> list[float]:
        """Per-model observed miss fraction; ``nan`` for a model with no
        completions (unknown, not zero) -- deadline-free models with
        completions read 0.0 (they observably never miss)."""
        misses = self.deadline_misses(deadlines)
        return [
            m / len(ls) if len(ls) else math.nan
            for m, ls in zip(misses, self.latencies)
        ]

    def deadline_miss_rate(self, deadlines: Sequence[float | None]) -> float:
        """Pooled miss fraction over deadline-bearing models' completions.

        Deadline-free models are excluded from both numerator and
        denominator (they cannot miss, and counting their completions would
        dilute the rate the SLO contracts on).  ``nan`` when no
        deadline-bearing model completed anything.
        """
        if len(deadlines) != len(self.latencies):
            raise ValueError("deadlines length must match model count")
        misses = self.deadline_misses(deadlines)
        tot_miss, tot_done = 0, 0
        for d, m, ls in zip(deadlines, misses, self.latencies):
            if d is None or math.isinf(d):
                continue
            tot_miss += m
            tot_done += len(ls)
        return tot_miss / tot_done if tot_done else math.nan

    def observed_miss_rate(self, model_idx: int) -> float:
        """Fraction of the model's TPU services that paid a swap-in;
        ``nan`` when the model never visited the TPU (full-CPU route or no
        recorded requests) -- an unknown rate, not a perfect hit rate, per
        the class's nan convention."""
        n = self.tpu_requests[model_idx]
        return self.misses[model_idx] / n if n else math.nan

    @property
    def tpu_utilization(self) -> float:
        return self.tpu_busy / self.duration if self.duration > 0 else 0.0

    # -- recovery metrics (defined only on faulted runs) ---------------------
    @property
    def requests_lost(self) -> int:
        """Requests dropped by the dropout lost-policy (0 without faults)."""
        return self.fault.total_lost if self.fault is not None else 0

    @property
    def requests_requeued(self) -> int:
        """Dropout deferral events under the requeue policy (0 without
        faults; a request crossing several gates counts each deferral)."""
        return self.fault.total_requeued if self.fault is not None else 0

    def recovery_times(self) -> list[float]:
        """Time-to-recover per dropout window: how long after the outage
        ends until the deferred backlog drains.

        Resolved post-hoc from the recorded (arrival, latency) columns: for
        a window ``[s, e)`` the backlog is every completion whose request
        arrived at or before ``e``, and recovery is the instant the last of
        them completes -- ``max(arrival + latency) - e``, clamped at 0 (an
        outage nobody was waiting behind recovers instantly).  Warmup-gated
        recording applies, like every other metric here.
        """
        if self.fault is None or not self.fault.down_windows:
            return []
        out = []
        for _, e in self.fault.down_windows:
            worst = -math.inf
            for arr_col, lat_col in zip(self.arrivals, self.latencies):
                if not len(arr_col):
                    continue
                a = np.asarray(arr_col, dtype=np.float64)
                l = np.asarray(lat_col, dtype=np.float64)
                sel = a <= e
                if sel.any():
                    worst = max(worst, float((a[sel] + l[sel]).max()))
            out.append(max(0.0, worst - e) if math.isfinite(worst) else 0.0)
        return out

    def degraded_window_mean(self) -> float:
        """Mean latency over requests that *arrived* inside any fault
        window (down, throttled, or swap-degraded) -- the cost clients paid
        while the system was impaired.  ``nan`` when no recorded request
        arrived in a window (unknown, not zero)."""
        if self.fault is None or not self.fault.degraded_windows:
            return math.nan
        tot, cnt = 0.0, 0
        for arr_col, lat_col in zip(self.arrivals, self.latencies):
            if not len(arr_col):
                continue
            a = np.asarray(arr_col, dtype=np.float64)
            l = np.asarray(lat_col, dtype=np.float64)
            sel = np.zeros(a.size, dtype=bool)
            for s, e in self.fault.degraded_windows:
                sel |= (a >= s) & (a < e)
            if sel.any():
                tot += float(l[sel].sum())
                cnt += int(sel.sum())
        return tot / cnt if cnt else math.nan


@dataclasses.dataclass
class FleetSimResult(SimResult):
    """Fleet-wide metrics merged from N per-device ``SimResult``s.

    The merged view pools every device's samples per model, so
    ``mean_latency`` is the request-weighted mean across the fleet and
    ``p99`` the nearest-rank percentile over the pooled samples (the
    *merged* p99, not a percentile of per-device percentiles -- the pooled
    order statistic is what an external client of the whole fleet
    observes).  Per-model sample order is device-major, not time-sorted;
    every ``SimResult`` metric is order-free.  ``per_device`` keeps the
    constituent results for drill-down.
    """

    per_device: list[SimResult] = dataclasses.field(default_factory=list)

    @property
    def n_devices(self) -> int:
        return len(self.per_device)

    @property
    def tpu_utilization(self) -> float:
        """Mean per-TPU utilization: aggregate busy time normalized by
        N devices' wall-clock (a 4-device fleet at 0.25 each reads 0.25,
        not 1.0)."""
        denom = self.duration * max(1, self.n_devices)
        return self.tpu_busy / denom if denom > 0 else 0.0


def _merge_columns(cols: list[Sequence[float]]) -> Sequence[float]:
    """Pool one model's per-device sample columns.

    All-list inputs concatenate as lists (the scalar backends' native form,
    and exactly the device's own objects when only one column is nonempty);
    anything else pools through ``np.concatenate``.
    """
    filled = [c for c in cols if len(c)]
    if not filled:
        return cols[0] if cols else []
    if len(filled) == 1:
        return filled[0]
    if all(isinstance(c, list) for c in filled):
        out: list[float] = []
        for c in filled:
            out.extend(c)
        return out
    return np.concatenate([np.asarray(c, dtype=np.float64) for c in filled])


def merge_fleet_results(per_device: Sequence[SimResult]) -> FleetSimResult:
    """Merge per-device results into the fleet-wide ``FleetSimResult``.

    Per-model latencies/arrivals pool across devices; ``misses`` and
    ``tpu_requests`` add elementwise; ``tpu_busy`` adds; ``duration`` is the
    fleet wall-clock (max over devices).  The single-device merge reuses
    the device's own column objects -- the bitwise N=1 contract.
    """
    if not per_device:
        raise ValueError("merge_fleet_results needs at least one result")
    n_models = len(per_device[0].latencies)
    for r in per_device:
        if len(r.latencies) != n_models:
            raise ValueError("per-device results cover different model counts")
    if len(per_device) == 1:
        r = per_device[0]
        return FleetSimResult(
            latencies=r.latencies,
            arrivals=r.arrivals,
            tpu_busy=r.tpu_busy,
            duration=r.duration,
            misses=r.misses,
            tpu_requests=r.tpu_requests,
            fault=r.fault,
            per_device=list(per_device),
        )
    from repro_torch.serving.faults import merge_fault_stats

    return FleetSimResult(
        latencies=[
            _merge_columns([r.latencies[i] for r in per_device])
            for i in range(n_models)
        ],
        arrivals=[
            _merge_columns([r.arrivals[i] for r in per_device])
            for i in range(n_models)
        ],
        tpu_busy=sum(r.tpu_busy for r in per_device),
        duration=max(r.duration for r in per_device),
        misses=[
            sum(r.misses[i] for r in per_device) for i in range(n_models)
        ],
        tpu_requests=[
            sum(r.tpu_requests[i] for r in per_device) for i in range(n_models)
        ],
        fault=merge_fault_stats([r.fault for r in per_device], n_models),
        per_device=list(per_device),
    )
