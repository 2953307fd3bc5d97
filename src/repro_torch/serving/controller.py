"""Online adaptation: sliding-window rate estimation + periodic re-planning.

Implements Section IV's online phase: request rates are monitored with a
sliding window; the resource-allocation algorithm re-runs periodically and
the runtime switches to the new (P, K).  The paper reports <2 ms per
invocation for the allocator -- ``benchmarks/alg_overhead.py`` measures ours.

The simulated runtime underneath is pluggable (``backend="stepper"`` or
``"des"``): both speak the shared driver surface (``offer`` /
``advance_to`` / ``set_plan`` / ``drain``), so with the event-driven
backend a re-plan lands mid-flight -- queued and in-service requests bound
under the old plan drain while new arrivals take the new one.
"""
from __future__ import annotations

import collections
import dataclasses
import inspect
import math
import statistics
import time
from typing import TYPE_CHECKING, Callable, Sequence

import numpy as np

from repro_torch.core.allocator import hill_climb
from repro_torch.core.latency import penalized_objective
from repro_torch.core.objective import Objective, is_default
from repro_torch.core.plan_tables import PlanTables
from repro_torch.core.planner import DisciplineSpec, ModelProfile, Plan, TenantSpec
from repro_torch.hw.specs import Platform
from repro_torch.serving.faults import LatencyWindowTracker
from repro_torch.serving.result import SimResult
from repro_torch.serving.simulator import make_backend, sorted_trace_and_horizon
from repro_torch.serving.workload import Request, Trace

if TYPE_CHECKING:
    import torch

    from repro_torch.core.plan_cache import PlanCache
    from repro_torch.serving.faults import FaultSchedule
    from repro_torch.serving.forecast import RateForecaster

# ``run_adaptive``'s cold-fallback default is 0.05 in single-device mode but
# must NOT leak into fleet mode (the fleet guard is opt-in; the delegation
# contract pins run_adaptive(fleet=...) defaults bitwise against
# run_adaptive_fleet defaults).  The sentinel tells the defaults apart from
# an explicit caller value, which forwards verbatim.
_UNSET_MARGIN = object()


class SlidingRateEstimator:
    """lambda-hat per model from a sliding window of arrival timestamps.

    ``decay`` (seconds, default ``None`` = off) switches the estimate from
    the uniform stamp count ``N / horizon`` to an exponentially weighted
    one: each stamp at age ``a`` contributes ``exp(-a / decay)`` and the
    total is normalized by ``decay * (1 - exp(-horizon / decay))``, which
    keeps the estimator unbiased for stationary Poisson arrivals while
    fixing the burst-decay bias of the uniform window -- after a burst
    ends, the uniform estimate stays inflated until the last burst stamp
    ages out (up to a full ``window``), whereas the weighted estimate
    relaxes as ``exp(-t_since_burst / decay)``.  ``decay=None`` is bitwise
    the original estimator.
    """

    def __init__(
        self,
        n_models: int,
        window: float = 30.0,
        decay: float | None = None,
    ):
        if decay is not None and decay <= 0:
            raise ValueError("decay must be positive (or None to disable)")
        self.window = window
        self.decay = decay
        self._stamps: list[collections.deque[float]] = [
            collections.deque() for _ in range(n_models)
        ]
        self._eval_now = 0.0  # high-water mark of rates() evaluation times

    def observe(self, model_idx: int, t: float) -> None:
        self._stamps[model_idx].append(t)

    def observe_batch(self, model_idx: np.ndarray, times: np.ndarray) -> None:
        """Columnar ``observe``: ingest one trace segment's arrivals at once.

        Extends the same per-model stamp windows the scalar path fills, so
        ``rates`` is bit-identical between the two -- the adaptive fast path
        must re-plan from exactly the estimates the scalar loop would see.
        """
        for i in np.unique(model_idx).tolist():
            self._stamps[i].extend(times[model_idx == i].tolist())

    def rates(self, now: float) -> list[float]:
        # Eviction is destructive, so evaluation must be monotone: a caller
        # probing rates(t1) then rates(t0) with t0 < t1 would otherwise get
        # estimates that depend on which stamps the *first* call already
        # evicted.  The clock is clamped to its high-water mark -- backdated
        # probes answer at the latest evaluated instant instead of silently
        # mixing two windows (stamps older than t1's window are gone).
        now = self._eval_now = max(now, self._eval_now)
        # Before one full window has elapsed the divisor is the elapsed time,
        # not the window length -- dividing by the full window would
        # systematically underestimate lambda-hat on early re-plans.
        horizon = min(self.window, now)
        cutoff = now - self.window
        tau = self.decay
        # Normalizer of the decayed estimate: the integral of the weight
        # kernel over the observed horizon, so a stationary Poisson stream
        # of rate lambda has expectation lambda regardless of tau.
        denom = tau * -math.expm1(-horizon / tau) if tau is not None else 0.0
        out = []
        for dq in self._stamps:
            # Strict < keeps a stamp sitting exactly on the window boundary
            # (dq[0] == now - window), so re-evaluating at the same ``now``
            # is idempotent: the boundary stamp is counted every time, never
            # evicted by one call and missed by the next.
            while dq and dq[0] < cutoff:
                dq.popleft()
            if tau is None:
                out.append(len(dq) / horizon if horizon > 0 else 0.0)
            elif denom > 0:
                w = sum(math.exp((t - now) / tau) for t in dq)
                out.append(w / denom)
            else:
                out.append(0.0)
        return out


def _should_cold_fallback(
    norm_objective: float, history: Sequence[float], margin: float
) -> bool:
    """Warm-start quality-tail guard (ROADMAP open item).

    The warm descent always ties or beats the *incumbent plan* under the new
    rates, so a regression can only be detected against the incumbent's
    trend: if the warm plan's predicted mean latency (objective normalized
    by the offered rate mass) exceeds the *median* of the recent re-plans by
    more than ``margin``, the basin the warm walk settled in is suspect and
    a cold re-climb is worth its ~10x cost.  The median (not the min) is the
    trend statistic because rate-estimate noise swings the normalized
    objective by tens of percent near high utilization, and anchoring on the
    luckiest recent estimate would fire the guard on every swing.  False
    positives (the load genuinely rose) cost one cold climb and nothing
    else -- the better of the two plans is kept either way.

    Nan-means-unknown convention: a non-finite normalized objective
    carries no trend information (an idle boundary or a degenerate
    evaluation), so it neither fires the guard nor -- at the call sites --
    enters the history deque.  Callers guard ``tot_rate > 0`` before
    dividing, so no division by zero can reach this function.
    """
    if not history or not math.isfinite(norm_objective):
        return False
    return norm_objective > (1.0 + margin) * statistics.median(history)


@dataclasses.dataclass
class AdaptiveRunResult:
    sim: SimResult
    replan_times: list[float]
    plans: list[Plan]
    plan_compute_seconds: list[float]
    # Predicted Eq. 5 objective of each committed plan (same indexing as
    # ``plans``) and the re-plan times where the cold-fallback guard fired.
    plan_objectives: list[float] = dataclasses.field(default_factory=list)
    cold_fallback_times: list[float] = dataclasses.field(default_factory=list)
    # Re-plan boundaries where the fault-aware controller planned against
    # throttle-degraded speeds (empty on every fault-free run).
    degraded_replan_times: list[float] = dataclasses.field(default_factory=list)


def run_adaptive(
    profiles: Sequence[ModelProfile],
    requests: Sequence[Request],
    platform: Platform,
    k_max: int,
    *,
    replan_period: float = 30.0,
    window: float = 30.0,
    rate_decay: float | None = None,
    initial_rates: Sequence[float] | None = None,
    planner: Callable[..., tuple[Plan, float]] = hill_climb,
    min_rate: float = 0.05,
    warmup_frac: float = 0.05,
    backend: str = "stepper",
    vectorize: bool = True,
    cold_fallback_margin: float | None = _UNSET_MARGIN,  # type: ignore[assignment]
    cold_fallback_window: int = 5,
    discipline_space: Sequence[DisciplineSpec] | None = None,
    forecaster: "RateForecaster | None" = None,
    plan_cache: "PlanCache | None" = None,
    fleet: Sequence | None = None,
    faults: "FaultSchedule | None" = None,
    fault_aware: bool = False,
    dropout_min_requests: int = 4,
    degrade_threshold: float = 2.0,
    degrade_restore: float = 1.3,
    min_speed_factor: float = 0.05,
    health_probe: bool = False,
    objective: Objective | None = None,
    rate_margin: float | None = None,
    deadlines: Sequence[float | None] | None = None,
    device: "str | torch.device" = "cuda",
) -> AdaptiveRunResult:
    """Simulate the full adaptive runtime over a (possibly dynamic) trace.

    ``warmup_frac`` mirrors ``simulate()``: the leading fraction of the trace
    is excluded from the reported statistics (cold-start cache fills), so
    adaptive-vs-static comparisons (Fig. 8) measure the same steady state.
    The controller itself still observes warmup arrivals -- only the metrics
    skip them.

    Each periodic re-plan is warm-started from the incumbent plan when the
    planner supports it (``hill_climb(init_plan=...)``): successive rate
    estimates drift slowly, so the incremental search converges in a few
    delta-evaluated moves instead of re-climbing from all-CPU.

    ``cold_fallback_margin`` guards the warm-start quality tail: when the
    warm plan's predicted mean latency regresses by more than the margin
    against the best of the last ``cold_fallback_window`` re-plans, a cold
    climb runs too and the better plan wins (``None`` disables the guard;
    fired times are reported in ``AdaptiveRunResult.cold_fallback_times``).

    With the stepper backend and a columnar ``Trace``, each constant-plan
    span between re-plan boundaries resolves through the vectorized
    ``run_trace`` fast path (``vectorize=False`` forces the scalar
    per-request loop).  Re-plan times, rate estimates, and committed plans
    are identical either way; observed latencies agree to float round-off.

    ``discipline_space`` makes every re-plan a joint (partition, cores,
    discipline) search over the given specs when the planner supports it
    (``hill_climb(discipline_space=...)``); the committed plans carry the
    chosen spec and ``set_plan`` switches the runtime's TPU discipline
    mid-flight along with the rest of the configuration.  ``None`` (the
    default) keeps the planner untouched: plain FCFS, bit-identical to the
    pre-discipline controller.

    ``rate_decay`` (seconds) switches the sliding-window estimator to
    exponential-decay weighting (see ``SlidingRateEstimator``); ``None``
    (the default) keeps the original uniform window, bitwise.

    ``forecaster`` (opt-in) makes each re-plan predictive: the controller
    feeds the forecaster every boundary's rate estimate and, when it is
    warmed up, plans against the *forecast* rate vector one re-plan period
    ahead instead of the trailing-window estimate -- the plan switch lands
    before a forecastable burst rather than one window after it.
    Boundaries where the forecaster returns ``None`` fall back to the
    reactive estimate, so ``forecaster=None`` (and any not-yet-warm
    forecaster) replays the reactive controller bitwise.

    ``plan_cache`` (opt-in, a ``repro_torch.core.plan_cache.PlanCache``) memoizes
    committed plans keyed on the quantized rate vector: a recurring traffic
    state re-plans with one verify evaluation instead of a ``hill_climb``.
    Every hit is re-scored under the exact fresh rates and rejected back to
    the warm planner when worse than the cache's margin.  ``None`` (the
    default) is bitwise the uncached controller.

    ``fleet`` switches the controller to fleet mode: a sequence of
    ``repro_torch.core.fleet.DeviceSpec`` replaces ``platform`` (which is then
    ignored -- each device carries its own), ``k_max`` caps every device's
    core budget on top of its own ``cpu_cores``, per-device plans re-plan
    warm each period while tenant placement moves only on sustained load
    imbalance, and the return value is a
    ``repro_torch.serving.fleet.FleetAdaptiveResult``.  A custom ``planner``
    raises.  ``forecaster`` / ``rate_decay`` forward verbatim
    (``plan_cache`` must then be a ``FleetPlanCache``), and so do the
    cold-fallback knobs when given *explicitly* -- the single-device
    default margin does not leak into fleet mode, where the guard is
    opt-in alongside the imbalance gate (``run_adaptive_fleet``'s own
    default), keeping ``run_adaptive(fleet=...)`` defaults bitwise equal
    to ``run_adaptive_fleet`` defaults.

    ``objective`` (opt-in, ``repro_torch.core.objective``) selects the metric
    every re-plan minimizes -- mean (the ``None`` default, bitwise the
    pre-objective controller), ``p_tail(q)``, or ``deadline_miss`` against
    the per-tenant budgets in ``deadlines`` (seconds, ``None`` entries =
    no budget).  The committed ``plan_objectives`` are then values of that
    metric, and the plan cache keys fold in the objective identity.  The
    fault-aware throttle detector always judges observed *means* against a
    fresh Eq. 5 prediction of the committed plan, whatever the planning
    objective.

    ``rate_margin`` (opt-in) plans against rates inflated by the factor
    ``1 + rate_margin`` instead of the point estimate -- a cheap
    upper-quantile stand-in for forecast uncertainty, so the committed
    plan keeps headroom when the estimate lags a rising burst.  The
    estimator and the simulator always see real traffic; only the
    planner's input inflates.  ``None`` (the default) is bitwise the
    margin-free controller.

    ``faults`` injects a ``serving.faults.FaultSchedule`` into the
    underlying simulator (device 0 in single-device mode); ``fault_aware``
    reacts to the *observed* degradation: when the windowed mean latency
    exceeds ``degrade_threshold`` x the incumbent plan's predicted mean, a
    speed factor ``clamp(pred/obs, min_speed_factor, 1)`` is estimated and
    re-plans run against profiles scaled to the degraded speed
    (``ModelProfile.scaled``) until the observed mean drops back under
    ``degrade_restore`` x prediction; boundaries planned degraded are
    reported in ``degraded_replan_times``.  Single-device mode has no
    failover target, so dropout handling is the schedule's own
    requeue/lost policy; fleet mode (``fleet=...``) forwards every fault
    parameter to ``run_adaptive_fleet``, which adds failover/restore
    placement re-plans.  All fault parameters default off and the
    ``faults=None`` path is bitwise the pre-fault controller.

    ``device`` is where the ``"torch"`` backend runs its recurrences
    (default the GPU; ``"cpu"`` for the host); the host backends
    (``"stepper"``, ``"des"``) ignore it and need no card.
    """
    if fleet is not None:
        if planner is not hill_climb:
            raise ValueError(
                "fleet mode plans with fleet_hill_climb; a custom planner= "
                "is not supported (use run_adaptive_fleet directly)"
            )
        # Lazy import: the single-device controller must not depend on the
        # fleet layer at module load (serving.fleet imports this module).
        from repro_torch.serving.fleet import run_adaptive_fleet

        return run_adaptive_fleet(
            profiles,
            requests,
            fleet,
            k_max=k_max,
            replan_period=replan_period,
            window=window,
            rate_decay=rate_decay,
            initial_rates=initial_rates,
            min_rate=min_rate,
            warmup_frac=warmup_frac,
            backend=backend,
            vectorize=vectorize,
            cold_fallback_margin=(
                None
                if cold_fallback_margin is _UNSET_MARGIN
                else cold_fallback_margin
            ),
            cold_fallback_window=cold_fallback_window,
            discipline_space=discipline_space,
            forecaster=forecaster,
            plan_cache=plan_cache,
            faults=faults,
            fault_aware=fault_aware,
            dropout_min_requests=dropout_min_requests,
            degrade_threshold=degrade_threshold,
            degrade_restore=degrade_restore,
            min_speed_factor=min_speed_factor,
            health_probe=health_probe,
            objective=objective,
            rate_margin=rate_margin,
            deadlines=deadlines,
            device=device,
        )
    if cold_fallback_margin is _UNSET_MARGIN:
        cold_fallback_margin = 0.05
    if rate_margin is not None and rate_margin < 0:
        raise ValueError("rate_margin must be non-negative (or None)")
    n = len(profiles)
    if deadlines is not None and len(deadlines) != n:
        raise ValueError("deadlines length must match model count")
    dl: list[float | None] = (
        list(deadlines) if deadlines is not None else [None] * n
    )
    est = SlidingRateEstimator(n, window=window, decay=rate_decay)

    # The rate-free half of the vectorized evaluation engine depends only on
    # (profiles, platform): build it once and reuse it on every re-plan so
    # the per-invocation planner cost stays within the paper's <2 ms budget.
    planner_kwargs = {}
    warm_capable = False
    try:
        params = inspect.signature(planner).parameters
    except (TypeError, ValueError):
        params = {}  # builtins/partials without introspectable signatures
    if "tables" in params:
        planner_kwargs["tables"] = PlanTables.build(profiles, platform, k_max)
    warm_capable = "init_plan" in params
    # A **kwargs wrapper around hill_climb accepts kwargs without naming
    # them, so VAR_KEYWORD counts as support.
    takes_kw = any(
        p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values()
    )
    if discipline_space is not None:
        if "discipline_space" not in params and not takes_kw:
            raise ValueError(
                "planner does not support discipline co-optimization "
                "(needs a discipline_space parameter)"
            )
        planner_kwargs["discipline_space"] = tuple(discipline_space)
    if objective is not None:
        if "objective" not in params and not takes_kw:
            raise ValueError(
                "planner does not support SLO objectives "
                "(needs an objective parameter)"
            )
        planner_kwargs["objective"] = objective

    # Normalized (per-request) objectives of recent committed plans: the
    # incumbent trend the cold-fallback guard compares against.
    norm_history: collections.deque[float] = collections.deque(
        maxlen=max(1, cold_fallback_window)
    )
    cold_fallback_times: list[float] = []

    def plan_for(
        rates: Sequence[float],
        incumbent: Plan | None = None,
        now: float = 0.0,
        speed: float = 1.0,
    ) -> tuple[Plan, float, float]:
        if rate_margin is not None:
            # Headroom planning: the plan is searched for inflated rates,
            # everything else (estimator, simulator, metrics) sees reality.
            rates = [r * (1.0 + rate_margin) for r in rates]
        if speed < 1.0:
            # Degraded (fault-aware throttle) re-plan: score against the
            # observed slowdown by scaling the profiles, skip the plan
            # cache and precomputed tables (both are keyed to the nominal
            # speed) and the cold-fallback trend (a degraded normalized
            # objective is a different baseline).
            tenants = [
                TenantSpec(p.scaled(speed, speed), max(r, min_rate), deadline=d)
                for p, r, d in zip(profiles, rates, dl)
            ]
            t0 = time.perf_counter()
            kwargs = {
                k: v for k, v in planner_kwargs.items() if k != "tables"
            }
            if warm_capable and incumbent is not None:
                kwargs["init_plan"] = incumbent
            plan, obj = planner(tenants, platform, k_max, **kwargs)
            return plan, obj, time.perf_counter() - t0
        tenants = [
            TenantSpec(p, max(r, min_rate), deadline=d)
            for p, r, d in zip(profiles, rates, dl)
        ]
        tot_rate = sum(t.rate for t in tenants)
        t0 = time.perf_counter()
        if plan_cache is not None:
            hit = plan_cache.lookup(
                tenants,
                platform,
                k_max,
                discipline_space=discipline_space,
                objective=objective,
            )
            if hit is not None:
                plan, obj = hit
                dt = time.perf_counter() - t0
                if tot_rate > 0 and math.isfinite(obj):
                    norm_history.append(obj / tot_rate)
                return plan, obj, dt
        kwargs = dict(planner_kwargs)
        warm = warm_capable and incumbent is not None
        if warm:
            kwargs["init_plan"] = incumbent
        plan, obj = planner(tenants, platform, k_max, **kwargs)
        if (
            warm
            and cold_fallback_margin is not None
            and tot_rate > 0
            and _should_cold_fallback(
                obj / tot_rate, norm_history, cold_fallback_margin
            )
        ):
            cold_kwargs = dict(planner_kwargs)
            cold_plan, cold_obj = planner(tenants, platform, k_max, **cold_kwargs)
            cold_fallback_times.append(now)
            if cold_obj < obj:
                plan, obj = cold_plan, cold_obj
        if plan_cache is not None:
            plan_cache.store(
                tenants,
                platform,
                k_max,
                plan,
                obj,
                discipline_space=discipline_space,
                objective=objective,
            )
        dt = time.perf_counter() - t0
        # Nan-means-unknown: only finite normalized objectives carry trend
        # information for the cold-fallback guard (idle boundaries never
        # reach here -- ``fire_due_replans`` skips all-zero estimates).
        if tot_rate > 0 and math.isfinite(obj):
            norm_history.append(obj / tot_rate)
        return plan, obj, dt

    def _detection_value(rates: Sequence[float], p: Plan, value: float) -> float:
        """What the throttle detector's predicted-mean baseline divides.

        Observed window means must be judged against a *mean* prediction:
        with a non-mean planning objective the committed value is a tail
        quantile sum or a miss rate, so the committed plan is re-scored
        under Eq. 5 here.  On the default mean path this returns ``value``
        untouched (bitwise pin), and without ``fault_aware`` the baseline
        is never read, so no extra evaluation is paid.
        """
        if is_default(objective) or not fault_aware:
            return value
        tenants = [
            TenantSpec(pr, max(r, min_rate), deadline=d)
            for pr, r, d in zip(profiles, rates, dl)
        ]
        return penalized_objective(tenants, p, platform)

    rates0 = list(initial_rates) if initial_rates is not None else [1.0] * n
    plan, obj, dt = plan_for(rates0)
    sim = make_backend(
        backend, profiles, plan, platform, faults=faults, device=device
    )
    replan_times = [0.0]
    plans = [plan]
    objectives = [obj]
    compute_times = [dt]

    # Fault-aware throttle detection state (inert unless fault_aware=True).
    speed_est = 1.0
    base0 = _detection_value(rates0, plan, obj)
    pred_mean_inc = base0 / sum(max(r, min_rate) for r in rates0) if (
        math.isfinite(base0) and sum(max(r, min_rate) for r in rates0) > 0
    ) else math.nan
    tracker = LatencyWindowTracker(n)
    degraded_replan_times: list[float] = []

    reqs, horizon = sorted_trace_and_horizon(requests)
    n_req = len(reqs)
    warmup_t = horizon * warmup_frac
    next_replan = replan_period

    def fire_due_replans(t: float) -> None:
        """Run every re-plan boundary at or before arrival time ``t`` (the
        body of the scalar loop's ``while req.arrival >= next_replan``)."""
        nonlocal next_replan, speed_est, pred_mean_inc
        while t >= next_replan:
            sim.advance_to(next_replan)
            rates = est.rates(next_replan)
            if forecaster is not None:
                forecaster.observe(next_replan, rates)
            if fault_aware:
                # Throttle detection: compare the window's observed mean
                # latency against the incumbent plan's predicted mean.
                cnt, obs_mean = tracker.poll_mean(sim.latencies)
                if (
                    cnt >= dropout_min_requests
                    and math.isfinite(pred_mean_inc)
                    and pred_mean_inc > 0
                    and math.isfinite(obs_mean)
                ):
                    if obs_mean > degrade_threshold * pred_mean_inc:
                        f = min(
                            1.0,
                            max(min_speed_factor, pred_mean_inc / obs_mean),
                        )
                        if speed_est == 1.0 or f < 0.5 * speed_est:
                            speed_est = f
                    elif (
                        speed_est < 1.0
                        and obs_mean < degrade_restore * pred_mean_inc
                    ):
                        speed_est = 1.0
            if any(r > 0 for r in rates):
                plan_rates = rates
                if forecaster is not None:
                    # Predictive re-plan: the committed plan serves the next
                    # replan_period, so score it against the rates forecast
                    # at that horizon.  None = not warmed up -> reactive.
                    pred = forecaster.forecast(next_replan, replan_period)
                    if pred is not None:
                        plan_rates = pred
                new_plan, obj, dt = plan_for(
                    plan_rates,
                    incumbent=sim.plan,
                    now=next_replan,
                    speed=speed_est,
                )
                if speed_est < 1.0:
                    degraded_replan_times.append(next_replan)
                if new_plan != sim.plan:
                    sim.set_plan(new_plan, now=next_replan)
                replan_times.append(next_replan)
                plans.append(new_plan)
                objectives.append(obj)
                compute_times.append(dt)
                tot = sum(max(r, min_rate) for r in plan_rates)
                if speed_est == 1.0 and math.isfinite(obj) and tot > 0:
                    # The incumbent prediction the next window's observation
                    # is judged against.  Only *nominal* commits move the
                    # baseline: a degraded objective already folds in the
                    # estimated slowdown, and judging against it would
                    # declare recovery the moment the degraded plan performs
                    # as (degraded-)predicted -- an oscillating restore.
                    base = _detection_value(plan_rates, new_plan, obj)
                    if math.isfinite(base):
                        pred_mean_inc = base / tot
            next_replan += replan_period

    if (
        vectorize
        and backend in ("stepper", "torch")
        and isinstance(reqs, Trace)
    ):
        # Columnar fast path: between consecutive re-plan boundaries the
        # plan is constant, so each span resolves as one vectorized
        # run_trace segment.  Boundary firing and rate estimation see the
        # exact arrivals the scalar loop would feed them.
        arrival = reqs.arrival
        idx = 0
        while idx < n_req:
            fire_due_replans(float(arrival[idx]))
            j = int(np.searchsorted(arrival, next_replan, side="left"))
            seg = reqs[idx:j]
            est.observe_batch(seg.model_idx, seg.arrival)
            sim.run_trace(seg, record_from=warmup_t)
            idx = j
    else:
        for req in reqs:
            fire_due_replans(req.arrival)
            est.observe(req.model_idx, req.arrival)
            sim.offer(req, record=req.arrival >= warmup_t)

    # Duration runs to the last *completion*: under backlog the queue drains
    # past the last arrival, and clipping there inflated tpu_utilization
    # beyond 1.0.
    duration = max(horizon, sim.drain())
    return AdaptiveRunResult(
        sim=sim.result(duration),
        replan_times=replan_times,
        plans=plans,
        plan_compute_seconds=compute_times,
        plan_objectives=objectives,
        cold_fallback_times=cold_fallback_times,
        degraded_replan_times=degraded_replan_times,
    )
