"""Fleet serving: N per-device simulators driven off one split trace.

``simulate_fleet`` is the fleet analogue of ``simulate``: the request trace
is split by tenant placement (``workload.route_trace``), each device runs
its own independent simulator (stepper, DES, or torch -- same pluggable
backends) under its full-width device plan, and the per-device results
merge into one ``FleetSimResult`` (request-pooled means, merged
nearest-rank p99).

``run_adaptive_fleet`` is the fleet analogue of ``run_adaptive``: one
global sliding-window rate estimator, periodic per-device warm re-plans
(placement held fixed), and a *sustained-imbalance* trigger that re-runs
the full placement search only when the offered per-device load has stayed
skewed for several consecutive re-plan windows -- placement churn is
expensive for the serving tier (model redeploys), so a single bursty
window must not move tenants.

Degenerate case contract: a 1-device unit-speed fleet built
``DeviceSpec.from_platform(platform)`` makes ``simulate_fleet`` replay the
exact single-device ``simulate`` path -- same trace object, same simulator
construction, bitwise-identical ``SimResult`` fields
(``tests/test_fleet.py`` pins this for both backends).
"""
from __future__ import annotations

import collections
import dataclasses
import math
import time
from typing import TYPE_CHECKING, Sequence

import numpy as np

from repro_torch.core.fleet import (
    DeviceSpec,
    FleetPlan,
    FleetTablesCache,
    device_objectives,
    evacuate_device,
    fleet_hill_climb,
)
from repro_torch.core.objective import Objective
from repro_torch.core.planner import (
    DisciplineSpec,
    ModelProfile,
    Plan,
    TenantSpec,
    prefix_service_time,
)
from repro_torch.serving.faults import FaultSchedule, LatencyWindowTracker
from repro_torch.serving.result import FleetSimResult, SimResult, merge_fleet_results
from repro_torch.serving.simulator import make_backend, sorted_trace_and_horizon
from repro_torch.serving.workload import Request, Trace, as_trace, route_trace
from repro_torch.serving.controller import SlidingRateEstimator, _should_cold_fallback

if TYPE_CHECKING:
    import torch

    from repro_torch.core.plan_cache import FleetPlanCache
    from repro_torch.serving.forecast import RateForecaster


def _device_sims(
    profiles: Sequence[ModelProfile],
    fleet_plan: FleetPlan,
    fleet: Sequence[DeviceSpec],
    backend: str,
    faults: "FaultSchedule | None" = None,
    device: "str | torch.device" = "cuda",
):
    """One simulator per device: full-width scaled profiles, device plan,
    and (when a ``FaultSchedule`` is given) the device's fault view.
    ``device`` is where the ``"torch"`` backend runs every simulated
    device's recurrences."""
    return [
        make_backend(
            backend,
            dev.scaled_profiles(profiles),
            fleet_plan.device_plans[d],
            dev.platform,
            faults=faults.view(d) if faults is not None else None,
            device=device,
        )
        for d, dev in enumerate(fleet)
    ]


def _drive(sim, sub, backend: str, warmup_t: float, vectorize: bool) -> None:
    """Feed one device's sub-trace through its simulator (the same driver
    dispatch ``simulate`` uses)."""
    if vectorize and isinstance(sub, Trace):
        if backend in ("stepper", "torch"):
            sim.run_trace(sub, record_from=warmup_t)
        else:
            sim.offer_trace(sub, record_from=warmup_t)
    else:
        for req in sub:
            sim.offer(req, record=req.arrival >= warmup_t)


def simulate_fleet(
    tenants: Sequence[TenantSpec],
    fleet_plan: FleetPlan,
    fleet: Sequence[DeviceSpec],
    requests: "Trace | Sequence[Request]",
    *,
    warmup_frac: float = 0.05,
    backend: str = "stepper",
    vectorize: bool = True,
    route_seed: int = 0,
    faults: "FaultSchedule | None" = None,
    reroute_on_dropout: bool = False,
    device: "str | torch.device" = "cuda",
) -> FleetSimResult:
    """Run a static fleet plan over a request trace.

    The trace is split by placement/routing into per-device sub-traces
    (global model indices preserved), each device simulates independently
    -- devices share nothing at runtime, which is what makes the fleet
    embarrassingly parallel -- and the results merge.  Warmup and duration
    are *global*: the warmup cutoff comes from the fleet-wide horizon and
    every device's duration extends to at least that horizon, so per-device
    metrics weight into the merged view on one clock.

    ``faults`` injects a ``serving.faults.FaultSchedule`` into every device
    simulator (each sees its own projection); ``reroute_on_dropout``
    additionally lets the router redraw requests away from devices that are
    down at their arrival instant (``route_trace``'s health-aware mode).
    Both default off, leaving the path bitwise the pre-fault fleet.
    ``device`` is where the ``"torch"`` backend runs; the host backends
    ignore it.
    """
    if len(fleet) != fleet_plan.n_devices:
        raise ValueError(
            f"fleet has {len(fleet)} devices, plan {fleet_plan.n_devices}"
        )
    if faults is not None:
        faults.validate(len(fleet))
    profiles = [t.profile for t in tenants]
    reqs, horizon = sorted_trace_and_horizon(requests)
    warmup_t = horizon * warmup_frac
    subs = route_trace(
        reqs,
        fleet_plan.placement,
        fleet_plan.routing,
        len(fleet),
        seed=route_seed,
        faults=faults if reroute_on_dropout else None,
    )
    results: list[SimResult] = []
    sims = _device_sims(
        profiles, fleet_plan, fleet, backend, faults=faults, device=device
    )
    for sim, sub in zip(sims, subs):
        _drive(sim, sub, backend, warmup_t, vectorize)
        results.append(sim.result(max(horizon, sim.drain())))
    return merge_fleet_results(results)


def offered_device_loads(
    tenants: Sequence[TenantSpec],
    fleet_plan: FleetPlan,
    fleet: Sequence[DeviceSpec],
    rates: Sequence[float],
) -> list[float]:
    """Offered TPU utilization per device under the current plan.

    ``rho_d = sum_i w_id * lambda_i * s_TPU(p_id)`` with ``s_TPU`` from the
    device's scaled profile on its platform -- the same Eq. 1 ingredient
    the analytic model uses, so the imbalance trigger and the planner agree
    on what "load" means.
    """
    loads = [0.0] * len(fleet)
    for i, t in enumerate(tenants):
        for dev_idx, w in zip(fleet_plan.placement[i], fleet_plan.routing[i]):
            dev = fleet[dev_idx]
            prof = t.profile.scaled(dev.tpu_speed, dev.cpu_speed)
            p = fleet_plan.device_plans[dev_idx].partition[i]
            loads[dev_idx] += (
                w * rates[i] * prefix_service_time(prof, p, dev.platform)
            )
    return loads


@dataclasses.dataclass
class FleetAdaptiveResult:
    """``run_adaptive_fleet`` outcome: merged metrics + the plan history."""

    sim: FleetSimResult
    replan_times: list[float]
    fleet_plans: list[FleetPlan]
    plan_compute_seconds: list[float]
    plan_objectives: list[float] = dataclasses.field(default_factory=list)
    # Boundaries where sustained imbalance triggered a full placement
    # re-plan (a subset of ``replan_times``).
    placement_replan_times: list[float] = dataclasses.field(default_factory=list)
    # Boundaries where the (opt-in) cold-fallback guard re-climbed the
    # device plans cold with placement held (a subset of ``replan_times``).
    cold_fallback_times: list[float] = dataclasses.field(default_factory=list)
    # Fault-aware controller history (all empty unless fault_aware=True):
    # boundaries where a device was detected down and evacuated, where a
    # down device was detected recovered and re-admitted, and where
    # degradation (throttle) re-planned against scaled DeviceSpecs.
    failover_times: list[float] = dataclasses.field(default_factory=list)
    restore_times: list[float] = dataclasses.field(default_factory=list)
    degraded_replan_times: list[float] = dataclasses.field(default_factory=list)


def run_adaptive_fleet(
    profiles: Sequence[ModelProfile],
    requests: "Trace | Sequence[Request]",
    fleet: Sequence[DeviceSpec],
    *,
    k_max: int | None = None,
    replan_period: float = 30.0,
    window: float = 30.0,
    rate_decay: float | None = None,
    initial_rates: Sequence[float] | None = None,
    min_rate: float = 0.05,
    warmup_frac: float = 0.05,
    backend: str = "stepper",
    vectorize: bool = True,
    imbalance_threshold: float = 0.5,
    imbalance_patience: int = 3,
    cold_fallback_margin: float | None = None,
    cold_fallback_window: int = 5,
    discipline_space: Sequence[DisciplineSpec] | None = None,
    forecaster: "RateForecaster | None" = None,
    plan_cache: "FleetPlanCache | None" = None,
    route_seed: int = 0,
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
) -> FleetAdaptiveResult:
    """Adaptive fleet serving: local re-plans, imbalance-gated placement.

    Every ``replan_period`` the global rate estimates feed N *warm*
    per-device climbs (placement and routing fixed -- ``fleet_hill_climb``
    with ``init=incumbent``), exactly as the single-device controller
    warm-starts ``hill_climb``.  The full placement search re-runs only on
    *sustained* imbalance: when the spread of offered per-device TPU
    utilization (``max - min`` of ``offered_device_loads``) exceeds
    ``imbalance_threshold`` for ``imbalance_patience`` consecutive re-plan
    boundaries, a cold ``fleet_hill_climb`` (placement included) runs and
    the better of warm/cold commits.  One bursty window never migrates
    tenants; a persistent skew does.

    Requests arriving between boundaries are routed by the *current*
    placement; each device's queued work drains under the plan its requests
    were bound at (both backends bind routes at arrival).  Per-span routing
    draws (split-placement tenants only) are seeded by span index on top of
    ``route_seed``, so a replayed trace routes identically.

    ``cold_fallback_margin`` (opt-in, default ``None`` = off) adds the
    single-device warm-tail guard alongside the imbalance gate: when a warm
    re-plan's normalized objective regresses past the margin against the
    recent trend (``_should_cold_fallback``), the device plans re-climb
    *cold with placement held* (``fleet_hill_climb(warm_start=False)``) and
    the better result commits.  The trend history is cleared whenever a
    placement re-plan commits -- post-migration objectives must never be
    judged against pre-migration history (the two placements have different
    normalized-objective baselines, so stale history would mis-fire or
    mask the guard).

    ``rate_decay``, ``forecaster`` and ``plan_cache`` mirror
    ``run_adaptive`` (the cache must be a
    ``repro_torch.core.plan_cache.FleetPlanCache``); all default off, keeping
    this path bitwise the reactive fleet controller.  A memoized plan
    whose placement differs from the incumbent's counts as a placement
    re-plan (it migrates tenants), and the cache is bypassed at
    boundaries where the imbalance gate demands a genuine placement
    search.

    **Fault handling.** ``faults`` injects a ``serving.faults`` schedule
    into every device simulator (dropout / throttle / swap degradation).
    With ``fault_aware=False`` the controller is fault-*oblivious*: it
    keeps routing to a dead device and planning against nominal speeds --
    the baseline ``benchmarks/faults.py`` measures against.  With
    ``fault_aware=True`` the controller reacts to *observed* signals only
    (it never reads the schedule, except for the opt-in ``health_probe``
    heartbeat below):

    * *dropout*: a device offered >= ``dropout_min_requests`` in the last
      window whose ``last_completion`` did not advance is declared down; an
      out-of-band failover re-plan (``core.fleet.evacuate_device``) moves
      every tenant off it, recorded in ``failover_times``.  Recovery is
      declared when the device completes work again (its requeued backlog
      draining), or -- with ``health_probe=True`` -- when a heartbeat
      (the schedule's own ``is_down``) reports it up; a placement re-plan
      re-admits it, recorded in ``restore_times``.  Note the observational
      blind spot: under ``dropout_policy="lost"`` an evacuated device holds
      no requeued backlog and receives no traffic, so nothing ever
      completes on it and recovery is undetectable from observed signals
      alone -- use ``health_probe=True`` when lost-policy recovery matters.
    * *throttle*: a device whose observed windowed mean latency exceeds
      ``degrade_threshold`` x the model's prediction for it
      (``core.fleet.device_objectives`` / routed rate) gets an estimated
      speed factor ``clamp(pred/obs, min_speed_factor, 1)``; re-plans run
      against the *degraded* ``DeviceSpec`` (speeds scaled by the
      estimate) until the observed mean falls back under
      ``degrade_restore`` x prediction, each transition recorded in
      ``degraded_replan_times``.

    All fault parameters default off; ``faults=None, fault_aware=False``
    is bitwise the pre-fault controller.

    ``device`` is where the ``"torch"`` backend runs its recurrences
    (default the GPU; ``"cpu"`` for the host); the host backends
    (``"stepper"``, ``"des"``) ignore it and need no card.

    ``objective`` / ``rate_margin`` / ``deadlines`` mirror ``run_adaptive``:
    every planner invocation (warm, cold, failover) minimizes the chosen
    metric against optionally margin-inflated rates, with per-tenant
    deadline budgets carried on the planning mixes.  Fault *detection*
    stays on observed-vs-predicted means regardless of the planning
    objective (an SLO value is not a mean and cannot be compared against
    one).  All three default off, bitwise.
    """
    if not fleet:
        raise ValueError("fleet must contain at least one device")
    if faults is not None:
        faults.validate(len(fleet))
    if rate_margin is not None and rate_margin < 0:
        raise ValueError("rate_margin must be non-negative (or None)")
    n = len(profiles)
    if deadlines is not None and len(deadlines) != n:
        raise ValueError("deadlines length must match model count")
    dl: list[float | None] = (
        list(deadlines) if deadlines is not None else [None] * n
    )
    n_dev = len(fleet)
    est = SlidingRateEstimator(n, window=window, decay=rate_decay)
    cache = FleetTablesCache()

    def _plan_tenants(rates: Sequence[float]) -> list[TenantSpec]:
        """The mix every planner invocation sees: optionally
        margin-inflated rates, clamped, with deadline budgets attached."""
        if rate_margin is not None:
            rates = [r * (1.0 + rate_margin) for r in rates]
        return [
            TenantSpec(p, max(r, min_rate), deadline=d)
            for p, r, d in zip(profiles, rates, dl)
        ]

    # Normalized-objective trend for the opt-in warm-tail guard; cleared on
    # every committed placement re-plan (see the docstring).
    norm_history: collections.deque[float] = collections.deque(
        maxlen=max(1, cold_fallback_window)
    )
    cold_fallbacks: list[float] = []

    def plan_for(
        rates: Sequence[float],
        incumbent: FleetPlan | None,
        now: float,
        fleet_now: Sequence[DeviceSpec] | None = None,
    ) -> tuple[FleetPlan, float, float, bool]:
        """(plan, objective, seconds, placement_replanned).

        ``fleet_now`` substitutes degraded ``DeviceSpec``s for the nominal
        fleet (the fault-aware path); ``None`` -- every pre-fault call --
        plans against the nominal fleet unchanged.
        """
        eff_fleet = fleet if fleet_now is None else list(fleet_now)
        tenants = _plan_tenants(rates)
        tot_rate = sum(t.rate for t in tenants)
        gate_firing = (
            incumbent is not None and imbalance_streak >= imbalance_patience
        )

        def commit(
            plan: FleetPlan, obj: float, t0: float, moved: bool
        ) -> tuple[FleetPlan, float, float, bool]:
            # S2 fix: a committed placement re-plan resets the normalized-
            # objective baseline, so the guard's trend history restarts --
            # comparing post-migration objectives against pre-migration
            # history mis-fires the guard.  Nan-means-unknown: non-finite
            # or zero-traffic objectives carry no trend information.
            if moved:
                norm_history.clear()
            if tot_rate > 0 and math.isfinite(obj):
                norm_history.append(obj / tot_rate)
            return plan, obj, time.perf_counter() - t0, moved

        t0 = time.perf_counter()
        if plan_cache is not None and not gate_firing:
            hit = plan_cache.lookup(
                tenants,
                eff_fleet,
                k_max=k_max,
                discipline_space=discipline_space,
                objective=objective,
            )
            if hit is not None:
                plan, obj = hit
                moved = (
                    incumbent is not None
                    and plan.placement != incumbent.placement
                )
                return commit(plan, obj, t0, moved)
        if incumbent is None:
            plan, obj = fleet_hill_climb(
                tenants,
                eff_fleet,
                k_max=k_max,
                tables=cache,
                discipline_space=discipline_space,
                objective=objective,
            )
            if plan_cache is not None:
                plan_cache.store(
                    tenants,
                    eff_fleet,
                    plan,
                    obj,
                    k_max=k_max,
                    discipline_space=discipline_space,
                    objective=objective,
                )
            return commit(plan, obj, t0, False)
        plan, obj = fleet_hill_climb(
            tenants,
            eff_fleet,
            k_max=k_max,
            init=incumbent,
            tables=cache,
            discipline_space=discipline_space,
            objective=objective,
        )
        moved = False
        if gate_firing:
            cold_plan, cold_obj = fleet_hill_climb(
                tenants,
                eff_fleet,
                k_max=k_max,
                tables=cache,
                discipline_space=discipline_space,
                objective=objective,
            )
            if cold_obj < obj:
                plan, obj = cold_plan, cold_obj
                moved = True
        elif (
            cold_fallback_margin is not None
            and tot_rate > 0
            and _should_cold_fallback(
                obj / tot_rate, norm_history, cold_fallback_margin
            )
        ):
            # Warm-tail guard: re-climb the device plans cold, placement
            # held -- the fleet analogue of the single-device fallback.
            cold_plan, cold_obj = fleet_hill_climb(
                tenants,
                eff_fleet,
                k_max=k_max,
                init=incumbent,
                warm_start=False,
                tables=cache,
                discipline_space=discipline_space,
                objective=objective,
            )
            cold_fallbacks.append(now)
            if cold_obj < obj:
                plan, obj = cold_plan, cold_obj
        if plan_cache is not None:
            plan_cache.store(
                tenants,
                eff_fleet,
                plan,
                obj,
                k_max=k_max,
                discipline_space=discipline_space,
                objective=objective,
            )
        return commit(plan, obj, t0, moved)

    rates0 = list(initial_rates) if initial_rates is not None else [1.0] * n
    imbalance_streak = 0
    fleet_plan, obj, dt, _ = plan_for(rates0, None, 0.0)
    sims = _device_sims(
        profiles, fleet_plan, fleet, backend, faults=faults, device=device
    )

    replan_times = [0.0]
    fleet_plans = [fleet_plan]
    objectives = [obj]
    compute_times = [dt]
    placement_replans: list[float] = []

    # Fault-aware detection state (inert unless fault_aware=True).
    down_flags = [False] * n_dev
    speed_est = [1.0] * n_dev
    window_offered = [0] * n_dev
    last_comp_seen = [sim.last_completion for sim in sims]
    trackers = [LatencyWindowTracker(n) for _ in range(n_dev)]
    probe_views = (
        [faults.view(d) for d in range(n_dev)]
        if (fault_aware and health_probe and faults is not None)
        else None
    )
    failovers: list[float] = []
    restores: list[float] = []
    degraded_replans: list[float] = []

    def detect_faults(now: float, clamped: Sequence[float]) -> tuple[bool, bool]:
        """Update down/degraded state from this window's observed signals;
        returns (dropout state changed, degrade state changed)."""
        tenants_now = [
            TenantSpec(p, r) for p, r in zip(profiles, clamped)
        ]
        pred_obj = device_objectives(tenants_now, fleet_plan, fleet)
        drop_changed = False
        deg_changed = False
        for d in range(n_dev):
            comp = sims[d].last_completion
            cnt, obs_mean = trackers[d].poll_mean(sims[d].latencies)
            if probe_views is not None:
                down_now = probe_views[d].is_down(now)
                if down_now != down_flags[d]:
                    down_flags[d] = down_now
                    drop_changed = True
                    (failovers if down_now else restores).append(now)
            elif not down_flags[d]:
                # Silent device: offered a meaningful batch, completed
                # nothing new.  last_completion is not warmup-gated, so
                # this is safe during the recording warmup too.
                if (
                    window_offered[d] >= dropout_min_requests
                    and comp <= last_comp_seen[d]
                ):
                    down_flags[d] = True
                    drop_changed = True
                    failovers.append(now)
            elif comp > last_comp_seen[d]:
                # Completions resumed: the requeued backlog is draining,
                # so the device is back.
                down_flags[d] = False
                drop_changed = True
                restores.append(now)
            # Throttle estimation from observed-vs-predicted means (skipped
            # while the device is considered down -- an outage already
            # explains any latency signal).
            routed = sum(
                w * clamped[i]
                for i, devs in enumerate(fleet_plan.placement)
                for dd, w in zip(devs, fleet_plan.routing[i])
                if dd == d
            )
            pred_mean = pred_obj[d] / routed if routed > 0 else math.nan
            if (
                not down_flags[d]
                and cnt >= dropout_min_requests
                and math.isfinite(pred_mean)
                and pred_mean > 0
                and math.isfinite(obs_mean)
            ):
                if obs_mean > degrade_threshold * pred_mean:
                    f = min(1.0, max(min_speed_factor, pred_mean / obs_mean))
                    if speed_est[d] == 1.0 or f < 0.5 * speed_est[d]:
                        speed_est[d] = f
                        deg_changed = True
                elif speed_est[d] < 1.0 and obs_mean < degrade_restore * pred_mean:
                    speed_est[d] = 1.0
                    deg_changed = True
            last_comp_seen[d] = comp
            window_offered[d] = 0
        return drop_changed, deg_changed

    def effective_fleet() -> list[DeviceSpec]:
        return [
            dev
            if speed_est[d] == 1.0
            else dataclasses.replace(
                dev,
                tpu_speed=dev.tpu_speed * speed_est[d],
                cpu_speed=dev.cpu_speed * speed_est[d],
            )
            for d, dev in enumerate(fleet)
        ]

    reqs, horizon = sorted_trace_and_horizon(requests)
    warmup_t = horizon * warmup_frac
    next_replan = replan_period
    span_idx = 0

    def fire_due_replans(t: float) -> None:
        nonlocal next_replan, fleet_plan, imbalance_streak
        while t >= next_replan:
            for sim in sims:
                sim.advance_to(next_replan)
            rates = est.rates(next_replan)
            if forecaster is not None:
                forecaster.observe(next_replan, rates)
            if any(r > 0 for r in rates):
                clamped = [max(r, min_rate) for r in rates]
                tenants = [
                    TenantSpec(p, r) for p, r in zip(profiles, clamped)
                ]
                drop_changed = deg_changed = False
                if fault_aware:
                    drop_changed, deg_changed = detect_faults(
                        next_replan, clamped
                    )
                down_list = [d for d in range(n_dev) if down_flags[d]]
                fleet_now = (
                    effective_fleet()
                    if fault_aware
                    and (down_list or any(f < 1.0 for f in speed_est))
                    else None
                )
                # The imbalance gate judges *observed* offered load; only
                # the plan search runs against forecast rates.
                loads = offered_device_loads(
                    tenants, fleet_plan, fleet, clamped
                )
                spread = max(loads) - min(loads)
                imbalance_streak = (
                    imbalance_streak + 1
                    if spread > imbalance_threshold
                    else 0
                )
                if down_list:
                    # An evacuated placement is deliberately skewed; the
                    # imbalance gate must not re-admit a down device.
                    imbalance_streak = 0
                plan_rates = rates
                if forecaster is not None:
                    pred = forecaster.forecast(next_replan, replan_period)
                    if pred is not None:
                        plan_rates = pred
                if fault_aware and (drop_changed or deg_changed):
                    # Out-of-band fault-state-transition re-plan: failover
                    # (evacuate the down devices), restore (cold search
                    # re-admits the recovered device), or a throttle
                    # transition (cold search against the degraded specs --
                    # migration off a badly throttled device needs the
                    # placement search, which warm re-plans hold fixed).
                    tenants_plan = _plan_tenants(plan_rates)
                    eff = fleet_now if fleet_now is not None else list(fleet)
                    t0 = time.perf_counter()
                    if down_list:
                        try:
                            new_plan, obj = evacuate_device(
                                tenants_plan,
                                eff,
                                down_list,
                                k_max=k_max,
                                tables=cache,
                                discipline_space=discipline_space,
                                objective=objective,
                            )
                            dt = time.perf_counter() - t0
                            moved = True
                            norm_history.clear()
                        except ValueError:
                            # The surviving fleet cannot host every tenant:
                            # keep the incumbent placement, warm re-plan.
                            new_plan, obj, dt, moved = plan_for(
                                plan_rates,
                                fleet_plan,
                                next_replan,
                                fleet_now=fleet_now,
                            )
                    else:
                        new_plan, obj = fleet_hill_climb(
                            tenants_plan,
                            eff,
                            k_max=k_max,
                            tables=cache,
                            discipline_space=discipline_space,
                            objective=objective,
                        )
                        dt = time.perf_counter() - t0
                        moved = True
                        norm_history.clear()
                    if any(f < 1.0 for f in speed_est):
                        degraded_replans.append(next_replan)
                else:
                    new_plan, obj, dt, moved = plan_for(
                        plan_rates, fleet_plan, next_replan,
                        fleet_now=fleet_now,
                    )
                    if any(f < 1.0 for f in speed_est):
                        degraded_replans.append(next_replan)
                if moved:
                    placement_replans.append(next_replan)
                    imbalance_streak = 0
                for d, sim in enumerate(sims):
                    if new_plan.device_plans[d] != fleet_plan.device_plans[d]:
                        sim.set_plan(new_plan.device_plans[d], now=next_replan)
                fleet_plan = new_plan
                replan_times.append(next_replan)
                fleet_plans.append(new_plan)
                objectives.append(obj)
                compute_times.append(dt)
            next_replan += replan_period

    trace = as_trace(reqs)
    arrival = trace.arrival
    n_req = len(trace)
    idx = 0
    while idx < n_req:
        fire_due_replans(float(arrival[idx]))
        j = int(np.searchsorted(arrival, next_replan, side="left"))
        seg = trace[idx:j]
        est.observe_batch(seg.model_idx, seg.arrival)
        subs = route_trace(
            seg,
            fleet_plan.placement,
            fleet_plan.routing,
            len(fleet),
            seed=route_seed + span_idx,
        )
        for d, (sim, sub) in enumerate(zip(sims, subs)):
            _drive(sim, sub, backend, warmup_t, vectorize)
            if fault_aware:
                window_offered[d] += len(sub)
        span_idx += 1
        idx = j

    results = [
        sim.result(max(horizon, sim.drain())) for sim in sims
    ]
    return FleetAdaptiveResult(
        sim=merge_fleet_results(results),
        replan_times=replan_times,
        fleet_plans=fleet_plans,
        plan_compute_seconds=compute_times,
        plan_objectives=objectives,
        placement_replan_times=placement_replans,
        cold_fallback_times=cold_fallbacks,
        failover_times=failovers,
        restore_times=restores,
        degraded_replan_times=degraded_replans,
    )


__all__ = [
    "FleetAdaptiveResult",
    "offered_device_loads",
    "run_adaptive_fleet",
    "simulate_fleet",
]
