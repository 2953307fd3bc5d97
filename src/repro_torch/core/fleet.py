"""Fleet-scale plan space: placement + routing across N heterogeneous devices.

The paper optimizes one Edge TPU; the north star is a *fleet*.  This module
lifts the single-device ``Plan`` contract into a two-level plan:

* ``DeviceSpec`` -- one device's hardware envelope: SRAM bytes, swap
  bandwidth, host core count, and relative TPU/CPU speed factors against the
  profiled reference device.  Speed factors enter the system exactly once,
  through ``ModelProfile.scaled`` -- every downstream consumer (the analytic
  model, both simulators, the plan tables) sees profiled *times* and never
  learns about heterogeneity.
* ``FleetPlan`` -- tenant -> device placement with per-tenant request-routing
  weights, plus one full-width per-device ``Plan``.  Device plans keep every
  tenant's row (unplaced tenants are pinned at the inert ``(P_i, 0)``
  full-TPU/zero-core point and receive no traffic) so a mid-run placement
  change never needs a simulator rebuild -- the same ``set_plan`` switch the
  single-device controller already performs.
* ``fleet_hill_climb`` -- the cluster-level planner: greedy load-balanced
  bin packing seeds the placement, each device's (partition, cores,
  discipline) is then optimized by the existing warm-startable ``hill_climb``
  (one batched NumPy pass scores each device's whole neighbor frontier, with
  ``PlanTables`` shared across all devices of one class via
  ``FleetTablesCache``), and a bounded improvement loop migrates tenants off
  the worst-objective device while the move pays.

Degenerate case contract (ROADMAP invariant): a 1-device fleet whose
``DeviceSpec`` wraps the reference platform at unit speed factors routes
through *identical* calls as the single-device API -- ``fleet_hill_climb``
returns exactly ``hill_climb``'s plan and objective, bitwise
(``tests/test_fleet.py`` pins this).

Grounding: Villarrubia et al. (arxiv 2503.01025) profile cross-device model
segmentation on multi-TPU systems; Liang et al. (arxiv 2201.07312) supply
the model-driven placement/routing layer this planner follows.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

from repro_torch.core.allocator import ensure_eval_tables, hill_climb
from repro_torch.core.latency import penalized_objective
from repro_torch.core.objective import Objective
from repro_torch.core.plan_tables import PlanTables
from repro_torch.core.planner import (
    FCFS,
    DisciplineSpec,
    ModelProfile,
    Plan,
    TenantSpec,
    validate_plan,
)
from repro_torch.hw.specs import AcceleratorSpec, HostCPUSpec, Platform

_W_SUM_TOL = 1e-9  # routing weights must sum to 1 within this


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    """One device of a heterogeneous serving fleet.

    ``tpu_speed`` / ``cpu_speed`` are multipliers against the device the
    profiles were measured on (2.0 = twice as fast); they reach the rest of
    the system only through ``ModelProfile.scaled``.  Two devices with equal
    (sram, bw, cores, speeds) form one *device class* (``class_key``) and
    share plan tables regardless of their names.
    """

    name: str
    sram_bytes: int
    swap_bw: float
    cpu_cores: int
    tpu_speed: float = 1.0
    cpu_speed: float = 1.0
    # The exact Platform object this spec was derived from, when it was
    # (``from_platform``).  Excluded from equality -- it carries no state
    # beyond (sram_bytes, swap_bw) that any consumer reads -- but keeping
    # the original object makes the N=1 degenerate path use *the same*
    # platform value the single-device API was called with.
    base_platform: Platform | None = dataclasses.field(
        default=None, compare=False, repr=False
    )

    def __post_init__(self) -> None:
        if self.sram_bytes < 0:
            raise ValueError("sram_bytes must be non-negative")
        if self.swap_bw <= 0:
            raise ValueError("swap_bw must be positive")
        if self.cpu_cores < 0:
            raise ValueError("cpu_cores must be non-negative")
        if self.tpu_speed <= 0 or self.cpu_speed <= 0:
            raise ValueError("speed factors must be positive")

    @classmethod
    def from_platform(
        cls,
        platform: Platform,
        *,
        name: str | None = None,
        cpu_cores: int | None = None,
        tpu_speed: float = 1.0,
        cpu_speed: float = 1.0,
    ) -> "DeviceSpec":
        """A device wrapping an existing ``Platform`` (the N=1 entry point)."""
        return cls(
            name=name or platform.accelerator.name,
            sram_bytes=platform.sram_bytes,
            swap_bw=platform.swap_bw,
            cpu_cores=cpu_cores if cpu_cores is not None else platform.cpu.n_cores,
            tpu_speed=tpu_speed,
            cpu_speed=cpu_speed,
            base_platform=platform,
        )

    @property
    def class_key(self) -> tuple:
        """Hashable device-class identity (name excluded): devices of one
        class share ``Platform`` values, scaled profiles, and plan tables."""
        return (
            self.sram_bytes,
            self.swap_bw,
            self.cpu_cores,
            self.tpu_speed,
            self.cpu_speed,
        )

    @property
    def platform(self) -> Platform:
        """The ``Platform`` the per-device planner/simulators run against.

        When built ``from_platform`` this is the original object (exact N=1
        degeneracy); otherwise a synthesized platform whose names derive
        from the class key, so equal-class devices compare ``==`` and
        ``PlanTables.matches`` reuses tables across them.
        """
        if self.base_platform is not None:
            return self.base_platform
        tag = f"sram{self.sram_bytes}-bw{self.swap_bw:g}"
        return Platform(
            accelerator=AcceleratorSpec(
                name=f"fleet-accel-{tag}",
                peak_ops=4.0e12,
                sram_bytes=self.sram_bytes,
                host_bw=self.swap_bw,
            ),
            cpu=HostCPUSpec(
                name=f"fleet-host-{self.cpu_cores}c",
                n_cores=self.cpu_cores,
                ops_per_core=4.0e9,
                parallel_frac=0.90,
            ),
        )

    def scaled_profiles(
        self, profiles: Sequence[ModelProfile]
    ) -> list[ModelProfile]:
        """The hosted profiles re-timed for this device (identity-stable:
        unit factors return the originals; repeats return cached objects)."""
        return [p.scaled(self.tpu_speed, self.cpu_speed) for p in profiles]


@dataclasses.dataclass(frozen=True)
class FleetPlan:
    """A two-level plan: who runs where, and each device's local plan.

    ``placement[i]`` lists the devices tenant ``i``'s requests may run on;
    ``routing[i]`` holds the matching request-routing weights (same length,
    non-negative, summing to 1).  ``device_plans[d]`` is a *full-width*
    single-device ``Plan``: one (partition, cores) row per tenant, with
    tenants not placed on ``d`` pinned at the inert ``(P_i, 0)`` point.
    Full width is a deliberate invariant -- every device simulator keeps the
    global tenant indexing, so traces split by placement replay without
    re-indexing and a placement change is just a ``set_plan``.
    """

    placement: tuple[tuple[int, ...], ...]
    routing: tuple[tuple[float, ...], ...]
    device_plans: tuple[Plan, ...]

    @property
    def n_devices(self) -> int:
        return len(self.device_plans)

    @property
    def n_tenants(self) -> int:
        return len(self.placement)

    def device_of(self, tenant: int) -> int:
        """The single device hosting ``tenant`` (errors on split routing)."""
        devs = self.placement[tenant]
        if len(devs) != 1:
            raise ValueError(f"tenant {tenant} routes to {len(devs)} devices")
        return devs[0]


def validate_fleet_plan(
    fleet_plan: FleetPlan,
    tenants: Sequence[TenantSpec],
    fleet: Sequence[DeviceSpec],
) -> None:
    """Enforce the fleet-plan contract (the two-level analogue of the NLIP
    constraint checks in ``validate_plan``).

    Checks, in order: shape consistency; every tenant placed on >= 1
    in-range, duplicate-free device; routing weights aligned with the
    placement, non-negative, summing to 1; every device plan full-width and
    valid under its device's core budget; unplaced tenants pinned inert.
    """
    n, d = len(tenants), len(fleet)
    if fleet_plan.n_tenants != n or len(fleet_plan.routing) != n:
        raise ValueError(
            f"placement/routing cover {fleet_plan.n_tenants}/"
            f"{len(fleet_plan.routing)} tenants, want {n}"
        )
    if fleet_plan.n_devices != d:
        raise ValueError(
            f"plan has {fleet_plan.n_devices} device plans for {d} devices"
        )
    placed: list[set[int]] = [set() for _ in range(d)]
    for i, (devs, wts) in enumerate(zip(fleet_plan.placement, fleet_plan.routing)):
        name = tenants[i].profile.name
        if not devs:
            raise ValueError(f"{name}: tenant placed on no device")
        if len(set(devs)) != len(devs):
            raise ValueError(f"{name}: duplicate devices in placement {devs}")
        for dev in devs:
            if not 0 <= dev < d:
                raise ValueError(f"{name}: device {dev} outside [0,{d})")
            placed[dev].add(i)
        if len(wts) != len(devs):
            raise ValueError(
                f"{name}: {len(wts)} routing weights for {len(devs)} devices"
            )
        if any(w < 0 for w in wts):
            raise ValueError(f"{name}: negative routing weight in {wts}")
        if not math.isclose(sum(wts), 1.0, rel_tol=0.0, abs_tol=_W_SUM_TOL):
            raise ValueError(
                f"{name}: routing weights {wts} sum to {sum(wts)!r}, want 1"
            )
    for dev, (spec, plan) in enumerate(zip(fleet, fleet_plan.device_plans)):
        if len(plan.partition) != n:
            raise ValueError(
                f"device {spec.name}: plan width {len(plan.partition)} != {n} "
                "tenants (device plans are full-width)"
            )
        validate_plan(plan, tenants, spec.cpu_cores)
        for i, t in enumerate(tenants):
            if i in placed[dev]:
                continue
            P_i = t.profile.num_partition_points
            if plan.partition[i] != P_i or plan.cores[i] != 0:
                raise ValueError(
                    f"device {spec.name}: unplaced tenant {t.profile.name} "
                    f"must be pinned at ({P_i}, 0), got "
                    f"({plan.partition[i]}, {plan.cores[i]})"
                )


class FleetTablesCache:
    """Plan tables shared across every device of one class.

    ``PlanTables`` depends only on (profiles, platform); with speed factors
    folded into identity-cached scaled profiles, every device of a class
    hosting the same profile set reuses one table build.  Keys use profile
    *identity* (the same ``is`` contract as ``PlanTables.matches``), so a
    64-device warm re-plan pays the table cost once per (class, mix), not
    per device.
    """

    def __init__(self) -> None:
        self._tables: dict[tuple, PlanTables] = {}

    def tables_for(
        self, device: DeviceSpec, profiles: Sequence[ModelProfile], k_max: int
    ) -> PlanTables:
        key = (device.class_key, tuple(id(p) for p in profiles), k_max)
        pt = self._tables.get(key)
        if pt is None or not pt.matches_profiles(profiles, device.platform):
            pt = PlanTables.build(profiles, device.platform, k_max)
            self._tables[key] = pt
        return pt


def _pin_row(profile: ModelProfile) -> tuple[int, int]:
    """The inert row for a tenant not placed on a device: full-TPU route,
    zero cores.  Valid under every constraint and, with no traffic routed,
    it never touches the device's SRAM, queue, or core budget."""
    return profile.num_partition_points, 0


def _expand(
    sub_plan: Plan,
    members: Sequence[int],
    tenants: Sequence[TenantSpec],
) -> Plan:
    """Widen a subset plan over ``members`` to the full tenant width."""
    part = [_pin_row(t.profile)[0] for t in tenants]
    cores = [0] * len(tenants)
    for j, i in enumerate(members):
        part[i] = sub_plan.partition[j]
        cores[i] = sub_plan.cores[j]
    return Plan(tuple(part), tuple(cores), discipline=sub_plan.discipline)


def _restrict(plan: Plan, members: Sequence[int]) -> Plan:
    """Project a full-width device plan onto its placed-tenant subset."""
    return Plan(
        tuple(plan.partition[i] for i in members),
        tuple(plan.cores[i] for i in members),
        discipline=plan.discipline,
    )


def _climb_device(
    device: DeviceSpec,
    members: Sequence[int],
    tenants: Sequence[TenantSpec],
    k_max: int,
    cache: FleetTablesCache,
    *,
    init_sub: Plan | None = None,
    discipline: DisciplineSpec = FCFS,
    discipline_space: Sequence[DisciplineSpec] | None = None,
    objective: Objective | None = None,
) -> tuple[Plan, float]:
    """Optimize one device's local plan for its placed tenants.

    Returns ``(full-width plan, Eq. 5 objective contribution)``.  The climb
    runs on the placed subset (so the search space is the device's own),
    against tables cached per device class; the batched engine inside
    ``hill_climb`` scores each neighbor frontier in one NumPy pass.
    """
    if not members:
        return _expand(Plan((), (), discipline=discipline), (), tenants), 0.0
    sub = [
        TenantSpec(
            tenants[i].profile.scaled(device.tpu_speed, device.cpu_speed),
            tenants[i].rate,
            deadline=tenants[i].deadline,
        )
        for i in members
    ]
    kwargs: dict = {
        "tables": cache.tables_for(device, [t.profile for t in sub], k_max)
    }
    if objective is not None:
        kwargs["objective"] = objective
    if init_sub is not None:
        kwargs["init_plan"] = init_sub
    if discipline_space is not None:
        kwargs["discipline_space"] = tuple(discipline_space)
    elif discipline != FCFS:
        kwargs["discipline"] = discipline
    plan, obj = hill_climb(sub, device.platform, k_max, **kwargs)
    return _expand(plan, members, tenants), obj


def _device_k_max(device: DeviceSpec, k_max: int | None) -> int:
    return device.cpu_cores if k_max is None else min(k_max, device.cpu_cores)


def _greedy_placement(
    tenants: Sequence[TenantSpec],
    fleet: Sequence[DeviceSpec],
    k_caps: Sequence[int],
) -> list[list[int]]:
    """Load-balanced bin packing: heaviest tenants first, each onto the
    device with the smallest projected (TPU busy time + SRAM-pressure)
    score.  A seed for the per-device climbs, not a final answer -- the
    improvement loop in ``fleet_hill_climb`` migrates what it got wrong.

    Capacity: ``hill_climb`` starts all-CPU (Algorithm 1), so a device can
    host at most as many tenants as it has cores (constraint (8): every
    CPU-suffix model needs a dedicated core).  The packer never exceeds it.
    """
    n_dev = len(fleet)
    if sum(k_caps) < len(tenants):
        raise ValueError(
            f"fleet core capacity {sum(k_caps)} cannot host "
            f"{len(tenants)} tenants (each needs >= 1 core for its "
            "CPU-suffix start)"
        )
    # Per-tenant proxies: full-TPU compute demand and resident footprint.
    demand = [
        t.rate * t.profile.prefix_tpu_time(t.profile.num_partition_points)
        for t in tenants
    ]
    footprint = [float(t.profile.total_weight_bytes) for t in tenants]
    order = sorted(range(len(tenants)), key=lambda i: -demand[i])

    members: list[list[int]] = [[] for _ in range(n_dev)]
    load = [0.0] * n_dev       # offered TPU busy fraction (reference time)
    mem = [0.0] * n_dev        # summed resident footprint
    rate = [0.0] * n_dev
    for i in order:
        best_d, best_score = -1, math.inf
        for d, dev in enumerate(fleet):
            if len(members[d]) >= k_caps[d]:
                continue
            busy = (load[d] + demand[i]) / dev.tpu_speed
            # Overflow beyond SRAM streams over the swap channel on every
            # request the device serves: price it in seconds per second.
            over = max(0.0, mem[d] + footprint[i] - dev.sram_bytes)
            pressure = (over / dev.swap_bw) * (rate[d] + tenants[i].rate)
            score = busy + pressure
            if score < best_score - 1e-15:
                best_d, best_score = d, score
        members[best_d].append(i)
        load[best_d] += demand[i]
        mem[best_d] += footprint[i]
        rate[best_d] += tenants[i].rate
    return members


def fleet_hill_climb(
    tenants: Sequence[TenantSpec],
    fleet: Sequence[DeviceSpec],
    *,
    k_max: int | None = None,
    init: FleetPlan | None = None,
    replan_placement: bool | None = None,
    warm_start: bool = True,
    tables: FleetTablesCache | None = None,
    discipline: DisciplineSpec = FCFS,
    discipline_space: Sequence[DisciplineSpec] | None = None,
    max_moves: int | None = None,
    objective: Objective | None = None,
) -> tuple[FleetPlan, float]:
    """Cluster-level planner: placement + routing + per-device plans.

    Cold path (no ``init``): greedy load-balanced bin packing places each
    tenant on one device, every device's local plan is hill-climbed, then a
    bounded improvement loop repeatedly takes the worst-objective device and
    tries migrating each of its tenants to every other device, committing
    the best strictly-improving move (both affected devices re-climb
    warm-started from their incumbent local plans).

    Warm path (``init`` given, ``replan_placement=False`` -- the default
    when an ``init`` is supplied): placement and routing are kept; each
    device warm-starts ``hill_climb`` from its incumbent plan against the
    new rates.  This is the controller's periodic re-plan: N independent
    warm climbs against class-shared tables, no placement churn.
    ``warm_start=False`` keeps the placement/routing of ``init`` but
    re-climbs every device cold (all-CPU start, Algorithm 1) -- the
    fleet analogue of the single-device cold fallback, for escaping a
    drifted warm basin without migrating tenants.

    ``objective`` selects the metric every per-device climb minimizes and
    the fleet total sums (``repro_torch.core.objective``); ``None`` stays bitwise
    the pinned Eq. 5 mean.  ``k_max=None`` gives every device its own
    ``cpu_cores`` budget; an int
    caps all devices.  ``tables`` carries ``PlanTables`` across calls (one
    build per device class x mix).  Returns ``(FleetPlan, objective)`` where
    the objective is the sum of per-device Eq. 5 penalized objectives --
    request-rate-weighted, so the fleet-wide mean latency is
    ``objective / sum(rates)``.

    Degenerate N=1 contract: a single unit-speed ``from_platform`` device
    makes this function delegate to exactly the ``hill_climb`` call the
    single-device API performs -- same plan, same objective, bitwise.
    """
    if not fleet:
        raise ValueError("fleet must contain at least one device")
    if discipline_space is not None or discipline != FCFS:
        for spec in list(discipline_space or ()) + [discipline]:
            if spec.weights is not None:
                raise ValueError(
                    "per-tenant discipline weights are not supported in "
                    "fleet plans (subset climbs cannot carry full-width "
                    "weight vectors)"
                )
    if replan_placement is None:
        replan_placement = init is None
    cache = tables if tables is not None else FleetTablesCache()
    n_dev = len(fleet)
    k_caps = [_device_k_max(d, k_max) for d in fleet]

    if init is not None and not replan_placement:
        # Warm: keep placement, re-climb each device from its incumbent.
        if init.n_tenants != len(tenants) or init.n_devices != n_dev:
            raise ValueError("init plan shape does not match tenants/fleet")
        members = [
            [i for i in range(len(tenants)) if d in init.placement[i]]
            for d in range(n_dev)
        ]
        plans, objs = [], []
        for d, dev in enumerate(fleet):
            full, obj = _climb_device(
                dev,
                members[d],
                tenants,
                k_caps[d],
                cache,
                init_sub=(
                    _restrict(init.device_plans[d], members[d])
                    if warm_start
                    else None
                ),
                discipline=discipline,
                discipline_space=discipline_space,
                objective=objective,
            )
            plans.append(full)
            objs.append(obj)
        return (
            FleetPlan(init.placement, init.routing, tuple(plans)),
            float(sum(objs)),
        )

    # Cold: greedy packing, per-device climbs, then bounded improvement.
    members = _greedy_placement(tenants, fleet, k_caps)
    plans, objs = [], []
    for d, dev in enumerate(fleet):
        full, obj = _climb_device(
            dev,
            members[d],
            tenants,
            k_caps[d],
            cache,
            discipline=discipline,
            discipline_space=discipline_space,
            objective=objective,
        )
        plans.append(full)
        objs.append(obj)

    if n_dev > 1:
        budget = max_moves if max_moves is not None else len(tenants)
        for _ in range(budget):
            # An infinite objective (overload) ranks worst and any finite
            # rearrangement improves it; only an *empty* worst device (the
            # whole fleet idle or single-tenant devices) ends the loop.
            worst = max(range(n_dev), key=lambda d: objs[d])
            if not members[worst]:
                break
            best = None  # (delta, i, dst, plan_src, obj_src, plan_dst, obj_dst)
            for i in members[worst]:
                rest = [j for j in members[worst] if j != i]
                p_src, o_src = _climb_device(
                    fleet[worst],
                    rest,
                    tenants,
                    k_caps[worst],
                    cache,
                    init_sub=_restrict(plans[worst], rest),
                    discipline=discipline,
                    discipline_space=discipline_space,
                    objective=objective,
                )
                for dst in range(n_dev):
                    if dst == worst or len(members[dst]) >= k_caps[dst]:
                        continue
                    grown = members[dst] + [i]
                    seed = _restrict(plans[dst], members[dst])
                    seed = Plan(
                        seed.partition + (_pin_row(tenants[i].profile)[0],),
                        seed.cores + (0,),
                        discipline=seed.discipline,
                    )
                    p_dst, o_dst = _climb_device(
                        fleet[dst],
                        grown,
                        tenants,
                        k_caps[dst],
                        cache,
                        init_sub=seed,
                        discipline=discipline,
                        discipline_space=discipline_space,
                        objective=objective,
                    )
                    delta = (o_src + o_dst) - (objs[worst] + objs[dst])
                    if not delta < -1e-12:
                        continue
                    if best is None or delta < best[0]:
                        best = (delta, i, dst, p_src, o_src, p_dst, o_dst)
            if best is None:
                break
            _, i, dst, p_src, o_src, p_dst, o_dst = best
            members[worst].remove(i)
            members[dst].append(i)
            plans[worst], objs[worst] = p_src, o_src
            plans[dst], objs[dst] = p_dst, o_dst

    placement = [None] * len(tenants)
    for d in range(n_dev):
        for i in members[d]:
            placement[i] = (d,)
    return (
        FleetPlan(
            placement=tuple(placement),
            routing=tuple((1.0,) for _ in tenants),
            device_plans=tuple(plans),
        ),
        float(sum(objs)),
    )


def round_robin_fleet_plan(
    tenants: Sequence[TenantSpec],
    fleet: Sequence[DeviceSpec],
    *,
    k_max: int | None = None,
    tables: FleetTablesCache | None = None,
) -> tuple[FleetPlan, float]:
    """Naive placement baseline: tenant ``i`` on device ``i % N`` (blind to
    heterogeneity and footprint), then the same per-device ``hill_climb`` as
    the real planner -- so a comparison isolates the *placement* decision."""
    if not fleet:
        raise ValueError("fleet must contain at least one device")
    cache = tables if tables is not None else FleetTablesCache()
    n_dev = len(fleet)
    members = [
        [i for i in range(len(tenants)) if i % n_dev == d] for d in range(n_dev)
    ]
    plans, objs = [], []
    for d, dev in enumerate(fleet):
        full, obj = _climb_device(
            dev, members[d], tenants, _device_k_max(dev, k_max), cache
        )
        plans.append(full)
        objs.append(obj)
    return (
        FleetPlan(
            placement=tuple((i % n_dev,) for i in range(len(tenants))),
            routing=tuple((1.0,) for _ in tenants),
            device_plans=tuple(plans),
        ),
        float(sum(objs)),
    )


def fleet_plan_objective(
    tenants: Sequence[TenantSpec],
    fleet_plan: FleetPlan,
    fleet: Sequence[DeviceSpec],
    *,
    objective: Objective | None = None,
) -> float:
    """Re-score an existing ``FleetPlan`` under fresh tenant rates.

    Sum of per-device Eq. 5 penalized objectives -- the same total
    ``fleet_hill_climb`` reports for the plan it returns (up to batched-vs-
    scalar float noise), but without any search: each device's placed
    subset is projected out with ``_restrict`` and scored directly with
    ``penalized_objective`` on the device-scaled profiles and the routed
    share of each tenant's rate.  This is the verify step of the fleet
    plan cache (``core/plan_cache.py``): one cheap evaluation decides
    whether a memoized plan is still within margin of its stored quality.
    ``objective`` must match the metric the plan was searched under, or the
    comparison is apples-to-oranges -- the cache threads it automatically.
    """
    if fleet_plan.n_tenants != len(tenants) or fleet_plan.n_devices != len(
        fleet
    ):
        raise ValueError("fleet plan shape does not match tenants/fleet")
    total = 0.0
    for d, dev in enumerate(fleet):
        members = [
            i
            for i in range(len(tenants))
            if d in fleet_plan.placement[i]
        ]
        if not members:
            continue
        sub = [
            TenantSpec(
                tenants[i].profile.scaled(dev.tpu_speed, dev.cpu_speed),
                tenants[i].rate
                * fleet_plan.routing[i][fleet_plan.placement[i].index(d)],
                deadline=tenants[i].deadline,
            )
            for i in members
        ]
        total += penalized_objective(
            sub,
            _restrict(fleet_plan.device_plans[d], members),
            dev.platform,
            objective=objective,
        )
    return float(total)


def device_objectives(
    tenants: Sequence[TenantSpec],
    fleet_plan: FleetPlan,
    fleet: Sequence[DeviceSpec],
    *,
    objective: Objective | None = None,
) -> list[float]:
    """Per-device Eq. 5 objective contributions of an existing plan.

    The same scoring ``fleet_plan_objective`` sums, reported per device
    (0.0 for a device hosting nothing).  This is the *predicted* per-device
    request-weighted total latency the fault-aware controller compares
    observed latencies against: ``objective[d] / routed_rate[d]`` is the
    model's expected mean on device ``d``, so a sustained observed mean far
    above it is the throttling signal (``serving.fleet.run_adaptive_fleet``
    with ``fault_aware=True``).
    """
    if fleet_plan.n_tenants != len(tenants) or fleet_plan.n_devices != len(
        fleet
    ):
        raise ValueError("fleet plan shape does not match tenants/fleet")
    out = []
    for d, dev in enumerate(fleet):
        members = [
            i
            for i in range(len(tenants))
            if d in fleet_plan.placement[i]
        ]
        if not members:
            out.append(0.0)
            continue
        sub = [
            TenantSpec(
                tenants[i].profile.scaled(dev.tpu_speed, dev.cpu_speed),
                tenants[i].rate
                * fleet_plan.routing[i][fleet_plan.placement[i].index(d)],
                deadline=tenants[i].deadline,
            )
            for i in members
        ]
        out.append(
            float(
                penalized_objective(
                    sub,
                    _restrict(fleet_plan.device_plans[d], members),
                    dev.platform,
                    objective=objective,
                )
            )
        )
    return out


def evacuate_device(
    tenants: Sequence[TenantSpec],
    fleet: Sequence[DeviceSpec],
    down: Sequence[int],
    *,
    k_max: int | None = None,
    tables: FleetTablesCache | None = None,
    discipline_space: Sequence[DisciplineSpec] | None = None,
    objective: Objective | None = None,
) -> tuple[FleetPlan, float]:
    """Failover placement: re-plan the fleet with ``down`` devices removed.

    A cold ``fleet_hill_climb`` runs over the surviving sub-fleet, and the
    result embeds back at full fleet width: placements re-index to the full
    fleet, down devices host no tenant and carry the inert full-pin device
    plan (``_pin_row`` for every tenant -- valid, traffic-free).  The
    returned objective is the surviving fleet's; the down device
    contributes nothing, exactly as ``fleet_plan_objective`` would score
    the embedded plan.

    Raises ``ValueError`` when the surviving fleet cannot host every tenant
    (constraint (8) core capacity) or every device is down -- callers keep
    the incumbent plan and surface the overload instead of half-placing.
    """
    down_set = set(down)
    for d in down_set:
        if not 0 <= d < len(fleet):
            raise ValueError(f"down device {d} outside the fleet")
    up = [d for d in range(len(fleet)) if d not in down_set]
    if not up:
        raise ValueError("cannot evacuate: every device is down")
    sub_plan, obj = fleet_hill_climb(
        tenants,
        [fleet[d] for d in up],
        k_max=k_max,
        tables=tables,
        discipline_space=discipline_space,
        objective=objective,
    )
    inert = Plan(
        tuple(_pin_row(t.profile)[0] for t in tenants),
        tuple(0 for _ in tenants),
    )
    sub_of = {d: j for j, d in enumerate(up)}
    device_plans = tuple(
        inert if d in down_set else sub_plan.device_plans[sub_of[d]]
        for d in range(len(fleet))
    )
    placement = tuple(
        tuple(up[x] for x in devs) for devs in sub_plan.placement
    )
    return (
        FleetPlan(placement, sub_plan.routing, device_plans),
        obj,
    )


__all__ = [
    "DeviceSpec",
    "FleetPlan",
    "FleetTablesCache",
    "device_objectives",
    "evacuate_device",
    "fleet_hill_climb",
    "fleet_plan_objective",
    "round_robin_fleet_plan",
    "validate_fleet_plan",
]
