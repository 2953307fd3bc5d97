"""Greedy hill-climbing joint partitioning + core allocation (Algorithm 1),
the PropAlloc fair-share routine, baseline policies, and a brute-force NLIP
oracle used by tests on small instances.

Both search routines score candidates through the vectorized plan-space
engine (``latency.penalized_objective_batch`` / ``objective_batch``): all
moves of a hill-climb iteration, and chunks of the oracle's exhaustive
enumeration, are priced in a single NumPy pass.  The seed scalar
implementations are kept (``batch=False``) as the reference the batched
paths are tested byte-identical against.
"""
from __future__ import annotations

import itertools
import math
from typing import Iterator, Sequence

import numpy as np

from repro_torch.core import latency
from repro_torch.core.objective import Objective, deadlines_of, is_default
from repro_torch.core.plan_tables import EvalTables, PlanTables
from repro_torch.core.planner import (
    FCFS,
    DisciplineSpec,
    Plan,
    TenantSpec,
    validate_plan,
)
from repro_torch.hw.specs import Platform


def prop_alloc(
    tenants: Sequence[TenantSpec],
    partition: Sequence[int],
    k_max: int,
) -> tuple[int, ...]:
    """Proportional fair-share integer core allocation (Alg. 1, line 2/10).

    Models with a CPU suffix receive cores proportional to their CPU workload
    ``lambda_i * s_cpu_suffix(1 core)``, subject to constraint (8): at least
    one core for any model with a suffix, zero cores for full-TPU models.
    Largest-remainder rounding keeps the total at ``min(K_max, ...)``.
    """
    n = len(tenants)
    needs_cpu = [p < t.profile.num_partition_points for t, p in zip(tenants, partition)]
    if not any(needs_cpu):
        return (0,) * n
    loads = [
        t.rate * t.profile.suffix_cpu_time_1core(p) if need else 0.0
        for t, p, need in zip(tenants, partition, needs_cpu)
    ]
    n_need = sum(needs_cpu)
    if n_need > k_max:
        raise ValueError(
            f"{n_need} models need a CPU core but only K_max={k_max} available"
        )
    # Start from the constraint floor: 1 core per suffix-bearing model.
    cores = [1 if need else 0 for need in needs_cpu]
    spare = k_max - n_need
    total_load = sum(loads)
    if spare > 0 and total_load > 0:
        shares = [spare * l / total_load for l in loads]
        floors = [int(math.floor(s)) for s in shares]
        for i in range(n):
            cores[i] += floors[i]
        leftover = spare - sum(floors)
        # Largest remainder first; stable tie-break on index.
        order = sorted(range(n), key=lambda i: (-(shares[i] - floors[i]), i))
        for i in order[:leftover]:
            if needs_cpu[i]:
                cores[i] += 1
            else:
                leftover_targets = [j for j in order if needs_cpu[j]]
                if leftover_targets:
                    cores[leftover_targets[0]] += 1
    return tuple(cores)


def prop_alloc_batch(
    tenants: Sequence[TenantSpec],
    partitions: np.ndarray,
    k_max: int,
    *,
    tables: PlanTables | None = None,
    rates: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized PropAlloc over B candidate partitionings at once.

    Returns ``(cores[B, n], feasible[B])``.  Feasible rows reproduce
    ``prop_alloc`` exactly -- same largest-remainder rounding, same stable
    index tie-break, same redirect of leftovers landing on a no-suffix
    tenant; infeasible rows (more suffix models than K_max, where the scalar
    version raises ValueError) come back flagged with unspecified cores.
    """
    P = np.asarray(partitions, dtype=np.intp)
    B, n = P.shape
    if tables is not None and (rates is not None or tables.matches(tenants)):
        num_points, suffix1, ti = tables.num_points, tables.suffix1, tables.tenant_idx
    else:
        # Only the platform-independent tables are needed here.
        num_points = np.array([t.profile.num_partition_points for t in tenants])
        width = int(num_points.max()) + 1
        suffix1 = np.full((n, width), np.nan)
        for i, t in enumerate(tenants):
            suffix1[i, : num_points[i] + 1] = t.profile._suffix_cpu1
        ti = np.arange(n)
    if rates is None:
        rates = np.array([t.rate for t in tenants], dtype=np.float64)[None, :]
    needs = P < num_points[None, :]                             # [B, n]
    n_need = needs.sum(axis=1)
    feasible = n_need <= k_max
    cores = needs.astype(np.int64)  # constraint floor: 1 core per suffix
    loads = rates * suffix1[ti, P] * needs
    spare = k_max - n_need                                      # [B]
    total_load = loads.sum(axis=1)
    dist = feasible & (spare > 0) & (total_load > 0)
    if not dist.any():
        return cores, feasible
    shares = np.divide(
        spare[:, None] * loads,
        total_load[:, None],
        out=np.zeros_like(loads),
        where=dist[:, None],
    )
    floors = np.floor(shares)
    cores += floors.astype(np.int64)
    leftover = (spare - floors.sum(axis=1).astype(np.int64)) * dist
    # Largest remainder first, stable index tie-break: argsort(-rem) with a
    # stable kind is exactly sorted(key=(-(rem), i)).
    order = np.argsort(floors - shares, axis=1, kind="stable")  # [B, n]
    rank = np.argsort(order, axis=1, kind="stable")             # inverse perm
    chosen = rank < leftover[:, None]
    cores += (chosen & needs).astype(np.int64)
    # Leftovers landing on a no-suffix tenant are redirected to the first
    # suffix-bearing tenant in remainder order (seed fallback branch).
    misdirected = (chosen & ~needs).sum(axis=1)
    if misdirected.any():
        needy_rank = np.where(needs, rank, n + 1)
        fallback = np.argmin(needy_rank, axis=1)                # [B]
        cores[np.arange(B), fallback] += np.where(
            needs.any(axis=1), misdirected, 0
        )
    return cores, feasible


# Crossover where the batched engine's fixed NumPy dispatch cost beats the
# scalar loop's per-candidate Python cost (measured on the dev box; the
# scalar side grows ~quadratically in tenants, so the exact value is soft).
_BATCH_MIN_TENANTS = 5


def _ensure_eval_tables(
    tables: PlanTables | EvalTables | None,
    tenants: Sequence[TenantSpec],
    platform: Platform,
    k_max: int,
) -> EvalTables:
    """A prebuilt ``EvalTables`` when it is valid for this (mix, platform,
    k-range); otherwise a rebuild reusing whatever rate-free base is
    available.  The one cache-validity policy shared by every climb path."""
    if (
        isinstance(tables, EvalTables)
        and tables.matches(tenants, platform)
        and tables.k_max >= k_max
    ):
        return tables
    return EvalTables.build(
        tenants,
        platform,
        k_max,
        base=tables.base if isinstance(tables, EvalTables) else tables,
    )


# Public alias: the fleet planner applies the same cache-validity policy
# when it warm-climbs each device against per-device-class tables.
ensure_eval_tables = _ensure_eval_tables


def hill_climb(
    tenants: Sequence[TenantSpec],
    platform: Platform,
    k_max: int,
    *,
    force_alpha_zero: bool = False,
    max_iters: int = 10_000,
    batch: bool | None = None,
    tables: PlanTables | EvalTables | None = None,
    init_plan: Plan | None = None,
    prune: bool = True,
    discipline: DisciplineSpec = FCFS,
    discipline_space: Sequence[DisciplineSpec] | None = None,
    evaluator=None,
    objective: Objective | None = None,
) -> tuple[Plan, float]:
    """Algorithm 1: greedy hill-climbing resource allocation.

    Starts all-CPU, each iteration tries moving h in {1,2} layers of each
    model from CPU to TPU, re-running PropAlloc for each candidate, and
    commits the best strictly-improving move.  The 2-step lookahead lets the
    search hop over single-point latency spikes (local optima).

    With ``batch=True`` all (m, h) moves of an iteration are scored in one
    delta-evaluation call against precomputed rate-aware ``EvalTables``
    (pass rate-free ``tables`` to reuse the platform-dependent half across
    re-plans); ``batch=False`` runs the seed scalar loop; the default
    ``None`` picks by mix size (NumPy dispatch overhead beats the scalar
    loop only from ~_BATCH_MIN_TENANTS tenants up).  All paths return the
    same plans for profiles whose Pareto frontier is full -- every synthetic
    paper profile is (ROADMAP.md invariant; ties within ~1 ulp may resolve
    to either tied plan).  On profiles with dominated points the pruned
    batched walk may legitimately commit different moves than the scalar
    scan; pass ``prune=False`` for a scalar-faithful batched search.

    Incremental re-planning (batched path only):

    * ``prune=True`` walks each tenant's Pareto frontier of partition points
      (``ModelProfile.pareto_points``) instead of the raw 0..P_i axis, so a
      move advances h *frontier positions*.  Dominated points can never be
      the strictly-best committed move, so with smooth profiles (no
      dominated points) the walk is bit-identical to the unpruned one.
    * ``init_plan`` warm-starts the climb from an incumbent plan (the online
      controller passes the previous re-plan's result) and enables the
      h in {-1,-2} down-moves, making the search a bidirectional local
      descent -- successive re-plans are near each other as rates drift, so
      the warm climb converges in a handful of iterations instead of
      re-walking up from all-CPU.

    Discipline co-optimization:

    * ``discipline`` scores the whole climb under one TPU service
      discipline (the returned plan carries it); the FCFS default keeps
      every code path identical to the pre-discipline planner.
    * ``discipline_space`` searches (partition, cores, discipline) jointly:
      the climb runs once per candidate spec -- the discipline axis is tiny
      and its effect on the objective is global, so exhausting it around
      the inner climb *is* the joint search -- and the strictly best plan
      is returned.  Ties resolve non-batching-first, plain FCFS ahead of
      priority/weighted-fair, regardless of how the caller ordered the
      space (on a predicted tie, e.g. a no-swap mix that batching prices
      identically but measurably hurts, or a priority spec the mean
      objective cannot separate from FCFS, the most-FCFS-like plan must
      win).  Specs that cannot batch are all scored on the unmodified
      FCFS objective, so they share one climb and a space of only such
      specs returns the FCFS plan unchanged.

    Device scoring (``evaluator``):

    * ``evaluator`` plugs a ``repro_torch.core.torch_eval.TorchPlanEvaluator``
      (built for exactly these tenants/rates/platform) into the batched walk:
      every iteration scores the *whole* fixed-shape move frontier in one
      device call (invalid and infeasible moves ride along as copies of the
      incumbent and are masked to ``inf`` on the host, so one compiled
      shape serves the entire climb).  The NumPy batched path stays the
      bitwise reference; the evaluator runs in float32 under the
      statistical-equivalence contract -- committed plans are identical
      unless two candidates tie within float32 round-off.

    SLO objectives (``objective``):

    * ``objective`` selects which metric the climb minimizes
      (``repro_torch.core.objective``: mean / ``p_tail(q)`` / ``deadline_miss``
      against the budgets on the mix).  The ``None`` default is bitwise
      the pre-refactor Eq. 5 mean search on every path; non-mean
      objectives score through the same penalty convention, so the
      returned float is the chosen objective's value.

    Returns the final (Plan, predicted objective).
    """
    if evaluator is not None:
        if not evaluator.matches(tenants, platform):
            raise ValueError(
                "evaluator was built for different tenants/rates/platform"
            )
        batch = True
    if batch is None:
        batch = init_plan is not None or len(tenants) >= _BATCH_MIN_TENANTS
    if discipline_space is not None:
        if not discipline_space:
            raise ValueError("discipline_space must not be empty")
        # The evaluation tables are discipline-independent: build them once
        # and share across the per-spec climbs (only the climbs themselves
        # depend on the discipline; the scalar path never touches tables).
        shared = (
            _ensure_eval_tables(tables, tenants, platform, k_max)
            if batch
            else tables
        )
        # Non-batching specs first, plain FCFS ahead of the rest (stable
        # within each group): on a predicted tie -- e.g. a no-swap mix,
        # where batching prices identically but measurably hurts the
        # simulated system, or a priority spec the mean objective cannot
        # distinguish from FCFS -- the most-FCFS-like plan wins no matter
        # how the caller ordered the space.  All non-batching specs are
        # priced on the identical FCFS objective, so one climb scores the
        # whole group: the first spec in tie-break order represents it
        # (the others could only ever tie, and ties keep the first).
        ordered = sorted(
            discipline_space, key=lambda s: (s.batches, s.kind != "fcfs")
        )
        best: tuple[Plan, float] | None = None
        nonbatching_done = False
        for spec in ordered:
            if not spec.batches:
                if nonbatching_done:
                    continue
                nonbatching_done = True
            cand = hill_climb(
                tenants,
                platform,
                k_max,
                force_alpha_zero=force_alpha_zero,
                max_iters=max_iters,
                batch=batch,
                tables=shared,
                init_plan=init_plan,
                prune=prune,
                discipline=spec,
                evaluator=evaluator,
                objective=objective,
            )
            if best is None or cand[1] < best[1]:
                best = cand
        return best
    if not batch:
        if init_plan is not None:
            raise ValueError("init_plan warm start requires the batched path")
        return _hill_climb_scalar(
            tenants,
            platform,
            k_max,
            force_alpha_zero=force_alpha_zero,
            max_iters=max_iters,
            discipline=discipline,
            objective=objective,
        )
    n = len(tenants)
    etab = _ensure_eval_tables(
        evaluator.et if evaluator is not None else tables,
        tenants,
        platform,
        k_max,
    )
    rates = etab.rates[None, :]
    if prune:
        fronts = etab.base.frontiers
    else:
        fronts = tuple(np.arange(P_i + 1) for P_i in etab.num_points)
    flen = np.array([len(f) for f in fronts])
    fr = np.zeros((n, int(flen.max())), dtype=np.intp)
    for i, f in enumerate(fronts):
        fr[i, : len(f)] = f

    ev_slo = (
        {}
        if is_default(objective)
        else {"objective": objective, "deadlines": deadlines_of(tenants)}
    )
    pos = np.zeros(n, dtype=np.intp)
    if init_plan is not None:
        if len(init_plan.partition) != n:
            raise ValueError("init_plan size mismatch")
        # Snap each incumbent point to the nearest frontier point below it
        # (identity when the incumbent came from a pruned search; a snapped
        # interior point stays interior, so PropAlloc feasibility carries
        # over from the incumbent).
        for i, f in enumerate(fronts):
            pos[i] = np.searchsorted(f, init_plan.partition[i], side="right") - 1
    partition = fr[np.arange(n), pos]
    cores = np.array(prop_alloc(tenants, partition, k_max), dtype=np.int64)
    if evaluator is not None:
        l_curr = float(
            evaluator.penalized_objective_batch(
                partition[None, :],
                cores[None, :],
                force_alpha_zero=force_alpha_zero,
                discipline=discipline,
                **ev_slo,
            )[0]
        )
    else:
        l_curr = float(
            latency.penalized_objective_batch(
                tenants,
                partition[None, :],
                cores[None, :],
                platform,
                force_alpha_zero=force_alpha_zero,
                tables=etab,
                discipline=discipline,
                objective=objective,
            )[0]
        )

    # Fixed move set in the scalar iteration order (m ascending, h in (1, 2))
    # so first-minimum argmin tie-breaks identically to the scalar scan; a
    # warm start appends the down-moves after the up-moves it may need to
    # retreat from the incumbent as rates drift back.
    hs = (1, 2, -1, -2) if init_plan is not None else (1, 2)
    move_m = np.repeat(np.arange(n), len(hs))
    move_h = np.tile(np.array(hs), n)

    for _ in range(max_iters):
        cpos = pos[move_m] + move_h
        valid = (cpos >= 0) & (cpos < flen[move_m])
        if not valid.any():
            break
        if evaluator is not None:
            # Fixed-shape frontier: every (m, h) move scored each iteration
            # so the device evaluator sees one shape per mix.  Invalid
            # moves ride along as copies of the incumbent row and are
            # masked out after scoring.
            cpos_c = np.where(valid, cpos, pos[move_m])
            parts = np.repeat(partition[None, :], len(move_m), axis=0)
            parts[np.arange(len(move_m)), move_m] = fr[move_m, cpos_c]
            k_cand, feasible = prop_alloc_batch(
                tenants, parts, k_max, tables=etab.base, rates=rates
            )
            ok = valid & feasible
            if not ok.any():
                break
            k_cand[~feasible] = cores
            objs = evaluator.penalized_objective_batch(
                parts,
                k_cand,
                force_alpha_zero=force_alpha_zero,
                discipline=discipline,
                **ev_slo,
            )
            objs[~ok] = np.inf
            j = int(np.argmin(objs))  # first minimum, like the scalar scan
            if not objs[j] < l_curr:
                break
            partition = parts[j]
            cores = k_cand[j]
            pos[move_m[j]] = cpos[j]
            l_curr = float(objs[j])
            continue
        vm, vpos = move_m[valid], cpos[valid]
        parts = np.repeat(partition[None, :], len(vm), axis=0)
        parts[np.arange(len(vm)), vm] = fr[vm, vpos]
        k_cand, feasible = prop_alloc_batch(
            tenants, parts, k_max, tables=etab.base, rates=rates
        )
        if not feasible.all():
            parts, k_cand = parts[feasible], k_cand[feasible]
            vm, vpos = vm[feasible], vpos[feasible]
            if parts.shape[0] == 0:
                break
        objs = latency.penalized_objective_delta_batch(
            tenants,
            partition,
            cores,
            parts,
            k_cand,
            platform,
            force_alpha_zero=force_alpha_zero,
            tables=etab,
            discipline=discipline,
            objective=objective,
        )
        j = int(np.argmin(objs))  # first minimum, like the scalar scan
        if not objs[j] < l_curr:
            break
        partition = parts[j]
        cores = k_cand[j]
        pos[vm[j]] = vpos[j]
        l_curr = float(objs[j])

    plan = Plan(
        tuple(int(p) for p in partition),
        tuple(int(k) for k in cores),
        discipline,
    )
    validate_plan(plan, tenants, k_max)
    return plan, l_curr


def _hill_climb_scalar(
    tenants: Sequence[TenantSpec],
    platform: Platform,
    k_max: int,
    *,
    force_alpha_zero: bool = False,
    max_iters: int = 10_000,
    discipline: DisciplineSpec = FCFS,
    objective: Objective | None = None,
) -> tuple[Plan, float]:
    """Seed scalar Algorithm 1; reference for the batched path."""
    n = len(tenants)
    partition = [0] * n
    cores = prop_alloc(tenants, partition, k_max)
    plan = Plan(tuple(partition), cores, discipline)
    l_curr = latency.penalized_objective(
        tenants, plan, platform, force_alpha_zero=force_alpha_zero,
        objective=objective,
    )

    for _ in range(max_iters):
        best: tuple[float, int, int, tuple[int, ...]] | None = None
        for m in range(n):
            P_m = tenants[m].profile.num_partition_points
            for h in (1, 2):
                if partition[m] + h > P_m:
                    continue
                cand = list(partition)
                cand[m] += h
                try:
                    k_cand = prop_alloc(tenants, cand, k_max)
                except ValueError:
                    continue
                l_cand = latency.penalized_objective(
                    tenants,
                    Plan(tuple(cand), k_cand, discipline),
                    platform,
                    force_alpha_zero=force_alpha_zero,
                    objective=objective,
                )
                if best is None or l_cand < best[0]:
                    best = (l_cand, m, h, k_cand)
        if best is None or best[0] >= l_curr:
            break
        l_cand, m_star, h_star, k_star = best
        partition[m_star] += h_star
        cores = k_star
        l_curr = l_cand

    plan = Plan(tuple(partition), tuple(cores), discipline)
    validate_plan(plan, tenants, k_max)
    return plan, l_curr


# --------------------------------------------------------------------------
# Baselines (Section V-A3)
# --------------------------------------------------------------------------

def edge_tpu_compiler_plan(tenants: Sequence[TenantSpec]) -> Plan:
    """Industry-default baseline: every model fully on the TPU (p_i = P_i),
    co-compiled, sharing TPU memory; no CPU offload."""
    partition = tuple(t.profile.num_partition_points for t in tenants)
    cores = (0,) * len(tenants)
    return Plan(partition, cores)


def threshold_plan(
    tenants: Sequence[TenantSpec],
    platform: Platform,
    k_max: int,
    *,
    threshold: float = 0.10,
) -> Plan:
    """Threshold-based partitioning baseline: walk segments from the last
    layer backward and offload a segment to CPU if its 1-core CPU time is
    within ``threshold`` of its TPU time.  Ignores queueing/multi-tenancy."""
    partition: list[int] = []
    for t in tenants:
        segs = t.profile.segments
        p = len(segs)
        while p > 0:
            seg = segs[p - 1]
            if seg.cpu_time_1core <= (1.0 + threshold) * seg.tpu_time:
                p -= 1
            else:
                break
        partition.append(p)
    cores = prop_alloc(tenants, partition, k_max)
    return Plan(tuple(partition), cores)


def swapless_plan(
    tenants: Sequence[TenantSpec], platform: Platform, k_max: int
) -> Plan:
    """Full SwapLess: Algorithm 1 with the complete analytic model."""
    plan, _ = hill_climb(tenants, platform, k_max)
    return plan


def swapless_alpha0_plan(
    tenants: Sequence[TenantSpec], platform: Platform, k_max: int
) -> Plan:
    """SwapLess (alpha=0) ablation: plans with queueing but no swap model."""
    plan, _ = hill_climb(tenants, platform, k_max, force_alpha_zero=True)
    return plan


def _feasible_plans(
    tenants: Sequence[TenantSpec],
    k_max: int,
    frontiers: Sequence[Sequence[int]] | None = None,
) -> Iterator[tuple[tuple[int, ...], tuple[int, ...]]]:
    """Every (partition, cores) satisfying constraints (6)-(9), in the seed
    oracle's deterministic enumeration order.  ``frontiers`` restricts each
    tenant's partition axis to its non-dominated points -- a subsequence of
    the full enumeration, so strict ``<`` tracking still returns the first
    optimum in seed order among the surviving plans."""
    if frontiers is None:
        part_ranges: list[Sequence[int]] = [
            range(t.profile.num_partition_points + 1) for t in tenants
        ]
    else:
        part_ranges = [[int(p) for p in f] for f in frontiers]
    for partition in itertools.product(*part_ranges):
        needs = [p < t.profile.num_partition_points for t, p in zip(tenants, partition)]
        if sum(needs) > k_max:
            continue
        core_ranges = [
            range(1, k_max + 1) if need else range(0, 1) for need in needs
        ]
        for cores in itertools.product(*core_ranges):
            if sum(cores) > k_max:
                continue
            yield partition, cores


def brute_force_oracle(
    tenants: Sequence[TenantSpec],
    platform: Platform,
    k_max: int,
    *,
    batch: bool = True,
    chunk_size: int = 4096,
    prune: bool = True,
    discipline: DisciplineSpec = FCFS,
    objective: Objective | None = None,
) -> tuple[Plan, float]:
    """Exhaustive NLIP solve over all feasible (P, K).  Exponential --
    only for tests/validation on small instances.  ``discipline`` scores
    the enumeration under that TPU service discipline (the returned plan
    carries it); the discipline axis itself is not enumerated here.

    The feasible set is streamed through ``objective_batch`` in chunks of
    ``chunk_size`` plans (``batch=False`` restores the seed scalar loop);
    strict ``<`` tracking over the same enumeration order keeps the returned
    plan identical between the two paths, except when two *distinct* plans
    tie to within float round-off (~1 ulp) -- the decomposed batch objective
    rounds differently from the scalar one, so either of the tied optima may
    win.  The objectives themselves always agree to ~1e-12.

    ``prune=True`` sweeps only each tenant's Pareto frontier of partition
    points; dominated points never carry the unique optimum (proof in
    ``ModelProfile.pareto_points``), so the pruned optimum equals the full
    one -- modulo the same tied-plans caveat when a pruned point ties a
    frontier point exactly.
    """
    if not batch:
        return _brute_force_scalar(
            tenants, platform, k_max, discipline=discipline,
            objective=objective,
        )
    tables = EvalTables.build(tenants, platform, k_max)
    best_plan: Plan | None = None
    best_obj = math.inf
    it = _feasible_plans(
        tenants, k_max, frontiers=tables.base.frontiers if prune else None
    )
    while True:
        chunk = list(itertools.islice(it, chunk_size))
        if not chunk:
            break
        parts = np.array([c[0] for c in chunk])
        cores = np.array([c[1] for c in chunk])
        objs = latency.objective_batch(
            tenants, parts, cores, platform, tables=tables,
            discipline=discipline, objective=objective,
        )
        # NaN (zero-rate tenant on an unstable queue) never beats ``best`` in
        # the scalar loop; map to inf so argmin skips it the same way.
        objs = np.where(np.isnan(objs), np.inf, objs)
        j = int(np.argmin(objs))
        if objs[j] < best_obj:
            best_obj = float(objs[j])
            best_plan = Plan(chunk[j][0], chunk[j][1], discipline)
    assert best_plan is not None
    return best_plan, best_obj


def _brute_force_scalar(
    tenants: Sequence[TenantSpec],
    platform: Platform,
    k_max: int,
    *,
    discipline: DisciplineSpec = FCFS,
    objective: Objective | None = None,
) -> tuple[Plan, float]:
    """Seed scalar oracle; reference for the chunked batch path."""
    best_plan: Plan | None = None
    best_obj = math.inf
    for partition, cores in _feasible_plans(tenants, k_max):
        plan = Plan(tuple(partition), tuple(cores), discipline)
        obj = latency.objective(tenants, plan, platform, objective=objective)
        if obj < best_obj:
            best_obj = obj
            best_plan = plan
    assert best_plan is not None
    return best_plan, best_obj
