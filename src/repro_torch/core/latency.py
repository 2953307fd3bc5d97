"""End-to-end latency prediction (Eq. 1-4) for a global configuration."""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np

from repro_torch.core import queueing, swap
from repro_torch.core.objective import Objective, deadlines_of, is_default
from repro_torch.core.plan_tables import (
    PCOL_ACTIVE,
    PCOL_LAM,
    PCOL_Q,
    PCOL_S1,
    PCOL_S2,
    PCOL_SL,
    PCOL_U,
    PCOL_V,
    PCOL_WEIGHT,
    PKCOL_OVERLOAD,
    PKCOL_STATIC,
    EvalTables,
    PlanTables,
)
from repro_torch.core.planner import (
    FCFS,
    DisciplineSpec,
    ModelProfile,
    Plan,
    TenantSpec,
    load_time,
    prefix_service_time,
)
from repro_torch.hw.specs import Platform


def _amortized_tpu_terms(
    tenants: Sequence[TenantSpec],
    partition: Sequence[int],
    alphas: Sequence[float],
    platform: Platform,
    batch_cap: int,
    staleness: float,
) -> tuple[float, float, np.ndarray]:
    """Scalar-path swap-batch aggregates: ``(tpu_wait, rho_tpu, alpha_eff)``.

    Assembles the per-tenant inputs of
    ``queueing.swap_batch_amortization`` from profile lookups -- the same
    formulas the batched evaluator runs on gathered tables, so the two
    paths agree to round-off (the PR-1 batch == scalar invariant extended
    to batching disciplines).
    """
    n = len(tenants)
    rates = np.zeros(n)
    svc = np.zeros(n)
    tl = np.zeros(n)
    for j, (t, p) in enumerate(zip(tenants, partition)):
        if p > 0:
            rates[j] = t.rate
            svc[j] = prefix_service_time(t.profile, p, platform)
            tl[j] = load_time(t.profile, p, platform)
    lam = float(rates.sum())
    s1 = float((rates * svc).sum())
    s2 = float((rates * svc * svc).sum())
    wait, rho, alpha_eff = queueing.swap_batch_amortization(
        lam, s1, s2, rates, np.asarray(alphas, dtype=np.float64), tl, svc,
        batch_cap, staleness=staleness,
    )
    return float(wait), float(rho), alpha_eff


@dataclasses.dataclass(frozen=True)
class LatencyBreakdown:
    """Per-model expected latency components (all seconds)."""

    input_xfer: float
    tpu_wait: float
    tpu_swap: float          # expected inter-model swap: alpha * T_load
    tpu_service: float       # prefix compute + intra-model swap streaming
    boundary_xfer: float
    cpu_wait: float
    cpu_service: float

    @property
    def total(self) -> float:
        return (
            self.input_xfer
            + self.tpu_wait
            + self.tpu_swap
            + self.tpu_service
            + self.boundary_xfer
            + self.cpu_wait
            + self.cpu_service
        )

    @property
    def static(self) -> float:
        """Closed-form deterministic path: transfers + service, no queueing
        and no expected swap.  A lone request in an otherwise idle, warm
        system takes exactly this long -- the round-off-exact reference the
        discrete-event simulator is validated against (tests/test_des.py).
        """
        return (
            self.input_xfer
            + self.tpu_service
            + self.boundary_xfer
            + self.cpu_service
        )

    @property
    def queueing(self) -> float:
        """Stochastic congestion terms (Eq. 1 + Eq. 3 waits): what remains
        of ``total`` beyond ``static`` and the expected swap penalty."""
        return self.tpu_wait + self.cpu_wait


@dataclasses.dataclass(frozen=True)
class SystemPrediction:
    per_model: tuple[LatencyBreakdown, ...]
    tpu_utilization: float
    cpu_utilizations: tuple[float, ...]
    alphas: tuple[float, ...]

    @property
    def stable(self) -> bool:
        return self.tpu_utilization < 1.0 and all(
            u < 1.0 for u in self.cpu_utilizations
        )

    @property
    def overload(self) -> float:
        """Total excess utilization; 0 when all queues are stable."""
        return max(0.0, self.tpu_utilization - 1.0) + sum(
            max(0.0, u - 1.0) for u in self.cpu_utilizations
        )

    @property
    def latencies(self) -> tuple[float, ...]:
        return tuple(b.total for b in self.per_model)

    @property
    def static_latencies(self) -> tuple[float, ...]:
        """Per-model closed-form static latency (no queueing, no swap)."""
        return tuple(b.static for b in self.per_model)

    @property
    def queueing_latencies(self) -> tuple[float, ...]:
        """Per-model predicted wait (TPU + CPU queueing only)."""
        return tuple(b.queueing for b in self.per_model)

    def weighted_latency(self, tenants: Sequence[TenantSpec]) -> float:
        """Objective of Eq. 5: sum_i lambda_i * T_e2e_i."""
        return sum(t.rate * b.total for t, b in zip(tenants, self.per_model))

    def mean_latency(self, tenants: Sequence[TenantSpec]) -> float:
        """Request-weighted mean latency (what the paper's figures report)."""
        tot = sum(t.rate for t in tenants)
        if tot <= 0:
            return 0.0
        return self.weighted_latency(tenants) / tot


def tpu_service_distribution(
    tenants: Sequence[TenantSpec],
    partition: Sequence[int],
    alphas: Sequence[float],
    platform: Platform,
) -> tuple[list[float], list[float]]:
    """The TPU service-time mixture of Eq. 2 as (weights, atoms).

    Each TPU-active model contributes two atoms: a hit (prob 1-alpha) with
    service ``s_tpu`` and a miss (prob alpha) with service ``T_load + s_tpu``.
    Using the full two-atom mixture gives the exact E[S^2] needed by
    Pollaczek-Khinchine (the paper states only the mean, Eq. 2; the second
    moment follows from the same distribution).
    """
    weights: list[float] = []
    atoms: list[float] = []
    for t, p, a in zip(tenants, partition, alphas):
        if p <= 0:
            continue
        s = prefix_service_time(t.profile, p, platform)
        tl = load_time(t.profile, p, platform)
        if a > 0.0:
            weights.extend([t.rate * (1.0 - a), t.rate * a])
            atoms.extend([s, s + tl])
        else:
            weights.append(t.rate)
            atoms.append(s)
    return weights, atoms


def predict(
    tenants: Sequence[TenantSpec],
    plan: Plan,
    platform: Platform,
    *,
    force_alpha_zero: bool = False,
) -> SystemPrediction:
    """Predict per-model end-to-end latency under (P, K)  --  Eq. 4.

    ``force_alpha_zero`` implements the paper's "SwapLess (alpha=0)" ablation
    baseline: the queueing terms are kept but inter-model swapping is ignored.

    A batching ``plan.discipline`` (swap_batch with cap > 1) swaps the Eq. 2
    mixture for the batch-amortized model
    (``queueing.swap_batch_amortization``); the reported ``alphas`` are then
    the amortized effective switch-in probabilities.  The ``priority`` /
    ``weighted_fair`` disciplines keep the FCFS aggregate prediction: they
    redistribute waiting between tenants but are work-conserving and
    service-blind, so the mean terms the Eq. 5 objective sums are conserved
    and they batch nothing.
    """
    partition, cores = plan.partition, plan.cores
    if force_alpha_zero:
        alphas = [0.0] * len(tenants)
    else:
        alphas = swap.weight_miss_probs(tenants, partition, platform)

    lam_tpu = swap.tpu_arrival_rate(tenants, partition)
    if plan.discipline.batches and not force_alpha_zero:
        tpu_wait, rho_tpu, alphas = _amortized_tpu_terms(
            tenants, partition, alphas, platform,
            plan.discipline.batch_cap, plan.discipline.staleness,
        )
        alphas = [float(a) for a in alphas]
    else:
        weights, atoms = tpu_service_distribution(
            tenants, partition, alphas, platform
        )
        es, es2 = queueing.mixture_moments(weights, atoms)
        tpu_wait = queueing.mg1_wait(lam_tpu, es, es2)
        rho_tpu = lam_tpu * es

    per_model: list[LatencyBreakdown] = []
    cpu_utils: list[float] = []
    for t, p, k, a in zip(tenants, partition, cores, alphas):
        prof = t.profile
        P_i = prof.num_partition_points
        on_tpu = p > 0
        on_cpu = p < P_i

        input_xfer = prof.input_bytes / platform.swap_bw if on_tpu else 0.0
        t_wait = tpu_wait if on_tpu else 0.0
        t_swap = a * load_time(prof, p, platform) if on_tpu else 0.0
        t_serv = prefix_service_time(prof, p, platform) if on_tpu else 0.0
        b_xfer = prof.boundary_bytes(p) / platform.swap_bw if on_tpu and on_cpu else 0.0

        if on_cpu:
            # The paper's runtime executes each request's suffix on one
            # worker thread of a model-specific pool of size k_i (Sec. IV);
            # parallelism comes from serving k_i requests concurrently, so
            # the M/D/k pool has k servers of per-server rate 1/s_cpu(1 core).
            s_one = prof.suffix_cpu_time(p, 1)
            mu_one = 1.0 / s_one if s_one > 0 else math.inf
            c_wait = queueing.mdk_wait(t.rate, mu_one, k)
            c_serv = s_one
            cpu_utils.append(t.rate * s_one / max(k, 1))
        else:
            c_wait = 0.0
            c_serv = 0.0
            cpu_utils.append(0.0)

        per_model.append(
            LatencyBreakdown(
                input_xfer=input_xfer,
                tpu_wait=t_wait,
                tpu_swap=t_swap,
                tpu_service=t_serv,
                boundary_xfer=b_xfer,
                cpu_wait=c_wait,
                cpu_service=c_serv,
            )
        )
    return SystemPrediction(
        per_model=tuple(per_model),
        tpu_utilization=rho_tpu,
        cpu_utilizations=tuple(cpu_utils),
        alphas=tuple(alphas),
    )


def objective(
    tenants: Sequence[TenantSpec],
    plan: Plan,
    platform: Platform,
    *,
    force_alpha_zero: bool = False,
    objective: Objective | None = None,
) -> float:
    """Eq. 5 objective; ``inf`` when any queue is unstable.

    ``objective`` selects the opt-in SLO objectives of
    ``repro_torch.core.objective``; ``None`` (or an explicit mean spec) is the
    pinned Eq. 5 path above.
    """
    pred = predict(tenants, plan, platform, force_alpha_zero=force_alpha_zero)
    if not is_default(objective):
        return _slo_value(tenants, pred, objective)
    return pred.weighted_latency(tenants)


def _miss_prob(wt, rho_t, wc, rho_c, slack):
    """P(W_tpu + W_cpu > slack) under the exponential-tail wait model.

    The two waits are treated as independent, with the slack split between
    them proportionally to their means (all the slack goes to the only
    nonzero wait when one is zero).  Monotone non-increasing in ``slack``;
    1 when ``slack < 0`` (the static path already blew the budget) and when
    either queue is unstable (``wait_exceed_prob`` maps infinite waits to
    1).  Element-wise over any broadcastable shapes -- the scalar
    reference, the batched evaluator, and ``benchmarks/model_vs_sim`` all
    run this exact function.
    """
    wt = np.asarray(wt, dtype=np.float64)
    wc = np.asarray(wc, dtype=np.float64)
    slack = np.asarray(slack, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        wsum = wt + wc
        ft = np.where(wsum > 0.0, wt / wsum, 0.0)
        fc = np.where(wsum > 0.0, wc / wsum, 0.0)
        # inf * 0 guards: an all-slack-to-one-side split stays exact and an
        # infinite budget never produces NaN shares.
        sa = np.where(ft > 0.0, slack * ft, 0.0)
        sb = np.where(fc > 0.0, slack * fc, 0.0)
        pt = queueing.wait_exceed_prob(wt, rho_t, sa)
        pc = queueing.wait_exceed_prob(wc, rho_c, sb)
        miss = 1.0 - (1.0 - pt) * (1.0 - pc)
    return np.where(slack < 0.0, 1.0, miss)


def predict_tail_latencies(
    tenants: Sequence[TenantSpec],
    plan: Plan,
    platform: Platform,
    q: float = 0.99,
    *,
    force_alpha_zero: bool = False,
    pred: SystemPrediction | None = None,
) -> np.ndarray:
    """Per-tenant analytic q-quantile latency ``T_i(q)``.

    ``T_i(q)`` replaces each mean queueing delay of the Eq. 4 breakdown
    with its q-quantile under the M/G/1 exponential-tail model
    (``queueing.wait_tail_quantile``); statics and the expected swap stay
    at their means.  Summing the marginal TPU and CPU quantiles is
    conservative -- ``benchmarks/model_vs_sim.py`` maps the error against
    the DES p99.  Off-TPU tenants get a zero TPU term; unstable queues
    produce ``inf``.
    """
    if pred is None:
        pred = predict(tenants, plan, platform, force_alpha_zero=force_alpha_zero)
    rho_t = pred.tpu_utilization
    out = np.empty(len(tenants), dtype=np.float64)
    for i, b in enumerate(pred.per_model):
        tail_t = float(queueing.wait_tail_quantile(b.tpu_wait, rho_t, q))
        tail_c = float(
            queueing.wait_tail_quantile(b.cpu_wait, pred.cpu_utilizations[i], q)
        )
        out[i] = b.static + b.tpu_swap + tail_t + tail_c
    return out


def predict_miss_probs(
    tenants: Sequence[TenantSpec],
    plan: Plan,
    platform: Platform,
    deadlines: np.ndarray | None = None,
    *,
    force_alpha_zero: bool = False,
    pred: SystemPrediction | None = None,
) -> np.ndarray:
    """Per-tenant analytic deadline-miss probability ``P(T_i > d_i)``.

    ``deadlines`` defaults to the budgets carried on the mix
    (``TenantSpec.deadline``; tenants without one never miss).  The miss
    splits each tenant's slack ``d_i - static_i - swap_i`` across the TPU
    and CPU waits -- see ``_miss_prob`` for the model and its conventions.
    Monotone non-increasing in every deadline.
    """
    if pred is None:
        pred = predict(tenants, plan, platform, force_alpha_zero=force_alpha_zero)
    if deadlines is None:
        deadlines = deadlines_of(tenants)
    d = np.asarray(deadlines, dtype=np.float64)
    rho_t = pred.tpu_utilization
    out = np.empty(len(tenants), dtype=np.float64)
    for i, b in enumerate(pred.per_model):
        slack = d[i] - b.static - b.tpu_swap
        out[i] = float(
            _miss_prob(
                b.tpu_wait, rho_t, b.cpu_wait, pred.cpu_utilizations[i], slack
            )
        )
    return out


def _slo_value(
    tenants: Sequence[TenantSpec],
    pred: SystemPrediction,
    objective: Objective,
) -> float:
    """Scalar-path SLO objective value from a computed prediction.

    ``p_tail``: ``sum_i lambda_i * T_i(q)`` -- Eq. 5 with quantile
    latencies.  ``deadline_miss``: ``sum_i lambda_i * P(T_i > d_i)``, the
    rate of deadline misses per second.  Zero-rate tenants on unstable
    queues contribute ``0 * inf = NaN`` exactly as the mean path does.
    """
    rates = np.array([t.rate for t in tenants], dtype=np.float64)
    if objective.kind == "p_tail":
        vals = predict_tail_latencies(tenants, None, None, objective.q, pred=pred)
    else:
        vals = predict_miss_probs(tenants, None, None, pred=pred)
    return float(np.sum(rates * vals))


# Any finite objective is < _PENALTY_BASE; overload adds gradient on top so
# the hill-climb can walk *out* of infeasible regions (the all-CPU start is
# often unstable at the paper's moderate loads).
_PENALTY_BASE = 1e9


def penalized_objective(
    tenants: Sequence[TenantSpec],
    plan: Plan,
    platform: Platform,
    *,
    force_alpha_zero: bool = False,
    objective: Objective | None = None,
) -> float:
    """Eq. 5 objective with a smooth infeasibility penalty.

    Stable configurations return their true weighted latency.  Unstable ones
    return ``_PENALTY_BASE * (1 + overload)`` so that moves reducing excess
    utilization still rank as improvements -- this is what lets Algorithm 1's
    all-CPU initialization climb into the feasible region.

    This is the allocator's hot path (hundreds of evaluations per
    re-planning); it computes the scalar objective without materializing the
    per-model breakdown dataclasses ``predict`` builds for reporting.

    ``objective`` selects the opt-in SLO objectives (same penalty and
    feasibility semantics, SLO value instead of the weighted mean); the
    ``None`` default is the pinned pre-refactor mean path below.
    """
    if not is_default(objective):
        pred = predict(
            tenants, plan, platform, force_alpha_zero=force_alpha_zero
        )
        total = _slo_value(tenants, pred, objective)
        over = pred.overload
        if over == 0.0 and math.isfinite(total):
            return total
        return _PENALTY_BASE * (1.0 + over)
    partition, cores = plan.partition, plan.cores
    if force_alpha_zero:
        alphas = [0.0] * len(tenants)
    else:
        alphas = swap.weight_miss_probs(tenants, partition, platform)

    lam_tpu = swap.tpu_arrival_rate(tenants, partition)
    if plan.discipline.batches and not force_alpha_zero:
        tpu_wait, rho_tpu, alphas = _amortized_tpu_terms(
            tenants, partition, alphas, platform,
            plan.discipline.batch_cap, plan.discipline.staleness,
        )
    else:
        weights, atoms = tpu_service_distribution(
            tenants, partition, alphas, platform
        )
        es, es2 = queueing.mixture_moments(weights, atoms)
        rho_tpu = lam_tpu * es
        tpu_wait = queueing.mg1_wait(lam_tpu, es, es2)

    total = 0.0
    overload = max(0.0, rho_tpu - 1.0)
    bw = platform.swap_bw
    for t, p, k, a in zip(tenants, partition, cores, alphas):
        prof = t.profile
        P_i = prof.num_partition_points
        lat = 0.0
        if p > 0:
            lat += (
                prof.input_bytes / bw
                + tpu_wait
                + a * load_time(prof, p, platform)
                + prefix_service_time(prof, p, platform)
            )
            if p < P_i:
                lat += prof.boundary_bytes(p) / bw
        if p < P_i:
            s_one = prof.suffix_cpu_time(p, 1)
            overload += max(0.0, t.rate * s_one / max(k, 1) - 1.0)
            mu_one = 1.0 / s_one if s_one > 0 else math.inf
            lat += queueing.mdk_wait(t.rate, mu_one, k) + s_one
        total += t.rate * lat
    if overload == 0.0 and math.isfinite(total):
        return total
    return _PENALTY_BASE * (1.0 + overload)


# --------------------------------------------------------------------------
# Vectorized plan-space evaluation engine
# --------------------------------------------------------------------------
#
# The scalar objective above walks Python loops per candidate; Algorithm 1
# needs hundreds of candidate evaluations per re-plan and the paper budgets
# <2 ms for the whole invocation.  The batch evaluator below scores B plans
# at once with NumPy gathers over precomputed PlanTables.
#
# Invariant (enforced by tests/test_batch_eval.py): for every plan,
# penalized_objective_batch == penalized_objective and objective_batch ==
# objective up to float round-off (~1e-12 relative).  Any future change to
# the analytic model must land in both paths.

def _resolve_tables(
    tenants: Sequence[TenantSpec],
    platform: Platform,
    cores: np.ndarray,
    tables: PlanTables | EvalTables | None,
) -> EvalTables:
    """Rate-aware tables for this mix, reusing whatever half of ``tables``
    is still valid (EvalTables -> as-is; stale rates -> rebuild on the same
    PlanTables; profile/platform mismatch -> full rebuild)."""
    if isinstance(tables, EvalTables) and tables.matches(tenants, platform):
        et = tables
    else:
        # Reuse the rate-free half when only the rates went stale; build
        # discards it if the profiles or platform do not match.
        base = tables.base if isinstance(tables, EvalTables) else tables
        et = EvalTables.build(
            tenants,
            platform,
            int(max(np.max(cores, initial=1), base.k_max if base else 1)),
            base=base,
        )
    if cores.size and int(cores.max()) > et.k_max:
        # Core counts beyond the prebuilt k-axis: extend once.
        et = EvalTables.build(tenants, platform, int(cores.max()), base=et.base)
    return et


def _batch_eval(
    tenants: Sequence[TenantSpec],
    partitions: np.ndarray,
    cores: np.ndarray,
    platform: Platform,
    *,
    force_alpha_zero: bool,
    tables: PlanTables | EvalTables | None,
    discipline: DisciplineSpec = FCFS,
    objective: Objective | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Shared core: per-plan (weighted_latency_total, overload) arrays.

    ``partitions``/``cores`` are int arrays of shape [B, n].  Every row must
    already satisfy the box constraints 0 <= p_i <= P_i (out-of-range gathers
    hit NaN poison in the tables and fail loudly in tests).

    The Eq. 1-5 objective is evaluated through the ``EvalTables``
    decomposition (see plan_tables.py): two gathers + two row-sums recover
    every per-tenant aggregate, and the remaining work is O(1) vector math
    on [B]-shaped arrays -- the per-candidate cost no longer scales with the
    per-tenant Python loop of the scalar path.
    """
    P = np.asarray(partitions, dtype=np.intp)
    K = np.asarray(cores, dtype=np.intp)
    if P.ndim != 2 or P.shape != K.shape:
        raise ValueError(f"expected [B, n] partitions/cores, got {P.shape}/{K.shape}")
    et = _resolve_tables(tenants, platform, K, tables)

    if not is_default(objective):
        return _batch_eval_slo(
            tenants,
            et,
            P,
            K,
            force_alpha_zero=force_alpha_zero,
            discipline=discipline,
            objective=objective,
        )
    ti = et.tenant_idx
    A = et.pstack[ti, P].sum(axis=1)       # [B, 9] per-tenant aggregates
    F = et.pkstack[ti, P, K].sum(axis=1)   # [B, 2] static latency + overload
    return _aggregate_objective(
        et, A, F, P, force_alpha_zero=force_alpha_zero, discipline=discipline
    )


def _aggregate_objective(
    et: EvalTables,
    A: np.ndarray,
    F: np.ndarray,
    P: np.ndarray,
    *,
    force_alpha_zero: bool,
    discipline: DisciplineSpec = FCFS,
) -> tuple[np.ndarray, np.ndarray]:
    """O(1)-per-plan tail of the decomposed objective: [B, 9] / [B, 2]
    per-tenant aggregates -> (weighted_latency_total, overload).

    A batching ``discipline`` routes through the batch-amortized swap model
    instead of the Eq. 10 collapse; the per-tenant amortization weights
    depend on the plan's own fixed-point wait, so this branch pays two
    extra per-tenant gathers from the rate-free tables ([B, n] instead of
    the aggregate [B, 9]) -- still one NumPy pass, and exactly the formulas
    the scalar ``_amortized_tpu_terms`` runs.
    """
    lam = A[:, PCOL_LAM]
    S1 = A[:, PCOL_S1]
    S2 = A[:, PCOL_S2]

    if discipline.batches and not force_alpha_zero:
        return _aggregate_objective_batched_swap(et, A, F, P, discipline)

    with np.errstate(divide="ignore", invalid="ignore"):
        if force_alpha_zero:
            swap_term = 0.0
            rho_tpu = S1
            es2_num = S2
        else:
            # Eq. 10 shared-occupancy regime: alphas_i = 1 - r_i/lam for
            # every TPU-active tenant, which collapses the swap and moment
            # sums to (SL - Q/lam) and (U - V/lam).
            shared = (
                (A[:, PCOL_WEIGHT] > et.sram_bytes)
                & (A[:, PCOL_ACTIVE] > 1.0)
                & (lam > 0.0)
            )
            inv_lam = np.divide(
                1.0, lam, out=np.zeros_like(lam), where=shared
            )
            swap_term = (A[:, PCOL_SL] - A[:, PCOL_Q] * inv_lam) * shared
            rho_tpu = S1 + swap_term
            es2_num = S2 + (A[:, PCOL_U] - A[:, PCOL_V] * inv_lam) * shared

        # Pollaczek-Khinchine (Eq. 1): lam * E[S^2] == es2_num and
        # lam * E[S] == rho, so the idle-queue case (lam == 0) falls out
        # naturally: es2_num == 0 -> wait == 0, as in scalar mg1_wait.
        tpu_wait = np.where(
            rho_tpu >= 1.0, np.inf, es2_num / (2.0 * (1.0 - rho_tpu))
        )
        total = F[:, PKCOL_STATIC] + lam * tpu_wait + swap_term
        if (et.rates <= 0.0).any():
            # The scalar objective multiplies rate * latency per tenant, so a
            # zero-rate tenant sitting on an unstable TPU queue contributes
            # 0 * inf = NaN to the scalar total; reproduce that here instead
            # of the inf the decomposed sum would otherwise give.
            zr_on_tpu = ((et.rates <= 0.0)[None, :] & (P > 0)).any(axis=1)
            total = np.where(zr_on_tpu & np.isinf(tpu_wait), np.nan, total)
        overload = np.maximum(0.0, rho_tpu - 1.0) + F[:, PKCOL_OVERLOAD]
    return total, overload


def _aggregate_objective_batched_swap(
    et: EvalTables,
    A: np.ndarray,
    F: np.ndarray,
    P: np.ndarray,
    discipline: DisciplineSpec,
) -> tuple[np.ndarray, np.ndarray]:
    """Swap-batch tail of the decomposed objective (see
    ``queueing.swap_batch_amortization`` for the model)."""
    lam = A[:, PCOL_LAM]
    ti = et.tenant_idx
    on = P > 0
    r = np.where(on, et.rates[None, :], 0.0)            # [B, n]
    svc = np.where(on, et.base.prefix_service[ti, P], 0.0)
    tl = np.where(on, et.base.load[ti, P], 0.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        shared = (
            (A[:, PCOL_WEIGHT] > et.sram_bytes)
            & (A[:, PCOL_ACTIVE] > 1.0)
            & (lam > 0.0)
        )
        # Eq. 10 shared-occupancy alphas, per tenant (the collapse to the
        # (SL - Q/lam) aggregates is FCFS-only: amortization reweights each
        # tenant's summand individually).
        alphas = np.where(
            shared[:, None] & on,
            np.maximum(0.0, 1.0 - r / np.where(lam > 0, lam, 1.0)[:, None]),
            0.0,
        )
        wait, rho, alpha_eff = queueing.swap_batch_amortization(
            lam, A[:, PCOL_S1], A[:, PCOL_S2], r, alphas, tl, svc,
            discipline.batch_cap, staleness=discipline.staleness,
        )
        swap_latency = (r * alpha_eff * tl).sum(axis=-1)
        total = F[:, PKCOL_STATIC] + lam * wait + swap_latency
        if (et.rates <= 0.0).any():
            # Same zero-rate NaN convention as the FCFS tail: a zero-rate
            # tenant on an unstable TPU queue contributes 0 * inf = NaN in
            # the scalar sum.
            zr_on_tpu = ((et.rates <= 0.0)[None, :] & (P > 0)).any(axis=1)
            total = np.where(zr_on_tpu & np.isinf(wait), np.nan, total)
        overload = np.maximum(0.0, rho - 1.0) + F[:, PKCOL_OVERLOAD]
    return total, overload


def _batch_eval_slo(
    tenants: Sequence[TenantSpec],
    et: EvalTables,
    P: np.ndarray,
    K: np.ndarray,
    *,
    force_alpha_zero: bool,
    discipline: DisciplineSpec,
    objective: Objective,
) -> tuple[np.ndarray, np.ndarray]:
    """SLO (non-mean) tail of the batched evaluator: (value, overload).

    The mean objective's linear decomposition (``F_STATIC + lam * W +
    swap``) cannot price nonlinear per-tenant objectives, so this path
    gathers the per-tenant static pieces from the rate-free tables ([B, n]
    instead of the aggregate [B, 9]) and runs exactly the formulas the
    scalar ``predict_tail_latencies`` / ``predict_miss_probs`` reference
    runs -- the batch == scalar invariant extends to every objective at
    <= 1e-9 relative (tests/test_slo.py).
    """
    ti = et.tenant_idx
    A = et.pstack[ti, P].sum(axis=1)       # [B, 9] per-tenant aggregates
    F = et.pkstack[ti, P, K].sum(axis=1)   # [B, 2] static latency + overload
    lam = A[:, PCOL_LAM]
    on = P > 0
    on_cpu = P < et.num_points[None, :]
    r_full = np.broadcast_to(et.rates[None, :], P.shape)
    r = np.where(on, r_full, 0.0)
    svc = np.where(on, et.base.prefix_service[ti, P], 0.0)
    tl = np.where(on, et.base.load[ti, P], 0.0)

    with np.errstate(divide="ignore", invalid="ignore"):
        if force_alpha_zero:
            alphas = np.zeros_like(r)
        else:
            shared = (
                (A[:, PCOL_WEIGHT] > et.sram_bytes)
                & (A[:, PCOL_ACTIVE] > 1.0)
                & (lam > 0.0)
            )
            # Eq. 10 shared-occupancy alphas, per tenant (the scalar path's
            # swap.weight_miss_probs; the mean path's (SL - Q/lam) collapse
            # is the aggregate of exactly these).
            alphas = np.where(
                shared[:, None] & on,
                np.maximum(0.0, 1.0 - r / np.where(lam > 0, lam, 1.0)[:, None]),
                0.0,
            )
        if discipline.batches and not force_alpha_zero:
            tpu_wait, rho_tpu, alpha_eff = queueing.swap_batch_amortization(
                lam, A[:, PCOL_S1], A[:, PCOL_S2], r, alphas, tl, svc,
                discipline.batch_cap, staleness=discipline.staleness,
            )
        else:
            alpha_eff = alphas
            sl = (r * alpha_eff * tl).sum(axis=-1)
            u = (r * alpha_eff * tl * (2.0 * svc + tl)).sum(axis=-1)
            rho_tpu = A[:, PCOL_S1] + sl
            es2_num = A[:, PCOL_S2] + u
            tpu_wait = np.where(
                rho_tpu >= 1.0, np.inf, es2_num / (2.0 * (1.0 - rho_tpu))
            )

        swap_i = alpha_eff * tl                                   # [B, n]
        # Per-tenant CPU pool: the PKCOL_STATIC fold buries the mdk wait, so
        # recompute it from the one-core suffix table (same scalar formula).
        s1c = np.where(on_cpu, et.base.suffix1[ti, P], 0.0)
        mu_one = np.where(s1c > 0.0, 1.0 / np.where(s1c > 0.0, s1c, 1.0), np.inf)
        cpu_wait = queueing.mdk_wait_batch(r_full, mu_one, K)
        cpu_wait = np.where(on_cpu, cpu_wait, 0.0)
        rho_cpu = r_full * s1c / np.maximum(K, 1)
        # Per-tenant static pieces (input transfer, prefix service, boundary
        # transfer on genuinely split plans, one-core suffix service).
        bnd = np.where(on & on_cpu, et.base.boundary[ti, P], 0.0)
        static = (
            np.where(on, et.base.input_xfer[None, :], 0.0) + svc + bnd + s1c
        )

        wt = np.where(on, tpu_wait[:, None], 0.0)
        if objective.kind == "p_tail":
            tail_t = queueing.wait_tail_quantile(
                wt, rho_tpu[:, None], objective.q
            )
            tail_c = queueing.wait_tail_quantile(cpu_wait, rho_cpu, objective.q)
            vals = static + swap_i + tail_t + tail_c
        else:
            d = deadlines_of(tenants)[None, :]
            slack = d - static - swap_i
            vals = _miss_prob(wt, rho_tpu[:, None], cpu_wait, rho_cpu, slack)
        value = (r_full * vals).sum(axis=1)
        overload = np.maximum(0.0, rho_tpu - 1.0) + F[:, PKCOL_OVERLOAD]
    return value, overload


def objective_batch(
    tenants: Sequence[TenantSpec],
    partitions: np.ndarray,
    cores: np.ndarray,
    platform: Platform,
    *,
    force_alpha_zero: bool = False,
    tables: PlanTables | EvalTables | None = None,
    discipline: DisciplineSpec = FCFS,
    objective: Objective | None = None,
) -> np.ndarray:
    """Eq. 5 objective for B candidate plans at once; ``inf`` where unstable.

    Batched equivalent of ``objective``: element b equals
    ``objective(tenants, Plan(partitions[b], cores[b], discipline),
    platform)``.
    """
    total, _ = _batch_eval(
        tenants,
        partitions,
        cores,
        platform,
        force_alpha_zero=force_alpha_zero,
        tables=tables,
        discipline=discipline,
        objective=objective,
    )
    return total


def penalized_objective_batch(
    tenants: Sequence[TenantSpec],
    partitions: np.ndarray,
    cores: np.ndarray,
    platform: Platform,
    *,
    force_alpha_zero: bool = False,
    tables: PlanTables | EvalTables | None = None,
    discipline: DisciplineSpec = FCFS,
    objective: Objective | None = None,
) -> np.ndarray:
    """Batched ``penalized_objective``: one pass of array ops over B plans.

    Element b equals ``penalized_objective(tenants, Plan(partitions[b],
    cores[b], discipline), platform)`` up to float round-off; pass
    precomputed ``tables`` (see ``PlanTables.for_tenants``) to skip table
    construction on repeated calls -- the allocator's hot path does.
    """
    total, overload = _batch_eval(
        tenants,
        partitions,
        cores,
        platform,
        force_alpha_zero=force_alpha_zero,
        tables=tables,
        discipline=discipline,
        objective=objective,
    )
    feasible = (overload == 0.0) & np.isfinite(total)
    return np.where(feasible, total, _PENALTY_BASE * (1.0 + overload))


def penalized_objective_delta_batch(
    tenants: Sequence[TenantSpec],
    base_partition: np.ndarray,
    base_cores: np.ndarray,
    partitions: np.ndarray,
    cores: np.ndarray,
    platform: Platform,
    *,
    force_alpha_zero: bool = False,
    tables: PlanTables | EvalTables | None = None,
    discipline: DisciplineSpec = FCFS,
    objective: Objective | None = None,
) -> np.ndarray:
    """``penalized_objective_batch`` for neighbors of one base plan.

    Candidate b's per-tenant aggregates are recovered as
    ``base_aggregate + (new - old)`` over only the (tenant, p/k) entries
    where row b differs from ``(base_partition, base_cores)`` -- the
    hill-climb's neighbor moves change one tenant's partition and a handful
    of core counts, so each candidate costs O(changed) gathered table rows
    instead of the full O(n) re-gather of ``penalized_objective_batch``.
    The base aggregates themselves are re-summed fresh on every call (one
    O(n) pass), so the delta rounding never compounds across hill-climb
    iterations: each value differs from the full re-gather by at most the
    one add/subtract round-off (~1 ulp), which is inside the plan-identity
    tie tolerance recorded in ROADMAP.md.
    """
    P = np.asarray(partitions, dtype=np.intp)
    K = np.asarray(cores, dtype=np.intp)
    if P.ndim != 2 or P.shape != K.shape:
        raise ValueError(f"expected [B, n] partitions/cores, got {P.shape}/{K.shape}")
    P0 = np.asarray(base_partition, dtype=np.intp)
    K0 = np.asarray(base_cores, dtype=np.intp)
    if P0.shape != (P.shape[1],) or K0.shape != P0.shape:
        raise ValueError(
            f"expected [n] base partition/cores, got {P0.shape}/{K0.shape}"
        )
    et = _resolve_tables(
        tenants, platform, np.concatenate([K.ravel(), K0]), tables
    )
    if not is_default(objective):
        # The delta decomposition is mean-only (it reconstructs the linear
        # aggregate sums); SLO objectives are nonlinear per tenant, so score
        # the neighbors with the full batched evaluator instead.  Mean keeps
        # the O(changed) fast path below untouched.
        return penalized_objective_batch(
            tenants,
            partitions,
            cores,
            platform,
            force_alpha_zero=force_alpha_zero,
            tables=et,
            discipline=discipline,
            objective=objective,
        )
    ti = et.tenant_idx
    B = P.shape[0]
    F0 = et.pkstack[ti, P0, K0].sum(axis=0)                  # [2]
    if not np.isfinite(F0).all():
        # An infeasible base (e.g. the unstable all-CPU start of Algorithm 1)
        # has inf static latency, and inf-base deltas would turn genuinely
        # feasible neighbors into NaN.  Every per-tenant summand is >= 0, so
        # a finite row-sum certifies every old cell is finite and the deltas
        # below are exact; otherwise score the neighbors from scratch.
        return penalized_objective_batch(
            tenants,
            partitions,
            cores,
            platform,
            force_alpha_zero=force_alpha_zero,
            tables=et,
            discipline=discipline,
        )
    A = np.tile(et.pstack[ti, P0].sum(axis=0), (B, 1))       # [B, 9]
    F = np.tile(F0, (B, 1))                                  # [B, 2]

    b_idx, i_idx = np.nonzero((P != P0[None, :]) | (K != K0[None, :]))
    if b_idx.size:
        pi = ti[i_idx]
        p_new, k_new = P[b_idx, i_idx], K[b_idx, i_idx]
        np.add.at(A, b_idx, et.pstack[pi, p_new] - et.pstack[pi, P0[i_idx]])
        np.add.at(
            F,
            b_idx,
            et.pkstack[pi, p_new, k_new] - et.pkstack[pi, P0[i_idx], K0[i_idx]],
        )
    total, overload = _aggregate_objective(
        et, A, F, P, force_alpha_zero=force_alpha_zero, discipline=discipline
    )
    feasible = (overload == 0.0) & np.isfinite(total)
    return np.where(feasible, total, _PENALTY_BASE * (1.0 + overload))
