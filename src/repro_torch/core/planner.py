"""Model partition plans and profiles.

A model is viewed as a chain of ``Segment`` blocks separated by candidate
partition points (the paper's offline phase enumerates these along
single-edge cuts of the graph).  A partition point ``p`` in ``{0..P}`` places
``segments[:p]`` on the accelerator (the "TPU prefix") and ``segments[p:]``
on the host CPU (the "CPU suffix"); ``p == 0`` is full-CPU, ``p == P`` full-TPU.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Sequence

import numpy as np

from repro_torch.hw.specs import Platform


@dataclasses.dataclass(frozen=True)
class Segment:
    """One partitionable block of a model, with profiled per-block costs."""

    name: str
    flops: float              # ops in this block
    weight_bytes: int         # parameter footprint of this block
    out_bytes: int            # activation size at the block's output boundary
    tpu_time: float           # profiled service time on the accelerator (s)
    cpu_time_1core: float     # profiled service time on one host core (s)
    cpu_parallel_frac: float  # Amdahl parallel fraction for multi-core scaling

    def cpu_time(self, k_cores: int) -> float:
        """Amdahl-scaled CPU service time on ``k_cores`` cores."""
        if k_cores <= 0:
            return math.inf
        f = self.cpu_parallel_frac
        return self.cpu_time_1core * ((1.0 - f) + f / k_cores)


@dataclasses.dataclass(frozen=True)
class ModelProfile:
    """Offline profile of one model: segments + I/O sizes."""

    name: str
    segments: tuple[Segment, ...]
    input_bytes: int

    @property
    def num_partition_points(self) -> int:
        return len(self.segments)

    @property
    def total_weight_bytes(self) -> int:
        return sum(s.weight_bytes for s in self.segments)

    @property
    def total_flops(self) -> float:
        return sum(s.flops for s in self.segments)

    @functools.cached_property
    def fingerprint(self) -> tuple:
        """Structural identity for memoization keys.

        Name, I/O size, and the full per-segment cost table: two profiles
        with equal fingerprints yield identical objectives for any plan, so
        the plan cache (``core/plan_cache.py``) keys tenant mixes on this
        rather than on object identity.  ``Segment`` is a frozen dataclass,
        so the tuple is hashable and the hash is cached with the property.
        """
        return (self.name, self.input_bytes, self.segments)

    # --- cached cumulative tables (hot path of the online allocator) -----
    @functools.cached_property
    def _cum_weight(self) -> np.ndarray:
        return np.concatenate(
            [[0], np.cumsum([s.weight_bytes for s in self.segments])]
        )

    @functools.cached_property
    def _cum_tpu(self) -> np.ndarray:
        return np.concatenate(
            [[0.0], np.cumsum([s.tpu_time for s in self.segments])]
        )

    @functools.cached_property
    def _cum_cpu1(self) -> np.ndarray:
        return np.concatenate(
            [[0.0], np.cumsum([s.cpu_time_1core for s in self.segments])]
        )

    @functools.cached_property
    def _suffix_cpu1(self) -> np.ndarray:
        """1-core suffix time for every partition point: t1[p] = sum cpu_time
        of ``segments[p:]`` (length P+1, last entry 0)."""
        return self._cum_cpu1[-1] - self._cum_cpu1

    @functools.cached_property
    def pareto_points(self) -> np.ndarray:
        """Non-dominated partition points (the pruned search frontier).

        A point ``p`` is *dominated* by ``q`` when ``q`` is no worse on every
        cost dimension the objective (Eq. 1-5, Eq. 10) can see for this model:

            w:  prefix weight bytes   (footprint, T_load, intra-swap overflow)
            s:  cumulative TPU time   (prefix compute)
            c:  1-core CPU suffix time
            b:  boundary tensor bytes (charged only on split plans, so the
                endpoints 0 and P dominate regardless of their b)

        with at least one dimension strictly better (exact duplicates keep
        the smallest ``p``).  The comparison is platform-free: every
        platform-dependent term is monotone in (w, s, c, b) -- prefix service
        is ``s + max(0, w - C)/B``, T_load is ``min(w, C)/B``, transfer times
        scale b by ``1/B``, and Amdahl scaling multiplies c by a k-dependent
        positive factor -- so one frontier is exact for all platforms.

        Exactness: replacing a dominated ``p_i`` by its dominator ``q`` in any
        feasible plan is feasible (``q = P`` frees model i's cores, ``q = 0``
        keeps them) and never increases the objective: model i's own static
        terms shrink termwise, and the coupled terms -- the M/G/1 moment
        numerators, lambda_TPU, the aggregate footprint W(P) and the Eq. 10
        swap sums -- are all nondecreasing in (w_i, s_i, 1{p_i>0}), as is the
        infeasibility overload.  Hence the pruned plan space always retains an
        optimum of the NLIP; for a single tenant (where Eq. 10 collapses to
        alpha = 0) the argument is termwise immediate.  The greedy hill-climb
        additionally never *commits* to a point dominated from below (the move
        cannot strictly improve), so sweeping the frontier is how Algorithm 1
        exploits this; ``prune=False`` on the search routines opts out.
        """
        P = self.num_partition_points
        idx = np.arange(P + 1)
        if P <= 1:
            return idx
        w = self._cum_weight.astype(np.float64)
        s = self._cum_tpu
        c = self._suffix_cpu1
        b = np.array([self.boundary_bytes(p) for p in idx], dtype=np.float64)
        b_dom = b.copy()
        b_dom[0] = b_dom[P] = -np.inf  # endpoints never pay a boundary xfer
        # le[p, q]: q weakly dominates p on every dimension.
        le = (
            (w[None, :] <= w[:, None])
            & (s[None, :] <= s[:, None])
            & (c[None, :] <= c[:, None])
            & (b_dom[None, :] <= b[:, None])
        )
        lt = (
            (w[None, :] < w[:, None])
            | (s[None, :] < s[:, None])
            | (c[None, :] < c[:, None])
            | (b_dom[None, :] < b[:, None])
        )
        dom = le & (lt | (idx[None, :] < idx[:, None]))
        np.fill_diagonal(dom, False)
        dominated = dom.any(axis=1)
        # The all-CPU start of Algorithm 1 and the full-TPU class (k = 0)
        # are structural; never prune them.
        dominated[0] = dominated[P] = False
        out = idx[~dominated]
        out.setflags(write=False)
        return out

    @functools.lru_cache(maxsize=8)
    def suffix_cpu_matrix(self, k_max: int) -> np.ndarray:
        """Amdahl-scaled suffix CPU time for every ``(p, k)`` pair.

        Shape ``[P+1, k_max+1]``; entry ``[p, k]`` equals
        ``suffix_cpu_time(p, k)``.  Column 0 is ``inf`` wherever a suffix
        exists (no cores cannot serve it) and 0 on the full-TPU row ``p=P``.
        The matrix is the vectorized engine's lookup table -- one gather
        replaces a Python call per candidate plan.
        """
        t1 = self._suffix_cpu1  # [P+1]
        f = self.segments[-1].cpu_parallel_frac if self.segments else 0.0
        k = np.arange(k_max + 1, dtype=np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            scale = (1.0 - f) + f / k  # scale[0] = inf (or 1-f if f==0)
            mat = t1[:, None] * scale[None, :]
        # k=0 can serve no suffix (matches suffix_cpu_time's k<=0 -> inf),
        # except on the full-TPU row p=P where there is nothing to serve.
        mat[:-1, 0] = np.inf
        mat[-1, 0] = 0.0
        mat.setflags(write=False)
        return mat

    # --- block aggregates -----------------------------------------------
    def prefix_weight_bytes(self, p: int) -> int:
        return int(self._cum_weight[p])

    def prefix_tpu_time(self, p: int) -> float:
        """Pure compute time of the TPU prefix (no swap)."""
        return float(self._cum_tpu[p])

    def suffix_cpu_time(self, p: int, k_cores: int) -> float:
        """Service time of the CPU suffix ``segments[p:]`` on ``k_cores``."""
        if p >= len(self.segments):
            return 0.0
        if k_cores <= 0:
            return math.inf
        t1 = float(self._cum_cpu1[-1] - self._cum_cpu1[p])
        f = self.segments[-1].cpu_parallel_frac
        return t1 * ((1.0 - f) + f / k_cores)

    def suffix_cpu_time_1core(self, p: int) -> float:
        return float(self._cum_cpu1[-1] - self._cum_cpu1[p])

    def boundary_bytes(self, p: int) -> int:
        """Intermediate tensor size d_out at partition point ``p``."""
        if p <= 0:
            return self.input_bytes
        return self.segments[p - 1].out_bytes

    def scaled(self, tpu_speed: float = 1.0, cpu_speed: float = 1.0) -> "ModelProfile":
        """This profile re-timed for a device running its accelerator at
        ``tpu_speed`` x and its host cores at ``cpu_speed`` x the profiled
        reference (service times divide by the factor; sizes are unchanged).

        The fleet layer views a heterogeneous device through the profiles it
        hosts: everything downstream -- the analytic model, both simulators,
        the plan tables -- consumes profiled *times*, so speed factors enter
        here once and nowhere else.  Cached per (self, factors), so repeated
        calls return the *same object* -- the identity that lets
        ``PlanTables``/``EvalTables`` caches built for a device class match
        across re-plans.  Factor 1.0x1.0 returns ``self`` unchanged, which
        is what pins the single-device degenerate case bitwise -- checked
        *before* the cache, because the LRU keys on profile *value*: an
        equal-but-distinct profile's cached result must never shadow the
        ``self`` identity.
        """
        if tpu_speed == 1.0 and cpu_speed == 1.0:
            return self
        return self._scaled_cached(tpu_speed, cpu_speed)

    @functools.lru_cache(maxsize=64)
    def _scaled_cached(self, tpu_speed: float, cpu_speed: float) -> "ModelProfile":
        if tpu_speed <= 0 or cpu_speed <= 0:
            raise ValueError("speed factors must be positive")
        segments = tuple(
            dataclasses.replace(
                s,
                tpu_time=s.tpu_time / tpu_speed,
                cpu_time_1core=s.cpu_time_1core / cpu_speed,
            )
            for s in self.segments
        )
        return ModelProfile(
            name=f"{self.name}@x{tpu_speed:g}/{cpu_speed:g}",
            segments=segments,
            input_bytes=self.input_bytes,
        )


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One co-located model with its arrival rate (requests/s).

    ``deadline`` is the tenant's end-to-end latency budget in seconds
    (``None`` = no SLO): it is carried on the mix so the opt-in
    ``deadline_miss`` objective (``repro_torch.core.objective``) can price plans
    against it, and it is ignored by every default (mean-objective) path.
    """

    profile: ModelProfile
    rate: float
    deadline: float | None = None


_DISCIPLINE_KINDS = ("fcfs", "swap_batch", "priority", "weighted_fair")


@dataclasses.dataclass(frozen=True)
class DisciplineSpec:
    """Which TPU service discipline a plan runs under (value object).

    The spec is *data* carried by a ``Plan`` (so the planner can co-optimize
    it and the simulators can switch it mid-flight via ``set_plan``); the
    runtime queue mechanics live in ``repro_torch.serving.scheduling`` -- the
    dependency stays core <- serving.

    Kinds:

    * ``fcfs`` -- single global FCFS queue (the paper's Section IV runtime
      and the permanent bitwise-pinned reference).
    * ``swap_batch`` -- serve runs of up to ``batch_cap`` queued same-model
      requests back-to-back so one inter-model swap-in (Eq. 2's T_load)
      amortizes over the whole run; ``batch_cap`` doubles as the fairness
      bound (any queued head-of-line job is overtaken by at most
      ``batch_cap - 1`` batched services before FCFS order resumes), and
      ``staleness`` optionally breaks a run early once the globally oldest
      queued job has waited longer than that many seconds.
    * ``priority`` -- strict non-preemptive priority across tenants
      (``weights[i]`` higher = served first; FIFO within a tenant).
    * ``weighted_fair`` -- served-time-weighted fair queueing: the nonempty
      tenant with the smallest accumulated TPU service per unit ``weight``
      goes next (FIFO within a tenant).

    ``batch_cap <= 1`` disables batching: every evaluator and simulator
    treats such a spec exactly as FCFS semantics with bookkeeping, and the
    planner's co-optimization returns the FCFS plan unchanged.
    """

    kind: str = "fcfs"
    batch_cap: int = 1
    staleness: float = math.inf
    weights: tuple[float, ...] | None = None

    def __post_init__(self) -> None:
        if self.kind not in _DISCIPLINE_KINDS:
            raise ValueError(
                f"unknown discipline {self.kind!r} (want one of {_DISCIPLINE_KINDS})"
            )
        if self.batch_cap < 1:
            raise ValueError("batch_cap must be >= 1")
        if not self.staleness > 0:
            raise ValueError("staleness must be positive (math.inf disables)")
        if self.weights is not None and any(w < 0 for w in self.weights):
            raise ValueError("discipline weights must be non-negative")

    @property
    def batches(self) -> bool:
        """True when the spec actually amortizes swaps (cap of 1 is FCFS)."""
        return self.kind == "swap_batch" and self.batch_cap > 1


FCFS = DisciplineSpec()


@dataclasses.dataclass(frozen=True)
class Plan:
    """A global configuration: partition vector P, core vector K, and the
    TPU service discipline the runtime serves the queue with."""

    partition: tuple[int, ...]
    cores: tuple[int, ...]
    discipline: DisciplineSpec = FCFS

    def __post_init__(self) -> None:
        if len(self.partition) != len(self.cores):
            raise ValueError("partition and cores must have equal length")


def validate_plan(plan: Plan, tenants: Sequence[TenantSpec], k_max: int) -> None:
    """Enforce the NLIP constraints (6)-(9)."""
    for p_i, k_i, t in zip(plan.partition, plan.cores, tenants):
        P_i = t.profile.num_partition_points
        if not 0 <= p_i <= P_i:
            raise ValueError(f"{t.profile.name}: partition {p_i} outside [0,{P_i}]")
        if p_i < P_i and k_i < 1:
            raise ValueError(f"{t.profile.name}: CPU suffix requires >=1 core")
        if p_i == P_i and k_i != 0:
            raise ValueError(f"{t.profile.name}: full-TPU must have 0 cores")
        if k_i < 0:
            raise ValueError("negative core count")
    if sum(plan.cores) > k_max:
        raise ValueError(f"core allocation {plan.cores} exceeds K_max={k_max}")
    w = plan.discipline.weights
    if w is not None and len(w) != len(tenants):
        raise ValueError(
            f"discipline weights length {len(w)} != {len(tenants)} tenants"
        )


def intra_swap_bytes(profile: ModelProfile, p: int, platform: Platform) -> int:
    """Bytes streamed per inference due to *intra-model* swapping.

    When a TPU prefix exceeds SRAM capacity ``C``, the runtime keeps the first
    ``C`` bytes resident and streams the remainder from host memory on every
    request (the Edge TPU runtime's sequential segment-swap behaviour).
    """
    return max(0, profile.prefix_weight_bytes(p) - platform.sram_bytes)


def prefix_service_time(profile: ModelProfile, p: int, platform: Platform) -> float:
    """s_TPU for the prefix: deterministic compute + intra-model swap."""
    if p <= 0:
        return 0.0
    swap = intra_swap_bytes(profile, p, platform) / platform.swap_bw
    return profile.prefix_tpu_time(p) + swap


def load_time(profile: ModelProfile, p: int, platform: Platform) -> float:
    """T_load: inter-model swap latency = resident prefix bytes / bandwidth B.

    Only the portion that is (normally) resident needs reloading after an
    eviction; the intra-swapped overflow is streamed every request anyway.
    """
    resident = min(profile.prefix_weight_bytes(p), platform.sram_bytes)
    return resident / platform.swap_bw


@dataclasses.dataclass(frozen=True)
class RouteTables:
    """Per-model service/transfer tables a runtime derives from one plan.

    Both simulators (`serving.simulator.RuntimeSimulator._derive` and
    `serving.des.DiscreteEventSimulator.set_plan`) need exactly these six
    lists; deriving them in one place keeps the two bitwise-identical by
    construction.  Plain Python floats/ints, same expressions the
    simulators historically used -- the pinned fast-path tests see the
    exact same values.
    """

    prefix_bytes: list[int]   # resident-candidate prefix weight bytes
    s_tpu: list[float]        # prefix service incl. intra-swap streaming
    t_load: list[float]       # inter-model swap-in on an SRAM miss
    s_cpu: list[float]        # 1-core CPU suffix service time
    in_xfer: list[float]      # input tensor host->TPU transfer
    out_xfer: list[float]     # boundary tensor TPU->host transfer


def route_tables(
    profiles: Sequence[ModelProfile], plan: Plan, platform: Platform
) -> RouteTables:
    """Derive the per-model routing tables for ``plan`` on ``platform``."""
    pf, pl, p = profiles, platform, plan.partition
    return RouteTables(
        prefix_bytes=[f.prefix_weight_bytes(q) for f, q in zip(pf, p)],
        s_tpu=[prefix_service_time(f, q, pl) for f, q in zip(pf, p)],
        t_load=[load_time(f, q, pl) for f, q in zip(pf, p)],
        s_cpu=[
            f.suffix_cpu_time(q, 1) if q < f.num_partition_points else 0.0
            for f, q in zip(pf, p)
        ],
        in_xfer=[f.input_bytes / pl.swap_bw for f in pf],
        out_xfer=[f.boundary_bytes(q) / pl.swap_bw for f, q in zip(pf, p)],
    )
