"""Plan memoization: LRU cache over quantized rate states, verify-then-reuse.

Diurnal and bursty workloads revisit the same traffic states over and over
(the morning mix looks like yesterday's morning mix), yet the reactive
controller pays a fresh ``hill_climb`` at every re-plan boundary.  This
module memoizes plans keyed on the *quantized* rate vector plus the mix
fingerprint, so a recurring state re-plans with one cache probe instead of
a search.

Key design points:

* **Quantized keys.**  Rates are snapped to a multiplicative grid
  (``quantize_rates``): two vectors whose per-model rates agree within the
  relative cell width ``rel`` share a key.  The grid is logarithmic, so
  0.10 vs 0.11 req/s land together while 1 vs 2 req/s do not; rates at or
  below ``idle_floor`` share one idle cell.

* **Verify-then-reuse.**  Quantization means a hit's stored plan was
  optimized for *nearby* rates, not these exact rates, and the plan space
  is rugged enough that "nearby" can occasionally be bad (e.g. the cell
  straddles a stability boundary).  Every hit is therefore delta-evaluated:
  one ``penalized_objective`` call re-scores the cached plan under the
  fresh exact rates, and the plan is reused only when its normalized
  objective (obj / total rate, the controller's Eq. 10 trend statistic) is
  within ``margin`` of the quality recorded when it was stored -- and
  finite, and below the infeasibility penalty floor.  Anything else is a
  *reject*: the caller falls back to its normal warm ``hill_climb`` and
  the fresh result overwrites the entry.  A hit costs one plan evaluation
  (~100 us at 64 tenants) instead of a search.

* **Opt-in.**  ``run_adaptive(plan_cache=None)`` -- the default -- never
  constructs or consults a cache; the no-cache path is bitwise the
  reactive controller (standing invariant, self-checked by
  ``benchmarks/predictive.py`` before any timing).

``PlanCache`` serves the single-device controller; ``FleetPlanCache`` is
the same machinery for ``run_adaptive_fleet``, with the verify step
delegated to ``fleet_plan_objective`` and fleet identity (device class
keys) folded into the key.

Objective identity (``repro_torch.core.objective.objective_key``) is part of
both keys: a plan searched for the mean and one searched for p99 are
different answers to different questions, and the verify step must
re-score with the same metric or verify-then-reuse silently compares
different quantities.  The default mean objective appends *nothing* --
the pre-refactor keyspace (and every persisted digest) is preserved
bitwise.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import json
import math
from typing import Sequence

from repro_torch.core.latency import _PENALTY_BASE, penalized_objective
from repro_torch.core.objective import Objective, objective_key
from repro_torch.core.planner import DisciplineSpec, Plan, TenantSpec
from repro_torch.hw.specs import Platform

#: On-disk payload format tag for ``persist``/``restore``.
PERSIST_FORMAT = "repro-plan-cache-v1"

#: Default relative width of one quantization cell (10% in rate).
DEFAULT_REL = 0.10
#: Rates at or below this (req/s) collapse into a single "idle" cell.
IDLE_FLOOR = 1e-3


def quantize_rates(
    rates: Sequence[float],
    rel: float = DEFAULT_REL,
    *,
    idle_floor: float = IDLE_FLOOR,
) -> tuple[int, ...]:
    """Snap a rate vector onto a multiplicative grid of width ``rel``.

    Each rate maps to ``round(log(r / idle_floor) / log(1 + rel))`` -- a
    geometric bucket index -- so two rates within about ``rel`` of each
    other share a bucket at any traffic scale.  Rates at or below
    ``idle_floor`` (including exact zero) map to the sentinel ``-1``.
    """
    if rel <= 0:
        raise ValueError("rel must be positive")
    step = math.log1p(rel)
    out = []
    for r in rates:
        if r <= idle_floor:
            out.append(-1)
        else:
            out.append(int(round(math.log(r / idle_floor) / step)))
    return tuple(out)


def mix_fingerprint(tenants: Sequence[TenantSpec]) -> tuple:
    """Order-sensitive structural identity of a tenant mix's models."""
    return tuple(t.profile.fingerprint for t in tenants)


def _space_key(
    discipline_space: Sequence[DisciplineSpec] | None,
) -> tuple | None:
    return None if discipline_space is None else tuple(discipline_space)


@dataclasses.dataclass
class CacheStats:
    """Lookup counters: a *reject* is a key hit whose plan failed verify."""

    hits: int = 0
    misses: int = 0
    rejects: int = 0

    @property
    def lookups(self) -> int:
        return self.hits + self.misses + self.rejects

    @property
    def hit_rate(self) -> float:
        n = self.lookups
        return self.hits / n if n else 0.0

    def as_dict(self) -> dict:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "rejects": self.rejects,
            "hit_rate": self.hit_rate,
        }


@dataclasses.dataclass
class _Entry:
    plan: Plan
    norm_objective: float  # obj / tot_rate at store time (finite by contract)


def _digest(key: tuple) -> str:
    """Stable cross-session identity of a cache key.

    Keys hold value-semantic frozen dataclasses (``Platform``,
    ``DisciplineSpec``) and plain tuples, so their ``repr`` is a
    deterministic function of the values -- the hash survives a process
    restart, which is exactly what ``persist``/``restore`` need (the raw
    tuples themselves are not JSON-representable).
    """
    return hashlib.sha256(repr(key).encode()).hexdigest()


class _LruMixin:
    """Shared LRU bookkeeping for the single-device and fleet caches."""

    def __init__(self, capacity: int, rel: float, margin: float):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        if margin < 0:
            raise ValueError("margin must be non-negative")
        self.capacity = int(capacity)
        self.rel = float(rel)
        self.margin = float(margin)
        self.stats = CacheStats()
        self._entries: collections.OrderedDict = collections.OrderedDict()
        # Entries loaded by ``restore``, keyed by digest: a live key cannot
        # be reconstructed from JSON, so restored entries wait here and are
        # promoted into ``_entries`` (under the real tuple key) on their
        # first hit.  Empty unless restore() ran -- every probe below is
        # gated on that, keeping the never-restored hot path untouched.
        self._restored: collections.OrderedDict = collections.OrderedDict()

    def __len__(self) -> int:
        return len(self._entries) + len(self._restored)

    def clear(self) -> None:
        self._entries.clear()
        self._restored.clear()

    def _get(self, key):
        entry = self._entries.get(key)
        if entry is not None:
            self._entries.move_to_end(key)
            return entry
        if self._restored:
            entry = self._restored.pop(_digest(key), None)
            if entry is not None:
                self._put(key, entry)
                return entry
        return None

    def _put(self, key, entry) -> None:
        if self._restored:
            # A fresh store supersedes any still-unclaimed restored twin.
            self._restored.pop(_digest(key), None)
        self._entries[key] = entry
        self._entries.move_to_end(key)
        while len(self._entries) + len(self._restored) > self.capacity:
            # Unclaimed restored entries are older than anything live.
            if self._restored:
                self._restored.popitem(last=False)
            else:
                self._entries.popitem(last=False)

    # -- persistence ---------------------------------------------------------
    _kind = ""  # overridden: "plan" / "fleet"

    def _plan_to_json(self, plan):
        raise NotImplementedError

    def _plan_from_json(self, data):
        raise NotImplementedError

    def persist(self) -> str:
        """Serialize the cache to a JSON string (LRU order preserved:
        oldest first, so ``restore`` + eviction keep the same victims)."""
        entries = [
            [digest, self._plan_to_json(e.plan), e.norm_objective]
            for digest, e in self._restored.items()
        ] + [
            [_digest(key), self._plan_to_json(e.plan), e.norm_objective]
            for key, e in self._entries.items()
        ]
        return json.dumps(
            {
                "format": PERSIST_FORMAT,
                "kind": self._kind,
                "capacity": self.capacity,
                "rel": self.rel,
                "margin": self.margin,
                "entries": entries,
            }
        )

    def restore(self, payload: str) -> int:
        """Replace the cache contents from a ``persist`` payload.

        Raises ``ValueError`` when the payload's fingerprint does not match
        this cache: wrong format tag, wrong cache kind (single-device vs
        fleet), or a different quantization grid ``rel`` (the persisted key
        digests embed the grid, so entries from another grid could never be
        hit -- restoring them would only silently waste capacity).  Returns
        the number of entries restored (trimmed to ``capacity``, newest
        kept).
        """
        try:
            data = json.loads(payload)
        except json.JSONDecodeError as exc:
            raise ValueError(f"unreadable plan-cache payload: {exc}") from exc
        if not isinstance(data, dict) or data.get("format") != PERSIST_FORMAT:
            raise ValueError(
                f"not a {PERSIST_FORMAT} payload "
                f"(format={data.get('format')!r})"
                if isinstance(data, dict)
                else "not a plan-cache payload"
            )
        if data.get("kind") != self._kind:
            raise ValueError(
                f"cache kind mismatch: payload is {data.get('kind')!r}, "
                f"this cache is {self._kind!r}"
            )
        if float(data.get("rel", -1.0)) != self.rel:
            raise ValueError(
                f"quantization grid mismatch: payload rel={data.get('rel')}, "
                f"this cache rel={self.rel} (digested keys are grid-specific)"
            )
        entries = data.get("entries", [])
        self.clear()
        for digest, plan_data, norm in entries[-self.capacity:]:
            self._restored[str(digest)] = _Entry(
                self._plan_from_json(plan_data), float(norm)
            )
        return len(self._restored)

    def _admit(self, entry, objective: float, tot_rate: float):
        """Verify-then-reuse decision shared by both caches.

        ``objective`` is the cached plan re-scored under the fresh rates.
        Returns the (plan, objective) pair to reuse, or ``None`` for a
        reject.  Non-finite or penalty-range objectives never pass: an
        infeasible cached plan is worthless no matter what was stored
        (nan-means-unknown convention -- see ``serving/controller.py``).
        """
        if not math.isfinite(objective) or objective >= _PENALTY_BASE:
            return None
        if tot_rate > 0:
            norm = objective / tot_rate
            if norm > (1.0 + self.margin) * entry.norm_objective:
                return None
        return entry.plan, float(objective)


def _discipline_to_json(d: DisciplineSpec) -> dict:
    return {
        "kind": d.kind,
        "batch_cap": d.batch_cap,
        "staleness": None if math.isinf(d.staleness) else d.staleness,
        "weights": None if d.weights is None else list(d.weights),
    }


def _discipline_from_json(x: dict) -> DisciplineSpec:
    return DisciplineSpec(
        kind=x["kind"],
        batch_cap=int(x["batch_cap"]),
        staleness=math.inf if x["staleness"] is None else float(x["staleness"]),
        weights=(
            None if x["weights"] is None else tuple(float(w) for w in x["weights"])
        ),
    )


def _plan_to_json(p: Plan) -> dict:
    return {
        "partition": list(p.partition),
        "cores": list(p.cores),
        "discipline": _discipline_to_json(p.discipline),
    }


def _plan_from_json(x: dict) -> Plan:
    return Plan(
        partition=tuple(int(v) for v in x["partition"]),
        cores=tuple(int(v) for v in x["cores"]),
        discipline=_discipline_from_json(x["discipline"]),
    )


class PlanCache(_LruMixin):
    """LRU plan memoization for the single-device adaptive controller.

    ``lookup`` returns ``(plan, objective)`` on a verified hit or ``None``
    (miss or reject) -- the caller then runs its warm ``hill_climb`` and
    ``store``s the result, refreshing the cell.  See the module docstring
    for the key structure and verify semantics.
    """

    _kind = "plan"

    def __init__(
        self,
        capacity: int = 256,
        *,
        rel: float = DEFAULT_REL,
        margin: float = 0.10,
    ):
        super().__init__(capacity, rel, margin)

    def _plan_to_json(self, plan):
        return _plan_to_json(plan)

    def _plan_from_json(self, data):
        return _plan_from_json(data)

    def _key(
        self,
        tenants: Sequence[TenantSpec],
        platform: Platform,
        k_max: int,
        discipline_space: Sequence[DisciplineSpec] | None,
        objective: Objective | None = None,
    ) -> tuple:
        key = (
            quantize_rates([t.rate for t in tenants], self.rel),
            mix_fingerprint(tenants),
            platform,
            int(k_max),
            _space_key(discipline_space),
        )
        okey = objective_key(objective, tenants)
        # The default mean appends nothing: pre-refactor keys (and their
        # persisted digests) stay bitwise identical.
        return key if okey is None else key + (okey,)

    def lookup(
        self,
        tenants: Sequence[TenantSpec],
        platform: Platform,
        k_max: int,
        *,
        discipline_space: Sequence[DisciplineSpec] | None = None,
        objective: Objective | None = None,
    ) -> tuple[Plan, float] | None:
        entry = self._get(
            self._key(tenants, platform, k_max, discipline_space, objective)
        )
        if entry is None:
            self.stats.misses += 1
            return None
        obj = penalized_objective(
            tenants, entry.plan, platform, objective=objective
        )
        hit = self._admit(entry, obj, sum(t.rate for t in tenants))
        if hit is None:
            self.stats.rejects += 1
            return None
        self.stats.hits += 1
        return hit

    def store(
        self,
        tenants: Sequence[TenantSpec],
        platform: Platform,
        k_max: int,
        plan: Plan,
        value: float,
        *,
        discipline_space: Sequence[DisciplineSpec] | None = None,
        objective: Objective | None = None,
    ) -> None:
        """Record a freshly planned state; silently skips unusable entries
        (idle mix, infeasible/non-finite value).  ``value`` is the plan's
        scored objective; ``objective`` is the metric spec it was scored
        under (part of the key)."""
        tot_rate = sum(t.rate for t in tenants)
        if not tot_rate > 0:
            return
        norm = value / tot_rate
        if not math.isfinite(norm) or value >= _PENALTY_BASE:
            return
        self._put(
            self._key(tenants, platform, k_max, discipline_space, objective),
            _Entry(plan, norm),
        )


class FleetPlanCache(_LruMixin):
    """LRU memoization of ``FleetPlan``s for ``run_adaptive_fleet``.

    Same quantize / fingerprint / verify-then-reuse scheme as
    ``PlanCache``; the key additionally folds in each device's
    ``class_key`` (speeds, platform) so heterogeneous fleets never share
    entries, and the verify step re-scores the whole fleet plan with
    ``fleet_plan_objective``.
    """

    _kind = "fleet"

    def __init__(
        self,
        capacity: int = 256,
        *,
        rel: float = DEFAULT_REL,
        margin: float = 0.10,
    ):
        super().__init__(capacity, rel, margin)

    def _plan_to_json(self, plan):
        return {
            "placement": [list(devs) for devs in plan.placement],
            "routing": [list(ws) for ws in plan.routing],
            "device_plans": [_plan_to_json(p) for p in plan.device_plans],
        }

    def _plan_from_json(self, data):
        from repro_torch.core.fleet import FleetPlan

        return FleetPlan(
            placement=tuple(
                tuple(int(d) for d in devs) for devs in data["placement"]
            ),
            routing=tuple(
                tuple(float(w) for w in ws) for ws in data["routing"]
            ),
            device_plans=tuple(
                _plan_from_json(p) for p in data["device_plans"]
            ),
        )

    def _key(
        self,
        tenants: Sequence[TenantSpec],
        fleet: Sequence,
        k_max: int | None,
        discipline_space: Sequence[DisciplineSpec] | None,
        objective: Objective | None = None,
    ) -> tuple:
        key = (
            quantize_rates([t.rate for t in tenants], self.rel),
            mix_fingerprint(tenants),
            tuple(d.class_key for d in fleet),
            None if k_max is None else int(k_max),
            _space_key(discipline_space),
        )
        okey = objective_key(objective, tenants)
        return key if okey is None else key + (okey,)

    def lookup(
        self,
        tenants: Sequence[TenantSpec],
        fleet: Sequence,
        *,
        k_max: int | None = None,
        discipline_space: Sequence[DisciplineSpec] | None = None,
        objective: Objective | None = None,
    ):
        from repro_torch.core.fleet import fleet_plan_objective

        entry = self._get(
            self._key(tenants, fleet, k_max, discipline_space, objective)
        )
        if entry is None:
            self.stats.misses += 1
            return None
        obj = fleet_plan_objective(
            tenants, entry.plan, fleet, objective=objective
        )
        hit = self._admit(entry, obj, sum(t.rate for t in tenants))
        if hit is None:
            self.stats.rejects += 1
            return None
        self.stats.hits += 1
        return hit

    def store(
        self,
        tenants: Sequence[TenantSpec],
        fleet: Sequence,
        fleet_plan,
        value: float,
        *,
        k_max: int | None = None,
        discipline_space: Sequence[DisciplineSpec] | None = None,
        objective: Objective | None = None,
    ) -> None:
        tot_rate = sum(t.rate for t in tenants)
        if not tot_rate > 0:
            return
        norm = value / tot_rate
        if not math.isfinite(norm) or value >= _PENALTY_BASE:
            return
        self._put(
            self._key(tenants, fleet, k_max, discipline_space, objective),
            _Entry(fleet_plan, norm),
        )


__all__ = [
    "CacheStats",
    "FleetPlanCache",
    "PERSIST_FORMAT",
    "PlanCache",
    "mix_fingerprint",
    "quantize_rates",
]
