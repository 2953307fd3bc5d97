"""Workload scenario library: request traces for every serving backend.

Every generator returns a time-sorted columnar ``Trace`` -- parallel NumPy
arrays of ``model_idx`` / ``arrival`` / ``service_scale`` -- the one trace
interface shared by ``simulate`` (both the stepper and the discrete-event
backend) and ``run_adaptive``.  ``Trace`` behaves as a sequence of
``Request`` records (iteration, indexing, equality), so per-request
consumers are unchanged, while the columnar layout is what lets the
vectorized stepper fast path push millions of requests per second
(``repro_torch.serving.simulator``).  ``Trace.to_requests()`` /
``Trace.from_requests()`` adapt to and from ``list[Request]`` for callers
that need the scalar form.

Beyond the paper's Poisson and piecewise-rate (Fig. 8) traces, the library
covers the dynamic/multi-tenant settings the analytic model is *not* fit
to: bursty MMPP arrivals, diurnal rate cycles, heavy-tailed service-time
jitter, and tenant churn.  ``benchmarks/model_vs_sim.py`` sweeps these
against the discrete-event simulator to chart where Eq. 1-5 stays
trustworthy.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Iterator, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True, slots=True)
class Request:
    model_idx: int
    arrival: float
    # Multiplier on the request's *compute* service times (TPU prefix and
    # CPU suffix; transfers and swap reloads are bandwidth-bound and do not
    # scale).  1.0 everywhere reproduces the deterministic-service model the
    # analytic predictions assume; ``with_service_jitter`` perturbs it.
    service_scale: float = 1.0


class Trace:
    """Columnar request trace: parallel arrays, one row per request.

    The native output of every generator in this module.  Reads as an
    immutable sequence of ``Request`` (iteration/indexing materialize
    records on demand); the arrays themselves are the contract the
    vectorized simulation fast paths consume directly.  Arrays are marked
    read-only -- a trace is a value, and both simulators replay it.
    """

    __slots__ = ("model_idx", "arrival", "service_scale", "_sorted", "_unit")

    def __init__(
        self,
        model_idx: np.ndarray,
        arrival: np.ndarray,
        service_scale: np.ndarray | None = None,
        *,
        _sorted: bool | None = None,
        _unit: bool | None = None,
        _own: bool = False,
    ):
        # A Trace freezes its columns (read-only): copy any caller-owned
        # writable array rather than freezing the caller's buffer in place.
        # Internal constructors pass freshly allocated arrays with
        # ``_own=True`` to stay zero-copy.
        def col(a, dtype):
            arr = np.ascontiguousarray(a, dtype=dtype)
            if not _own and arr is a and arr.flags.writeable:
                arr = arr.copy()
            return arr

        mi = col(model_idx, np.int64)
        ar = col(arrival, np.float64)
        if service_scale is None:
            sc = np.ones(ar.shape, dtype=np.float64)
            _unit = True
        else:
            sc = col(service_scale, np.float64)
        if not (mi.ndim == ar.ndim == sc.ndim == 1):
            raise ValueError("trace columns must be 1-D arrays")
        if not (mi.size == ar.size == sc.size):
            raise ValueError(
                f"trace column lengths differ: {mi.size}/{ar.size}/{sc.size}"
            )
        for a in (mi, ar, sc):
            a.setflags(write=False)
        object.__setattr__(self, "model_idx", mi)
        object.__setattr__(self, "arrival", ar)
        object.__setattr__(self, "service_scale", sc)
        object.__setattr__(self, "_sorted", _sorted)
        object.__setattr__(self, "_unit", _unit)

    def __setattr__(self, name, value):  # pragma: no cover - guard
        raise AttributeError("Trace is immutable")

    # -- sequence protocol (the list[Request] back-compat surface) ---------
    def __len__(self) -> int:
        return self.arrival.size

    def __iter__(self) -> Iterator[Request]:
        # One bulk tolist() per column: ~30x faster than per-row item().
        for m, a, s in zip(
            self.model_idx.tolist(),
            self.arrival.tolist(),
            self.service_scale.tolist(),
        ):
            yield Request(m, a, s)

    def __getitem__(self, key):
        if isinstance(key, slice):
            return Trace(
                self.model_idx[key],
                self.arrival[key],
                self.service_scale[key],
                _sorted=self._sorted if (key.step or 1) > 0 else None,
                _unit=self._unit,
                _own=True,  # read-only views of already-frozen columns
            )
        i = int(key)
        return Request(
            int(self.model_idx[i]),
            float(self.arrival[i]),
            float(self.service_scale[i]),
        )

    def __eq__(self, other) -> bool:
        if isinstance(other, Trace):
            return (
                np.array_equal(self.model_idx, other.model_idx)
                and np.array_equal(self.arrival, other.arrival)
                and np.array_equal(self.service_scale, other.service_scale)
            )
        if isinstance(other, (list, tuple)):
            return len(other) == len(self) and all(
                a == b for a, b in zip(self, other)
            )
        return NotImplemented

    __hash__ = None  # mutable-adjacent (holds arrays); not hashable

    def __repr__(self) -> str:
        return f"Trace(n={len(self)}, models={np.unique(self.model_idx).tolist()})"

    # -- adapters ----------------------------------------------------------
    def to_requests(self) -> list[Request]:
        """Materialize the scalar ``list[Request]`` form."""
        return list(self)

    @classmethod
    def from_requests(cls, requests: Sequence[Request]) -> "Trace":
        """Adapt a ``list[Request]`` (or any Request sequence) to columns."""
        if isinstance(requests, Trace):
            return requests
        n = len(requests)
        mi = np.fromiter((r.model_idx for r in requests), np.int64, count=n)
        ar = np.fromiter((r.arrival for r in requests), np.float64, count=n)
        sc = np.fromiter(
            (r.service_scale for r in requests), np.float64, count=n
        )
        return cls(mi, ar, sc, _own=True)

    @property
    def scale_is_unit(self) -> bool:
        """True when every ``service_scale`` is exactly 1.0 (checked once,
        then cached; known at construction for un-jittered generators).
        Lets the fast paths skip a no-op multiply without changing a bit
        (``s * 1.0 == s`` exactly)."""
        if self._unit is None:
            object.__setattr__(
                self, "_unit", bool(np.all(self.service_scale == 1.0))
            )
        return self._unit

    # -- ordering ----------------------------------------------------------
    @property
    def is_sorted(self) -> bool:
        """True when arrivals are nondecreasing (checked once, then cached).

        Every generator in this module emits sorted traces and marks them at
        construction, so the common-path check is O(1) -- the verify-then-skip
        that lets ``simulate``/``run_adaptive`` drop their defensive sort.
        """
        if self._sorted is None:
            ar = self.arrival
            object.__setattr__(
                self, "_sorted", bool(np.all(ar[1:] >= ar[:-1]))
            )
        return self._sorted

    def sorted_by_arrival(self) -> "Trace":
        """This trace in arrival order (self when already sorted; stable)."""
        if self.is_sorted:
            return self
        order = np.argsort(self.arrival, kind="stable")
        return Trace(
            self.model_idx[order],
            self.arrival[order],
            self.service_scale[order],
            _sorted=True,
            _unit=self._unit,
            _own=True,
        )


def as_trace(requests: "Trace | Sequence[Request]") -> Trace:
    """Coerce any accepted trace form to the columnar ``Trace``."""
    return Trace.from_requests(requests)


def _check_rates(rates: Sequence[float]) -> list[float]:
    out = [float(r) for r in rates]
    if any(r < 0 for r in out):
        raise ValueError(f"arrival rates must be non-negative, got {out}")
    return out


def _poisson_arrival_times(
    rng: np.random.Generator,
    lam: float,
    duration: float,
    *,
    _chunk: int | None = None,
) -> np.ndarray:
    """Arrival times of one rate-``lam`` Poisson stream covering [0, duration).

    Gaps are drawn in blocks and the draw *extends until the cumulative
    arrival time passes the horizon*.  The previous ``1.5 x lam x duration
    + 20`` single-block heuristic could -- rarely, when the sampled gaps ran
    long -- fall short of ``duration`` and silently truncate the tail of the
    trace.  The first block keeps the old size (so seeded traces that never
    needed extension are bit-identical); ``_chunk`` overrides the block size
    to force the extension loop in regression tests.
    """
    block = _chunk if _chunk is not None else int(lam * duration * 1.5) + 20
    times = np.cumsum(rng.exponential(1.0 / lam, size=block))
    while times[-1] < duration:
        more = np.cumsum(rng.exponential(1.0 / lam, size=block))
        times = np.concatenate([times, times[-1] + more])
    return times[times < duration]


def _merge_streams(streams: list[tuple[int, np.ndarray]]) -> Trace:
    """Merge per-model arrival arrays into one time-sorted trace.

    Stable sort after concatenation in model order: ties keep lower model
    index first, matching the historical ``list.sort`` merge exactly.
    """
    if not streams:
        return Trace(np.empty(0, np.int64), np.empty(0), _sorted=True, _own=True)
    idx = np.concatenate(
        [np.full(t.size, i, dtype=np.int64) for i, t in streams]
    )
    arr = np.concatenate([t for _, t in streams])
    order = np.argsort(arr, kind="stable")
    return Trace(idx[order], arr[order], _sorted=True, _own=True)


def poisson_trace(
    rates: list[float],
    duration: float,
    seed: int = 0,
    *,
    _chunk: int | None = None,
) -> Trace:
    """Independent Poisson arrival streams, merged and time-sorted."""
    rng = np.random.default_rng(seed)
    streams = [
        (idx, _poisson_arrival_times(rng, lam, duration, _chunk=_chunk))
        for idx, lam in enumerate(_check_rates(rates))
        if lam > 0
    ]
    return _merge_streams(streams)


def deterministic_trace(rates: list[float], duration: float) -> Trace:
    """Evenly spaced arrivals per model (D/.../. input process).

    Model ``i`` sends requests at ``(j + (i+1)/(n+1)) / rate`` -- the
    per-stream phase offset staggers streams of *equal* rate so their j-th
    arrivals never collide (a shared half-offset would put them at the same
    instant, queueing one behind the other).  With inter-arrival gaps longer
    than the system's total service time this is the zero-queueing regime
    whose latency the closed-form static terms of Eq. 4 predict exactly
    (see ``tests/test_des.py``).
    """
    rates = _check_rates(rates)
    streams = []
    for idx, lam in enumerate(rates):
        if lam <= 0:
            continue
        phase = (idx + 1) / (len(rates) + 1)
        # Over-draw and filter: floor(duration * lam) draws dropped the last
        # in-horizon arrival whenever the phase offset pushed index
        # floor(duration * lam) back under the horizon (e.g. lam=1,
        # duration=10.9, phase=0.5: the t=10.5 arrival) -- the same
        # truncation class the Poisson generators' extension loop fixed.
        n = int(np.ceil(duration * lam)) + 1
        times = (np.arange(n) + phase) / lam
        streams.append((idx, times[times < duration]))
    return _merge_streams(streams)


@dataclasses.dataclass(frozen=True)
class RatePhase:
    """One phase of a dynamic workload: ``rates`` holding on [start, end)."""

    start: float
    end: float
    rates: tuple[float, ...]


def dynamic_trace(phases: list[RatePhase], seed: int = 0) -> Trace:
    """Piecewise-constant-rate Poisson arrivals (the paper's Fig. 8 setup)."""
    models: list[np.ndarray] = []
    arrivals: list[np.ndarray] = []
    for j, ph in enumerate(phases):
        sub = poisson_trace(list(ph.rates), ph.end - ph.start, seed=seed + 7919 * j)
        models.append(sub.model_idx)
        arrivals.append(sub.arrival + ph.start)
    if not models:
        return Trace(np.empty(0, np.int64), np.empty(0), _sorted=True, _own=True)
    merged = Trace(
        np.concatenate(models),
        np.concatenate(arrivals),
        # service_scale omitted: per-phase Poisson sub-traces carry no jitter
        _own=True,
    )
    return merged.sorted_by_arrival()


def mmpp_trace(
    rates: list[float],
    duration: float,
    *,
    burst_factor: float = 4.0,
    mean_normal: float = 60.0,
    mean_burst: float = 15.0,
    seed: int = 0,
) -> Trace:
    """Two-state Markov-modulated Poisson process (bursty arrivals).

    A global modulating chain alternates between a *normal* state (per-model
    rates ``rates``) and a *burst* state (``rates * burst_factor``), with
    exponentially distributed sojourn times of the given means -- the
    classic MMPP(2) burst model.  The long-run mean rate is
    ``rates * (mean_normal + burst_factor * mean_burst) / (mean_normal +
    mean_burst)``; bursts inflate queueing far beyond what a Poisson stream
    of the same mean rate produces, which is exactly the regime the M/G/1
    model underpredicts.
    """
    rates = _check_rates(rates)
    if burst_factor < 0:
        raise ValueError("burst_factor must be non-negative")
    if mean_normal <= 0 or mean_burst <= 0:
        raise ValueError("state sojourn means must be positive")
    rng = np.random.default_rng(seed)
    phases: list[RatePhase] = []
    t, burst = 0.0, False
    while t < duration:
        mean = mean_burst if burst else mean_normal
        hold = float(rng.exponential(mean))
        end = min(t + hold, duration)
        mult = burst_factor if burst else 1.0
        phases.append(RatePhase(t, end, tuple(r * mult for r in rates)))
        t, burst = end, not burst
    return dynamic_trace(phases, seed=seed + 104729)


def diurnal_trace(
    rates: list[float],
    duration: float,
    *,
    amplitude: float = 0.8,
    period: float = 600.0,
    seed: int = 0,
) -> Trace:
    """Sinusoidal rate cycle: ``lam_i(t) = rates[i] * (1 + A sin(2 pi t/T))``.

    Sampled exactly by thinning a homogeneous Poisson stream at the peak
    rate (Lewis & Shedler): candidate arrivals at rate ``lam_max`` are kept
    with probability ``lam(t)/lam_max``.  ``amplitude`` must lie in [0, 1]
    so the rate never goes negative.
    """
    rates = _check_rates(rates)
    if not 0.0 <= amplitude <= 1.0:
        raise ValueError("amplitude must be in [0, 1]")
    if period <= 0:
        raise ValueError("period must be positive")
    rng = np.random.default_rng(seed)
    streams = []
    for idx, lam in enumerate(rates):
        if lam <= 0:
            continue
        lam_max = lam * (1.0 + amplitude)
        times = _poisson_arrival_times(rng, lam_max, duration)
        accept = rng.uniform(size=times.size) * lam_max <= lam * (
            1.0 + amplitude * np.sin(2.0 * np.pi * times / period)
        )
        streams.append((idx, times[accept]))
    return _merge_streams(streams)


def with_service_jitter(
    requests: "Trace | Sequence[Request]",
    *,
    sigma: float = 0.6,
    seed: int = 0,
) -> "Trace | list[Request]":
    """Attach heavy-tailed service-time jitter to an existing trace.

    Each request's ``service_scale`` is drawn i.i.d. from a mean-1 lognormal
    (``exp(N(-sigma^2/2, sigma^2))``): the *mean* service time is preserved,
    so the analytic utilization is unchanged, but E[S^2] grows by
    ``exp(sigma^2)`` -- the Pollaczek-Khinchine wait the deterministic
    two-atom mixture of Eq. 2 predicts becomes a lower bound.  Order and
    arrival stamps are untouched.  A ``Trace`` comes back as a ``Trace``;
    a ``Request`` sequence as a ``list[Request]``.
    """
    if sigma < 0:
        raise ValueError("sigma must be non-negative")
    rng = np.random.default_rng(seed)
    scales = rng.lognormal(mean=-0.5 * sigma * sigma, sigma=sigma, size=len(requests))
    if isinstance(requests, Trace):
        return Trace(
            requests.model_idx,
            requests.arrival,
            requests.service_scale * scales,
            _sorted=requests._sorted,
            _own=True,  # sources are frozen columns; the product is fresh
        )
    return [
        dataclasses.replace(r, service_scale=float(r.service_scale * s))
        for r, s in zip(requests, scales)
    ]


@dataclasses.dataclass(frozen=True)
class ChurnTrace:
    """A tenant-churn workload: requests plus the generating schedule.

    ``active[i]`` holds model i's sessions as ``(join, leave)`` intervals;
    every request of model i falls inside one of them (property-tested).
    The schedule is what lets a controller test tenant arrival/departure
    handling without inferring sessions back from the gaps.
    """

    requests: Trace
    active: tuple[tuple[tuple[float, float], ...], ...]


def tenant_churn_trace(
    rates: list[float],
    duration: float,
    *,
    mean_session: float = 120.0,
    mean_absence: float = 60.0,
    seed: int = 0,
) -> ChurnTrace:
    """Tenants join and depart: alternating active/absent renewal process.

    Each model independently alternates exponentially distributed active
    sessions (Poisson arrivals at its rate) and absences (no requests at
    all), starting active.  Models a multi-tenant edge box where apps
    start and stop -- the regime of Subedi et al.'s multi-tenancy study
    where static plans go stale.
    """
    rates = _check_rates(rates)
    if mean_session <= 0 or mean_absence <= 0:
        raise ValueError("session/absence means must be positive")
    rng = np.random.default_rng(seed)
    streams: list[tuple[int, np.ndarray]] = []
    schedule: list[tuple[tuple[float, float], ...]] = []
    for idx, lam in enumerate(rates):
        sessions: list[tuple[float, float]] = []
        bursts: list[np.ndarray] = []
        t, active = 0.0, True
        while t < duration:
            hold = float(
                rng.exponential(mean_session if active else mean_absence)
            )
            end = min(t + hold, duration)
            if active and lam > 0:
                sessions.append((t, end))
                bursts.append(t + _poisson_arrival_times(rng, lam, end - t))
            t, active = end, not active
        streams.append(
            (idx, np.concatenate(bursts) if bursts else np.empty(0))
        )
        schedule.append(tuple(sessions))
    return ChurnTrace(requests=_merge_streams(streams), active=tuple(schedule))


# -- fleet routing ------------------------------------------------------------

def route_trace(
    requests: "Trace | Sequence[Request]",
    placement: Sequence[Sequence[int]],
    routing: Sequence[Sequence[float]],
    n_devices: int,
    *,
    seed: int = 0,
    faults=None,
) -> list[Trace]:
    """Split one trace into per-device columnar traces by tenant placement.

    ``placement[i]`` / ``routing[i]`` follow the ``FleetPlan`` contract: the
    devices tenant ``i`` may run on and the matching routing weights.  Every
    request keeps its *global* ``model_idx`` (device plans are full-width,
    so per-device simulators replay the splits without re-indexing), its
    arrival stamp, and its service scale; the returned traces partition the
    input exactly -- ``sum(len(t) for t in out) == len(trace)``.

    Single-placement tenants split deterministically (a pure boolean mask,
    preserving arrival order, so each sub-trace inherits sortedness).
    Tenants placed on several devices draw i.i.d. device choices from their
    routing weights with a ``seed``-keyed generator -- same trace + same
    seed is the same split, which keeps the JSON replay contract intact:
    replaying ``trace_from_json(trace_to_json(t))`` routes bit-identically.

    The degenerate single-device fleet returns ``[trace]`` itself (the
    bitwise N=1 contract: not a copy, the same object).

    ``faults`` (a ``serving.faults.FaultSchedule``): model a health-aware
    ingress router -- a request whose weighted draw lands on a device that
    is *down at its arrival instant* is redrawn across the tenant's other
    placed, currently-up devices (routing-weight proportional).  Tenants
    placed on a single device keep their requests (the device's own dropout
    gate decides requeue/lost); ``faults=None`` (default) leaves routing
    bitwise unchanged.
    """
    trace = as_trace(requests)
    if n_devices <= 0:
        raise ValueError("n_devices must be positive")
    if len(placement) != len(routing):
        raise ValueError("placement and routing must have equal length")
    if n_devices == 1 and all(tuple(p) == (0,) for p in placement):
        return [trace]

    mi = trace.model_idx
    n = len(trace)
    dev = np.full(n, -1, dtype=np.int64)
    rng: np.random.Generator | None = None
    for i, (devs, wts) in enumerate(zip(placement, routing)):
        if not devs:
            raise ValueError(f"tenant {i} placed on no device")
        if any(not 0 <= d < n_devices for d in devs):
            raise ValueError(f"tenant {i} placement {tuple(devs)} out of range")
        mask = mi == i
        if len(devs) == 1:
            dev[mask] = devs[0]
            continue
        if len(wts) != len(devs):
            raise ValueError(f"tenant {i}: weights/placement length mismatch")
        if rng is None:
            rng = np.random.default_rng(seed)
        cum = np.cumsum(np.asarray(wts, dtype=np.float64))
        if not cum.size or cum[-1] <= 0:
            raise ValueError(f"tenant {i}: routing weights sum to zero")
        cum /= cum[-1]
        choice = np.searchsorted(cum, rng.random(int(mask.sum())), side="right")
        dev[mask] = np.asarray(devs, dtype=np.int64)[
            np.minimum(choice, len(devs) - 1)
        ]
    unplaced = dev < 0
    if unplaced.any():
        bad = np.unique(mi[unplaced]).tolist()
        raise ValueError(f"trace contains unplaced model indices {bad}")

    if faults is not None:
        faults.validate(n_devices)
        views = [faults.view(d) for d in range(n_devices)]
        if any(v.down_windows for v in views):
            arr = trace.arrival
            for i, (devs, wts) in enumerate(zip(placement, routing)):
                devs = list(devs)
                if len(devs) < 2:
                    continue
                if len(wts) != len(devs):
                    wts = [1.0] * len(devs)
                sel_i = np.flatnonzero(mi == i)
                if not sel_i.size:
                    continue
                for k in sel_i.tolist():
                    d = int(dev[k])
                    t = float(arr[k])
                    if not views[d].is_down(t):
                        continue
                    alts = [
                        (x, w)
                        for x, w in zip(devs, wts)
                        if x != d and not views[x].is_down(t)
                    ]
                    if not alts:
                        continue  # whole placement dark: the gate decides
                    if rng is None:
                        rng = np.random.default_rng(seed)
                    cum = np.cumsum([max(w, 0.0) for _, w in alts])
                    if cum[-1] <= 0:
                        cum = np.arange(1.0, len(alts) + 1.0)
                    j = int(
                        np.searchsorted(
                            cum / cum[-1], rng.random(), side="right"
                        )
                    )
                    dev[k] = alts[min(j, len(alts) - 1)][0]

    out = []
    for d in range(n_devices):
        mask = dev == d
        out.append(
            Trace(
                # Boolean-mask gathers allocate fresh arrays: zero-copy-safe.
                trace.model_idx[mask],
                trace.arrival[mask],
                trace.service_scale[mask],
                # A subsequence of a sorted trace is sorted; unknown stays
                # unknown (never claim False -- the subset may well be sorted).
                _sorted=True if trace._sorted else None,
                _unit=True if trace._unit else None,
                _own=True,
            )
        )
    return out


# -- deterministic trace replay ---------------------------------------------

def trace_to_json(requests: "Trace | Sequence[Request]") -> str:
    """Serialize a trace for deterministic replay.

    Floats go through ``repr`` (Python's ``json``), which round-trips IEEE
    doubles exactly, so a replayed trace drives a simulator bit-identically.
    """
    return json.dumps(
        [
            {"model_idx": r.model_idx, "arrival": r.arrival,
             "service_scale": r.service_scale}
            for r in requests
        ]
    )


def trace_from_json(payload: str) -> Trace:
    """Inverse of ``trace_to_json``; validates and re-sorts by arrival."""
    rows = json.loads(payload)
    reqs = []
    for row in rows:
        r = Request(
            model_idx=int(row["model_idx"]),
            arrival=float(row["arrival"]),
            service_scale=float(row.get("service_scale", 1.0)),
        )
        if r.arrival < 0 or r.service_scale < 0:
            raise ValueError(f"negative arrival/service_scale in {row}")
        reqs.append(r)
    return Trace.from_requests(reqs).sorted_by_arrival()
