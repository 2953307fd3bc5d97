"""Fault injection: timed device faults for simulators and controllers.

The ROADMAP's "scenario diversity: faults" item: every simulated device so
far was immortal -- no dropout, no thermal throttling, no swap-channel
degradation -- while the paper's edge deployments are exactly the setting
where those happen (Subedi et al., arxiv 2107.12486, measure the
degradation axis for concurrent edge inference; Liang et al., arxiv
2003.12488, motivate pipelines that must keep serving through component
failure).  This module is the one definition of what a fault *is*; the
simulators consume it through a per-device ``DeviceFaultView`` and the
adaptive controllers react to its observable consequences.

Three event kinds, all windows ``[start, end)``:

* ``dropout`` -- the device is gone: requests newly arriving, and queued
  requests whose service would begin inside the window, are either
  *requeued* (service pushed to the recovery instant; the recorded latency
  includes the outage) or *lost* (dropped and counted), per the schedule's
  ``dropout_policy``.  Service already running when the window opens
  completes -- the outage is non-preemptive at request granularity, the
  same granularity every other mechanism in the repo works at.
* ``throttle`` -- thermal throttling as time-varying speed: TPU/CPU service
  times divide by ``tpu_factor`` / ``cpu_factor`` (a factor of 0.25 means
  the device runs at quarter speed).  The factor is looked up at *service
  start* and applied to the whole service -- the same bind-at-start
  discipline routes already follow (a request is not re-split mid-flight).
* ``swap_degrade`` -- the swap channel (inter-model ``T_load`` swap-ins and
  the input/boundary transfers of Eq. 4) runs at ``swap_factor`` of its
  nominal bandwidth, looked up when each transfer begins.

Semantics are defined once, here, so the DES (event hooks) and the stepper
(time-varying service scaling in the scalar recurrence) agree *exactly*:
both look factors up at identical instants and apply identical float ops,
so DES == stepper stays elementwise under any schedule
(``tests/test_faults.py``).  Injection is strictly opt-in: ``faults=None``
-- the default everywhere -- leaves every pre-fault code path untouched,
bitwise (standing invariant, self-checked by ``benchmarks/faults.py``).

``FaultSchedule`` is validated on construction and JSON-round-trippable
bit-exactly (floats serialize via ``repr``, like ``trace_to_json``), so a
fault scenario replays deterministically.
"""
from __future__ import annotations

import bisect
import dataclasses
import json
import math
from typing import Iterable, Sequence

__all__ = [
    "DeviceFaultView",
    "FaultEvent",
    "FaultSchedule",
    "FaultStats",
    "LatencyWindowTracker",
    "merge_fault_stats",
]

_KINDS = ("dropout", "throttle", "swap_degrade")
_POLICIES = ("requeue", "lost")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One timed fault on one device; window is ``[start, end)``.

    ``end`` may be ``math.inf`` (a permanent fault).  Factors are the
    *fraction of nominal speed* in effect during the window, in ``(0, 1]``:
    a throttle that halves the TPU is ``tpu_factor=0.5``.  Factors above 1
    are rejected -- faults degrade; a >1 "factor" is almost certainly a
    slowdown multiplier passed where a speed fraction belongs.
    """

    kind: str
    device: int
    start: float
    end: float
    tpu_factor: float = 1.0
    cpu_factor: float = 1.0
    swap_factor: float = 1.0

    def __post_init__(self) -> None:
        if self.kind not in _KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r} (want one of {_KINDS})"
            )
        if not isinstance(self.device, int) or self.device < 0:
            raise ValueError(f"device must be a non-negative int, got {self.device!r}")
        if not (math.isfinite(self.start) and self.start >= 0):
            raise ValueError(f"start must be finite and >= 0, got {self.start!r}")
        if not self.end > self.start:
            raise ValueError(
                f"end ({self.end!r}) must be > start ({self.start!r})"
            )
        for name in ("tpu_factor", "cpu_factor", "swap_factor"):
            f = getattr(self, name)
            if not (0.0 < f <= 1.0):
                raise ValueError(
                    f"{name} must be in (0, 1] (fraction of nominal speed), "
                    f"got {f!r}"
                )
        if self.kind == "dropout" and (
            self.tpu_factor != 1.0
            or self.cpu_factor != 1.0
            or self.swap_factor != 1.0
        ):
            raise ValueError("dropout events carry no speed factors")
        if self.kind == "throttle" and self.swap_factor != 1.0:
            raise ValueError(
                "throttle events scale TPU/CPU speed; use swap_degrade for "
                "the swap channel"
            )
        if self.kind == "swap_degrade" and (
            self.tpu_factor != 1.0 or self.cpu_factor != 1.0
        ):
            raise ValueError("swap_degrade events carry only swap_factor")

    def as_dict(self) -> dict:
        d = {
            "kind": self.kind,
            "device": self.device,
            "start": self.start,
            "end": self.end,
        }
        if self.kind == "throttle":
            d["tpu_factor"] = self.tpu_factor
            d["cpu_factor"] = self.cpu_factor
        elif self.kind == "swap_degrade":
            d["swap_factor"] = self.swap_factor
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "FaultEvent":
        return cls(
            kind=str(d["kind"]),
            device=int(d["device"]),
            start=float(d["start"]),
            end=float(d["end"]),
            tpu_factor=float(d.get("tpu_factor", 1.0)),
            cpu_factor=float(d.get("cpu_factor", 1.0)),
            swap_factor=float(d.get("swap_factor", 1.0)),
        )


def _check_disjoint(events: Sequence[FaultEvent], kind: str, device: int) -> None:
    wins = sorted(
        (e.start, e.end) for e in events if e.kind == kind and e.device == device
    )
    for (s0, e0), (s1, _) in zip(wins, wins[1:]):
        if s1 < e0:
            raise ValueError(
                f"overlapping {kind} windows on device {device}: "
                f"[{s0}, {e0}) and [{s1}, ...) -- same-kind windows on one "
                "device must be disjoint (adjacent is fine)"
            )


class FaultSchedule:
    """A validated set of timed fault events across a device fleet.

    Events are canonicalized to ``(start, device, kind)`` order, so two
    schedules built from the same events in any order compare (and
    serialize) identically.  Same-kind windows on one device must be
    disjoint; different kinds may overlap (a throttled device may also
    drop).  ``dropout_policy`` is schedule-wide: ``"requeue"`` (default)
    defers affected requests to the recovery instant, ``"lost"`` drops and
    counts them.

    ``validate(n_devices)`` additionally rejects events naming a device
    outside the fleet -- simulators and ``simulate_fleet`` call it before
    injecting.  ``view(d)`` projects the schedule onto one device as the
    ``DeviceFaultView`` the simulators actually consume.
    """

    def __init__(
        self,
        events: Iterable[FaultEvent] = (),
        *,
        dropout_policy: str = "requeue",
    ):
        if dropout_policy not in _POLICIES:
            raise ValueError(
                f"unknown dropout_policy {dropout_policy!r} "
                f"(want one of {_POLICIES})"
            )
        evs = []
        for e in events:
            if not isinstance(e, FaultEvent):
                raise TypeError(f"expected FaultEvent, got {type(e).__name__}")
            evs.append(e)
        self.events: tuple[FaultEvent, ...] = tuple(
            sorted(evs, key=lambda e: (e.start, e.device, e.kind, e.end))
        )
        self.dropout_policy = dropout_policy
        for dev in {e.device for e in self.events}:
            for kind in _KINDS:
                _check_disjoint(self.events, kind, dev)

    # -- identity ------------------------------------------------------------
    def __eq__(self, other: object) -> bool:
        return (
            isinstance(other, FaultSchedule)
            and self.events == other.events
            and self.dropout_policy == other.dropout_policy
        )

    def __hash__(self) -> int:
        return hash((self.events, self.dropout_policy))

    def __len__(self) -> int:
        return len(self.events)

    def __repr__(self) -> str:
        return (
            f"FaultSchedule({list(self.events)!r}, "
            f"dropout_policy={self.dropout_policy!r})"
        )

    @property
    def max_device(self) -> int:
        """Largest device index named by any event (-1 when empty)."""
        return max((e.device for e in self.events), default=-1)

    def validate(self, n_devices: int) -> "FaultSchedule":
        """Reject events addressing devices outside ``[0, n_devices)``."""
        for e in self.events:
            if e.device >= n_devices:
                raise ValueError(
                    f"fault event names device {e.device}, but the fleet has "
                    f"{n_devices} device(s)"
                )
        return self

    # -- serialization (bit-exact: floats round-trip via repr) ---------------
    def to_json(self) -> str:
        return json.dumps(
            {
                "format": "repro-fault-schedule-v1",
                "dropout_policy": self.dropout_policy,
                "events": [e.as_dict() for e in self.events],
            }
        )

    @classmethod
    def from_json(cls, payload: str) -> "FaultSchedule":
        d = json.loads(payload)
        if d.get("format") != "repro-fault-schedule-v1":
            raise ValueError(
                f"not a fault-schedule payload (format={d.get('format')!r})"
            )
        return cls(
            (FaultEvent.from_dict(e) for e in d["events"]),
            dropout_policy=str(d["dropout_policy"]),
        )

    # -- projection ----------------------------------------------------------
    def view(self, device: int) -> "DeviceFaultView":
        """This schedule as seen from one device (what simulators consume)."""
        mine = [e for e in self.events if e.device == device]
        return DeviceFaultView(
            down=tuple(
                (e.start, e.end) for e in mine if e.kind == "dropout"
            ),
            tpu=tuple(
                (e.start, e.end, e.tpu_factor)
                for e in mine
                if e.kind == "throttle"
            ),
            cpu=tuple(
                (e.start, e.end, e.cpu_factor)
                for e in mine
                if e.kind == "throttle"
            ),
            swap=tuple(
                (e.start, e.end, e.swap_factor)
                for e in mine
                if e.kind == "swap_degrade"
            ),
            lost=self.dropout_policy == "lost",
        )

    def down_windows(self, device: int) -> tuple[tuple[float, float], ...]:
        return tuple(
            (e.start, e.end)
            for e in self.events
            if e.device == device and e.kind == "dropout"
        )


class _StepFactor:
    """A piecewise-constant speed factor: 1.0 outside its (disjoint,
    start-sorted) windows, the window's factor inside ``[start, end)``."""

    __slots__ = ("_starts", "_ends", "_factors", "trivial")

    def __init__(self, windows: Sequence[tuple[float, float, float]]):
        wins = sorted(windows)
        self._starts = [w[0] for w in wins]
        self._ends = [w[1] for w in wins]
        self._factors = [w[2] for w in wins]
        self.trivial = all(f == 1.0 for f in self._factors)

    def at(self, t: float) -> float:
        j = bisect.bisect_right(self._starts, t) - 1
        if j >= 0 and t < self._ends[j]:
            return self._factors[j]
        return 1.0


class DeviceFaultView:
    """One device's projection of a ``FaultSchedule``.

    The only fault surface the simulators touch: ``is_down`` /
    ``down_until`` implement the dropout gate, the three factor lookups
    implement throttling and swap degradation.  All lookups are
    O(log windows) bisects on static arrays -- the fault path is scalar by
    design (a schedule forces the per-request reference loop), so the
    lookup cost is immaterial next to the per-request Python overhead.
    """

    __slots__ = ("down_windows", "_down_starts", "_down_ends",
                 "_tpu", "_cpu", "_swap", "lost")

    def __init__(
        self,
        *,
        down: tuple[tuple[float, float], ...] = (),
        tpu: tuple[tuple[float, float, float], ...] = (),
        cpu: tuple[tuple[float, float, float], ...] = (),
        swap: tuple[tuple[float, float, float], ...] = (),
        lost: bool = False,
    ):
        self.down_windows = tuple(sorted(down))
        self._down_starts = [w[0] for w in self.down_windows]
        self._down_ends = [w[1] for w in self.down_windows]
        self._tpu = _StepFactor(tpu)
        self._cpu = _StepFactor(cpu)
        self._swap = _StepFactor(swap)
        self.lost = lost

    # -- dropout gate --------------------------------------------------------
    def is_down(self, t: float) -> bool:
        j = bisect.bisect_right(self._down_starts, t) - 1
        return j >= 0 and t < self._down_ends[j]

    def down_until(self, t: float) -> float:
        """First non-down instant at or after ``t`` (chained adjacent
        windows are pushed through in one call)."""
        while True:
            j = bisect.bisect_right(self._down_starts, t) - 1
            if j < 0 or t >= self._down_ends[j]:
                return t
            t = self._down_ends[j]

    # -- speed factors (looked up at service/transfer start) -----------------
    def tpu_factor(self, t: float) -> float:
        return self._tpu.at(t)

    def cpu_factor(self, t: float) -> float:
        return self._cpu.at(t)

    def swap_factor(self, t: float) -> float:
        return self._swap.at(t)

    @property
    def degraded_windows(self) -> tuple[tuple[float, float], ...]:
        """Every window where the device is impaired (down, throttled, or
        swap-degraded) -- the spans ``SimResult.degraded_window_mean``
        filters arrivals by."""
        spans = list(self.down_windows)
        for sf in (self._tpu, self._cpu, self._swap):
            spans.extend(
                (s, e)
                for s, e, f in zip(sf._starts, sf._ends, sf._factors)
                if f != 1.0
            )
        return tuple(sorted(set(spans)))

    @property
    def has_faults(self) -> bool:
        return bool(
            self.down_windows
            or not self._tpu.trivial
            or not self._cpu.trivial
            or not self._swap.trivial
        )


def as_view(faults: "FaultSchedule | DeviceFaultView | None"):
    """Normalize a single-device ``faults=`` argument to a view (or None).

    A ``FaultSchedule`` handed to a single-device simulator must address
    device 0 only (``validate(1)``); fleet callers project per device with
    ``schedule.view(d)`` themselves.
    """
    if faults is None or isinstance(faults, DeviceFaultView):
        return faults
    if isinstance(faults, FaultSchedule):
        return faults.validate(1).view(0)
    raise TypeError(
        f"faults must be a FaultSchedule or DeviceFaultView, "
        f"got {type(faults).__name__}"
    )


# -- observation record -------------------------------------------------------

@dataclasses.dataclass
class FaultStats:
    """Per-simulator fault bookkeeping, attached to ``SimResult.fault``.

    ``lost[i]`` / ``requeued[i]`` count per-model recorded requests dropped
    by the lost policy / deferral events under the requeue policy (a
    request deferred at both the arrival gate and the service gate counts
    one deferral each).  Windows are carried so recovery metrics
    (``SimResult.recovery_times`` / ``degraded_window_mean``) resolve
    post-hoc from the recorded arrival/latency columns -- the simulators
    track nothing but the two counters.
    """

    lost: list[int]
    requeued: list[int]
    down_windows: tuple[tuple[float, float], ...] = ()
    degraded_windows: tuple[tuple[float, float], ...] = ()

    @property
    def total_lost(self) -> int:
        return sum(self.lost)

    @property
    def total_requeued(self) -> int:
        return sum(self.requeued)


def merge_fault_stats(
    stats: Sequence["FaultStats | None"], n_models: int
) -> "FaultStats | None":
    """Fleet merge: counters add elementwise, windows pool (sorted, from
    every device -- drill into ``per_device`` results for attribution).
    ``None`` when no device carried fault stats at all."""
    present = [s for s in stats if s is not None]
    if not present:
        return None
    lost = [0] * n_models
    requeued = [0] * n_models
    down: list[tuple[float, float]] = []
    degraded: list[tuple[float, float]] = []
    for s in present:
        for i in range(n_models):
            lost[i] += s.lost[i]
            requeued[i] += s.requeued[i]
        down.extend(s.down_windows)
        degraded.extend(s.degraded_windows)
    return FaultStats(
        lost=lost,
        requeued=requeued,
        down_windows=tuple(sorted(set(down))),
        degraded_windows=tuple(sorted(set(degraded))),
    )


# -- controller-side signal tracking ------------------------------------------

class LatencyWindowTracker:
    """Mean latency of samples recorded since the previous poll.

    The adaptive controllers detect degradation from *observed* signals;
    this tracker turns a simulator's append-only per-model latency columns
    (floats from the scalar paths, NumPy chunks from the vectorized ones)
    into per-boundary deltas without copying history: it remembers how many
    chunks of each model's column it has consumed and reduces only the new
    tail.
    """

    def __init__(self, n_models: int):
        self._pos = [0] * n_models

    def poll(self, latencies: Sequence[Sequence[float]]) -> tuple[int, float]:
        """(count, sum) of samples recorded since the last poll."""
        count, total = 0, 0.0
        for i, col in enumerate(latencies):
            for part in col[self._pos[i]:]:
                if isinstance(part, (int, float)):
                    count += 1
                    total += float(part)
                else:  # NumPy chunk from a vectorized path
                    count += int(len(part))
                    total += float(part.sum()) if len(part) else 0.0
            self._pos[i] = len(col)
        return count, total

    def poll_mean(self, latencies: Sequence[Sequence[float]]) -> tuple[int, float]:
        """(count, mean) -- mean is ``nan`` when nothing new was recorded."""
        count, total = self.poll(latencies)
        return count, (total / count if count else math.nan)
