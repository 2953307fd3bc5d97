"""Explicit TPU SRAM residency simulator.

The Edge TPU driver's eviction policy is proprietary (the paper approximates
it with the conservative alpha of Eq. 10).  For ground-truth simulation we
implement a concrete, documented policy: model-granularity LRU over resident
prefixes.  A model whose prefix exceeds capacity ``C`` gets the full ``C``
as resident working set (the remainder streams every request -- intra-model
swap, accounted in the service time, not here).

Every operation is O(1) amortized: a running ``used`` byte counter replaces
the per-access re-summation of all entries, and recency is the insertion
order of an ``OrderedDict`` (move-to-end on hit, pop-front on eviction)
replacing the O(n) ``min(..., key=last_used)`` eviction scan.  Simulators
access the cache at strictly increasing timestamps (server start times), so
recency order and the ``last_used`` ordering coincide and the rewrite is
behaviorally identical to the scan-based original
(``tests/test_sim_fastpath.py`` property-tests the equivalence against the
frozen reference in ``benchmarks/des_baseline.py``).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Iterable


@dataclasses.dataclass(slots=True)
class _Entry:
    bytes_resident: int
    last_used: float


class SramCache:
    def __init__(self, capacity: int):
        self.capacity = capacity
        # Keys in recency order: least-recently-used first.
        self._entries: collections.OrderedDict[int, _Entry] = (
            collections.OrderedDict()
        )
        self._used = 0

    def reset(self) -> None:
        self._entries.clear()
        self._used = 0

    @property
    def used(self) -> int:
        return self._used

    def resident(self, model_idx: int) -> bool:
        return model_idx in self._entries

    def access(self, model_idx: int, prefix_bytes: int, now: float) -> bool:
        """Touch ``model_idx``; returns True on a *miss* (weights must load).

        On a miss, LRU entries of other models are evicted until the new
        prefix's resident share (min(prefix, C)) fits.
        """
        want = min(prefix_bytes, self.capacity)
        entries = self._entries
        entry = entries.get(model_idx)
        if entry is not None and entry.bytes_resident >= want:
            entry.last_used = now
            entries.move_to_end(model_idx)
            return False
        # Miss: make room.
        if entry is not None:
            del entries[model_idx]
            self._used -= entry.bytes_resident
        while self._used + want > self.capacity and entries:
            _, lru = entries.popitem(last=False)
            self._used -= lru.bytes_resident
        entries[model_idx] = _Entry(bytes_resident=want, last_used=now)
        self._used += want
        return True

    # -- bulk state handoff (vectorized stepper fast path) ------------------
    def state(self) -> list[tuple[int, int, float]]:
        """Snapshot as ``(model_idx, bytes_resident, last_used)`` rows in
        recency order (least-recently-used first)."""
        return [
            (m, e.bytes_resident, e.last_used) for m, e in self._entries.items()
        ]

    def restore(self, state: Iterable[tuple[int, int, float]]) -> None:
        """Replace the contents with a ``state()``-shaped snapshot.

        Rows must be in recency order (least-recently-used first), as the
        fast path's run-compressed LRU replay produces them.  Validates
        before mutating: a rejected snapshot leaves the cache untouched.
        """
        rows = list(state)
        used = sum(b for _, b, _ in rows)
        if used > self.capacity:
            raise ValueError(
                f"restored state uses {used} bytes > capacity {self.capacity}"
            )
        self._entries.clear()
        for m, b, t in rows:
            self._entries[m] = _Entry(bytes_resident=b, last_used=t)
        self._used = used
