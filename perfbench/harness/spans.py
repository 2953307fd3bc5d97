"""The program's spans laid over the profiler's reading of a traced
stretch: the part of the device's idle time that the host spent inside
each span.

While a profiler records, the port (``repro_torch.tracing``) records a
span at each layer boundary, stamped on ``time.time_ns()``'s clock, the
clock on which the profiler stamps the device's operations.  A span
carries its root's id: a request's root is ``prefill``, a train step's
``train.step``.  ``idle_in`` takes the roots of one name whose host
interval overlaps the stretch's device operations, the gaps between those
operations (``trace._union``'s), and the part of each gap during which
the host was inside a chosen span of those roots (or a span under it, on
any thread), as a share of the stretch's wall time.  ``idle_by_span``
splits the gaps by the innermost span the host was in.  A program that
records no spans reads None.
"""
from __future__ import annotations

from harness.trace import Reading, _union

CALLER = "caller"      # idle_by_span's name for gap time outside every root


def program_spans() -> list | None:
    """The program's recorded spans, or None where the program has no
    tracing module."""
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    return tracing.spans()


def gaps(reading: Reading) -> list[tuple[int, int]]:
    """(start ns, end ns) of each gap between the device's operations."""
    return [(s, e) for s, e, _, _ in _union(reading.ops)[1]]


def roots(reading: Reading, spans: list, name: str, expected: int) -> list | None:
    """The root spans named ``name`` whose host interval overlaps the
    stretch's device operations; None unless there are ``expected``."""
    if not reading.ops:
        return None
    lo, hi = reading.ops[0][1], max(e for _, _, e in reading.ops)
    found = [s for s in spans if s.parent is None and s.name == name and s.start_ns < hi and s.end_ns > lo]
    return found if len(found) == expected else None


def _merged(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _overlap_ns(a: list[tuple[int, int]], b: list[tuple[int, int]]) -> int:
    """Nanoseconds in both of two sorted lists of disjoint intervals."""
    total = i = j = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _of_roots(spans: list, found: list) -> list:
    ids = {r.id for r in found}
    return [s for s in spans if s.root in ids]


def idle_in(reading: Reading | None, spans: list | None, root: str, expected: int,
            names: set[str] | None = None) -> float | None:
    """The share (%) of the stretch's wall time in which the device was
    idle between two of its operations while the host was inside a span
    named in ``names`` (every span when None) of one of the ``expected``
    roots named ``root``, or inside a span under one, on any thread."""
    if reading is None or spans is None or reading.window_s <= 0:
        return None
    found = roots(reading, spans, root, expected)
    if found is None:
        return None
    mine = _of_roots(spans, found)
    if names is not None:
        by_id = {s.id: s for s in mine}

        def under(s) -> bool:
            while s is not None:
                if s.name in names:
                    return True
                s = by_id.get(s.parent)
            return False

        mine = [s for s in mine if under(s)]
    inside = _merged([(s.start_ns, s.end_ns) for s in mine])
    return 100.0 * _overlap_ns(gaps(reading), inside) / 1e9 / reading.window_s


def idle_by_span(reading: Reading | None, spans: list | None, root: str, expected: int) -> dict[str, float] | None:
    """Seconds of the gaps between the device's operations by the
    innermost span the host was in: of the spans of the ``expected`` roots
    named ``root`` open at that moment, on any thread, the deepest (the
    newest of equal depth); ``CALLER`` where none was open."""
    if reading is None or spans is None:
        return None
    found = roots(reading, spans, root, expected)
    if found is None:
        return None
    mine = _of_roots(spans, found)
    by_id = {s.id: s for s in mine}
    depth: dict[int, int] = {}

    def depth_of(s) -> int:
        if s.id not in depth:
            parent = by_id.get(s.parent)
            depth[s.id] = 0 if parent is None else depth_of(parent) + 1
        return depth[s.id]

    out: dict[str, float] = {}
    by_start = sorted(mine, key=lambda s: s.start_ns)
    nxt, live = 0, []             # spans that start before the gap ends and may reach into it
    for g0, g1 in gaps(reading):
        while nxt < len(by_start) and by_start[nxt].start_ns < g1:
            live.append(by_start[nxt])
            nxt += 1
        live = [s for s in live if s.end_ns > g0]
        cuts = sorted({g0, g1} | {t for s in live for t in (s.start_ns, s.end_ns) if g0 < t < g1})
        for a, b in zip(cuts, cuts[1:]):
            open_ = [s for s in live if s.start_ns <= a and s.end_ns >= b]
            name = max(open_, key=lambda s: (depth_of(s), s.start_ns)).name if open_ else CALLER
            out[name] = out.get(name, 0.0) + (b - a) / 1e9
    return out
