"""The profiler's reading of a traced stretch of a run.

``Tracer`` wraps a stretch of the window in ``torch.profiler`` (the card's
activity, and the host's where a metric reads a range), synchronising the
card at both ends, and wraps each function that a metric names in
``RANGES`` in a ``record_function`` of its name while it traces, as
``chip_smoke.py::profiler_ranges`` does.  ``Reading`` holds what the
per-layer metrics read: every device operation's name and interval, the
union of those intervals (busy seconds), the traced wall time, and the
device time of the kernels launched inside each range.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import time

import torch

BREAKDOWN_ENTRIES = 10
NAME_CHARS = 160


@dataclasses.dataclass
class Reading:
    ops: list[tuple[str, int, int]]         # (name, start ns, end ns), by start
    window_s: float
    busy_s: float
    ranges: dict[str, float]                # range name -> device seconds inside it
    gaps: list[tuple[float, str]]           # (idle seconds, what lay either side)

    def device_seconds(self, pattern) -> float:
        """Device seconds of the operations whose name ``pattern`` (a
        compiled regular expression) finds."""
        return sum(e - s for n, s, e in self.ops if pattern.search(n)) / 1e9

    def breakdown(self) -> dict:
        by_name: dict[str, float] = {}
        for n, s, e in self.ops:
            by_name[n[:NAME_CHARS]] = by_name.get(n[:NAME_CHARS], 0.0) + (e - s) / 1e9
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:BREAKDOWN_ENTRIES]
        gaps = sorted(self.gaps, key=lambda g: -g[0])[:BREAKDOWN_ENTRIES]
        return {"device_ops": [[n, t] for n, t in top], "idle_gaps": [[n, t] for t, n in gaps]}


def _union(ops: list[tuple[str, int, int]]) -> tuple[int, list[tuple[int, int, str, str]]]:
    """Busy nanoseconds of the union of the intervals, and the gaps
    between them (start, end, operation before, operation after)."""
    busy, gaps = 0, []
    cur_s = cur_e = None
    last = ""                      # the operation that ends the current interval
    for n, s, e in ops:
        if cur_e is None:
            cur_s, cur_e, last = s, e, n
        elif s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s, last, n))
            cur_s, cur_e, last = s, e, n
        elif e >= cur_e:
            cur_e, last = e, n
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy, gaps


@contextlib.contextmanager
def _ranged(ranges: list[tuple[str, str]]):
    saved = []
    for mod_name, attr in ranges:
        mod = importlib.import_module(mod_name)
        fn = getattr(mod, attr)
        saved.append((mod, attr, fn))

        def call(*args, _fn=fn, _name=attr, **kw):
            with torch.profiler.record_function(_name):
                return _fn(*args, **kw)

        setattr(mod, attr, call)
    try:
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


class Tracer:
    """``with Tracer(ranges):`` around the traced stretch; ``.reading``
    afterwards.  ``ranges`` are (module, function) pairs; the host's
    activity is recorded only where there are ranges to read."""

    def __init__(self, ranges: list[tuple[str, str]]):
        self.ranges = list(dict.fromkeys(tuple(r) for r in ranges))
        self.reading: Reading | None = None
        self._stack = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if self.ranges else [])
        self._stack = contextlib.ExitStack()
        self._stack.enter_context(_ranged(self.ranges))
        torch.cuda.synchronize()
        self._prof = self._stack.enter_context(profile(activities=acts))
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        wall = time.perf_counter() - self._t0
        self._stack.close()
        if exc[0] is None:
            self.reading = read(self._prof, wall, {a for _, a in self.ranges})
        return False


def read(prof, wall_s: float, range_names: set[str]) -> Reading:
    from torch.autograd import DeviceType

    ops = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or e.is_user_annotation() or e.name() in range_names:
            continue
        ops.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
    ops.sort(key=lambda o: o[1])
    busy, gaps = _union(ops)
    ranges = {}
    if range_names:
        for ev in prof.key_averages():
            if ev.key in range_names and ev.device_type == DeviceType.CPU and ev.count:
                ranges[ev.key] = ranges.get(ev.key, 0.0) + ev.device_time_total / 1e6
    named_gaps = [((e - s) / 1e9, f"{a[:60]} -> {b[:60]}") for s, e, a, b in gaps]
    return Reading(ops, wall_s, busy / 1e9, ranges, named_gaps)
