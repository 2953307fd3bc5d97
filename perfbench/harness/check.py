"""The numbers that decide ``correct``, each beside its limit.

A cell's workload file gives every number's limit; a number is within it
when it is finite and at most the limit.  The numbers are printed as the
run's last lines on standard error and go last into the result line.
"""
from __future__ import annotations

import math
import sys

import torch


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """||got - want|| / ||want|| in float64 (Frobenius norms)."""
    g, w = got.double(), want.double().to(got.device)
    return float(torch.linalg.vector_norm(g - w) / torch.linalg.vector_norm(w).clamp_min(1e-300))


def worst_leaf_gap(got: dict[str, float], want: dict[str, float], counted: list[str]) -> tuple[float, str]:
    """The largest |got - want| of a leaf's norm over the ``counted``
    leaves, against the reference's norm of that leaf or of the median
    counted leaf, whichever is larger; with the leaf that gives it."""
    med = sorted(want[p] for p in counted)[len(counted) // 2]
    worst, at = 0.0, ""
    for p in counted:
        gap = abs(got[p] - want[p]) / max(want[p], med)
        if not gap <= worst:          # a NaN is the worst
            worst, at = gap, p
    return worst, at


def verdict(numbers: dict[str, float], limits: dict[str, float]) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}).  Every number needs a limit
    and must lie within it."""
    out, ok = {}, True
    for name, value in numbers.items():
        if name not in limits:
            raise KeyError(f"the workload file gives no limit for {name!r}")
        out[name] = {"value": value, "limit": limits[name]}
        ok &= math.isfinite(value) and value <= limits[name]
    return ok, out


def print_checks(checks: dict, correct: bool) -> None:
    for name, c in checks.items():
        mark = "ok" if math.isfinite(c["value"]) and c["value"] <= c["limit"] else "OVER"
        print(f"check {name}: {c['value']!r} limit {c['limit']!r} {mark}", file=sys.stderr)
    print(f"correct: {correct}", file=sys.stderr, flush=True)
