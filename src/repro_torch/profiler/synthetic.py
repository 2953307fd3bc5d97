"""Synthetic per-segment profile generation for the paper's CNN families.

Without the physical Coral testbed, per-segment service times are derived
from a calibrated hardware model (repro/hw/specs.py) plus per-model shape
parameters:

* FLOPs are front-loaded across segments (early conv stages dominate
  compute), decaying geometrically with ``flops_decay``.
* Weights are back-loaded (late stages have wide channels), growing
  geometrically with ``weight_growth`` -- this is why offloading *trailing*
  layers relieves most memory pressure, the paper's central lever.
* Activation boundary sizes shrink with depth (spatial downsampling).
* The TPU-over-CPU speedup per segment decays geometrically from
  ``speedup_front`` to ``speedup_back`` -- a direct encoding of the paper's
  Fig. 3 observation that CPU and TPU converge in trailing segments.

CPU 1-core time of a segment is flops / cpu.ops_per_core; TPU time is the
CPU time divided by the segment's speedup.  All knobs live in the per-model
spec table (repro/configs/paper_models.py) and are calibrated so the derived
swap-overhead fractions land in the ranges the paper reports (Figs. 1-2).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.planner import ModelProfile, Segment
from repro_torch.hw.specs import Platform


@dataclasses.dataclass(frozen=True)
class SyntheticModelSpec:
    """Shape parameters for one paper model (Table II row + Fig. 3 curve)."""

    name: str
    size_mb: float
    gflops: float
    partition_points: int
    speedup_front: float = 80.0
    speedup_back: float = 1.1
    flops_decay: float = 0.70      # per-segment geometric decay of FLOPs
    weight_growth: float = 1.60    # per-segment geometric growth of weights
    input_kb: float = 150.0        # e.g. 224x224x3 int8
    final_out_kb: float = 4.0      # logits-ish boundary at the last cut


def _geometric_fractions(n: int, ratio: float) -> list[float]:
    vals = [ratio**i for i in range(n)]
    tot = sum(vals)
    return [v / tot for v in vals]


def build_profile(spec: SyntheticModelSpec, platform: Platform) -> ModelProfile:
    n = spec.partition_points
    flops_fracs = _geometric_fractions(n, spec.flops_decay)
    weight_fracs = _geometric_fractions(n, spec.weight_growth)
    total_flops = spec.gflops * 1e9
    total_bytes = int(spec.size_mb * 1e6)

    # Boundary activation sizes decay from input size to final_out_kb.
    in_b = spec.input_kb * 1e3
    out_b = spec.final_out_kb * 1e3
    if n > 1:
        act_ratio = (out_b / in_b) ** (1.0 / n)
    else:
        act_ratio = out_b / in_b

    # Per-segment TPU speedup decays geometrically front -> back.
    if n > 1:
        sp_ratio = (spec.speedup_back / spec.speedup_front) ** (1.0 / (n - 1))
    else:
        sp_ratio = 1.0

    segments: list[Segment] = []
    for i in range(n):
        flops = total_flops * flops_fracs[i]
        wbytes = int(round(total_bytes * weight_fracs[i]))
        cpu_1core = flops / platform.cpu.ops_per_core
        speedup = spec.speedup_front * sp_ratio**i
        tpu = cpu_1core / speedup
        boundary = int(in_b * act_ratio ** (i + 1))
        segments.append(
            Segment(
                name=f"{spec.name}/seg{i}",
                flops=flops,
                weight_bytes=wbytes,
                out_bytes=boundary,
                tpu_time=tpu,
                cpu_time_1core=cpu_1core,
                cpu_parallel_frac=platform.cpu.parallel_frac,
            )
        )
    # Fix rounding drift so the profile's total footprint matches Table II.
    drift = total_bytes - sum(s.weight_bytes for s in segments)
    if drift != 0:
        last = segments[-1]
        segments[-1] = dataclasses.replace(
            last, weight_bytes=last.weight_bytes + drift
        )
    return ModelProfile(
        name=spec.name,
        segments=tuple(segments),
        input_bytes=int(in_b),
    )
