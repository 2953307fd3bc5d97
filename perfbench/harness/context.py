"""What a traffic generator is given and what it gives back."""
from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass
class Context:
    cell: dict                 # the cell's entry in BENCHMARK.json
    conf: dict                 # configs/<config>.json
    traffic: dict              # traffic/<traffic>.json
    check: dict                # the "check" block of workloads/<cell>.json: what the comparison takes
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float             # time.perf_counter() at the process's start
    ranges: list = dataclasses.field(default_factory=list)   # (module, function) to range when tracing


@dataclasses.dataclass
class Outcome:
    e2e: dict[str, float]              # end-to-end metrics, by name
    attempted: int
    failed: int
    numbers: dict[str, float]          # the numbers that decide `correct`
    memory_peak: int                   # bytes, max_memory_allocated over set-up and window
    window: dict[str, Any]             # what the per-layer readers read of the window
    reading: Any = None                # harness.trace.Reading of the traced stretch (the card alone)
    ranged: Any = None                 # a stretch traced with the host too, for ranges


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def memory_peak(device: torch.device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def release(device: torch.device) -> None:
    import gc

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
