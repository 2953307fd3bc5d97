"""Shared set-up of the benchmark's CPU tests: the benchmark's modules on
``sys.path`` as ``run.py`` puts them, and tiny versions of its
configurations and traffic that a CPU runs in seconds."""
from __future__ import annotations

import sys
import time
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parents[1]
for p in (BENCH_DIR.parent / "src", BENCH_DIR / "reference", BENCH_DIR):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import torch  # noqa: E402

from harness import spec  # noqa: E402
from harness.context import Context  # noqa: E402

SEED = 2**33 + 5   # wider than 32 bits, as the checks' seeds are


def tiny_conf(name: str) -> dict:
    """The configuration ``name`` at a size a CPU runs in a second, as its
    reference family shrinks it (``tiny``)."""
    conf = spec.config_file(name)
    conf["model"] = spec.reference(conf["reference"]).tiny(conf["model"])
    return conf


def tiny_traffic(name: str) -> dict:
    t = spec.traffic_file(name)
    if t["generator"] == "prefill_cycle":
        t.update(lengths=[16, 32, 48, 64], cache_slots=64)
    else:
        t.update(seq_len=64)
    return t


def cpu_ctx(conf: dict, traffic: dict, check: dict | None = None, seed: int = SEED, seconds: float = 0.2) -> Context:
    return Context(cell={"name": "tiny", "chips": 1}, conf=conf, traffic=traffic, check=check or {}, seed=seed,
                   seconds=seconds, trace=False, device=torch.device("cpu"), t_start=time.perf_counter())


@pytest.fixture
def card():
    """The CUDA card, for tests marked ``cuda``; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
