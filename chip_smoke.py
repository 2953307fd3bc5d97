#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line):

1. device: the card's name and power limit, as ``nvidia-smi`` reports them;
2. build: every CUDA source of the port (``src/repro_torch/kernels/csrc``),
   compiled in parallel from the checkout into ``build/repro_torch``, with
   each kernel's registers and spills; then the count of tensor-core
   instructions in the SASS of the block_matmul and flash_attention
   libraries (``HGMMA``) and of the wkv6 library (``HMMA``), none of which
   may be 0;
3. kernel vs plain: each kernel's wrapper on the card at the reference's
   test shapes and ragged ones (``block_matmul`` also at the serving path's
   shapes and, in bfloat16, at ragged tensor-core tiles and 4096^3), held
   against its plain PyTorch version; each kernel prints the route of each
   shape; wkv6 also at strong decays (|log w| up to 20, a stretch of w = 0,
   a stretch of w = 1 - 1e-4) at ragged lengths;
4. main path: ``repro_torch.launch.serve`` serving inceptionv4 + mnasnet
   through the GPU-prefix / host-suffix engine, under the SwapLess plan and
   under a forced split, with every output held against a host-only forward
   of the same weights, each kernel's launches counted and block_matmul's
   route recorded at every call;
5. where the time goes: warm requests one at a time (closed loop) under
   the SwapLess plan, and each stage's time on the card and on one host
   core;
6. model-zoo path: ``prefill_step`` of 2 x 2048-token prompts and 32 greedy
   ``decode_step``s of gemma3-1b and then rwkv6-7b, bfloat16, full width
   and depth, each kernel's launches counted and the shapes it was called at
   recorded; then each new kernel against its plain version at those shapes
   (wkv6 at mild and strong decays);
7. model-zoo correctness: float32, full width and depth, the full forward
   (kernels on every layer) against ``prefill_step`` of 16 tokens plus
   teacher-forced ``decode_step``s (which launch no hand kernel);
8. the device stepper's recurrence: ``lindley_ends`` on the card at 7,
   4097 and 2^20 requests (a clock past 5,000 s) against the float64
   ``_server_ends``, within 2e-6 s of delay;
9. ``simulate(backend="torch")`` against the stepper on the collab8, swap2
   and thrash16 mixes: integer observables equal, means and p99 within
   1e-4;
10. the replica engine: collab8, 2^20 requests, 32 service-jitter replicas;
    parity on two replicas against per-replica ``simulate`` (2e-4), then
    its wall time and throughput against the NumPy stepper over the
    replicas;
11. the plan evaluator: ``TorchPlanEvaluator`` against the NumPy batch on
    the three mixes under FCFS and swap_batch (5e-5) and the SLO
    objectives, ``hill_climb(evaluator=...)`` against the NumPy climb (cold,
    warm, swap_batch), and each frontier call timed beside the NumPy batch;
12. online control: ``run_adaptive`` on the Fig. 8 trace with the device
    stepper and a planner that scores on the card, against the defaults:
    identical re-plans, means within 1e-4, planner ms per re-plan;
13. times: CUDA-event times of each kernel at its path's shapes, its plain
    version and the one PyTorch call that computes the same function (where
    there is one), beside the card's bound, launched eagerly and replayed
    from a CUDA graph (device time alone).

Phases 8-12 run torch ops, not hand kernels (the reference jits them; none
reaches a Pallas kernel): their times, launches per call and bounds go on
a ``{"torch_ops": ...}`` line.  The line before the last is a JSON object
with one entry per kernel; the last line is ``{"ok": true, "device":
{...}}``.  Exits non-zero without a result when no CUDA device is present.
"""
from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import numpy as np  # noqa: E402

from repro_torch.configs import ARCHS, INPUT_SHAPES  # noqa: E402
from repro_torch.configs.paper_models import paper_profile  # noqa: E402
from repro_torch.core import latency  # noqa: E402
from repro_torch.core.allocator import hill_climb, prop_alloc  # noqa: E402
from repro_torch.core.objective import deadline_miss, p_tail  # noqa: E402
from repro_torch.core.plan_tables import EvalTables  # noqa: E402
from repro_torch.core.planner import FCFS, DisciplineSpec, Plan, TenantSpec, validate_plan  # noqa: E402
from repro_torch.core.torch_eval import TorchPlanEvaluator  # noqa: E402
from repro_torch.hw.specs import EDGE_TPU_PLATFORM  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import causal_attention, causal_attention_plain, route  # noqa: E402
from repro_torch.kernels.matmul import matmul, matmul_plain  # noqa: E402
from repro_torch.kernels.matmul import route as matmul_route  # noqa: E402
from repro_torch.kernels.wkv6 import route as wkv_route  # noqa: E402
from repro_torch.kernels.wkv6 import wkv6, wkv6_plain  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention, cnn, rwkv  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving import torch_stepper  # noqa: E402
from repro_torch.serving.controller import run_adaptive  # noqa: E402
from repro_torch.serving.simulator import _server_ends, make_backend, simulate  # noqa: E402
from repro_torch.serving.workload import RatePhase, Trace, dynamic_trace  # noqa: E402
from repro_torch.models.cnn import (  # noqa: E402
    PAPER_CNN_SPECS,
    build_executable,
    pointwise_shapes,
)

MODELS = ("inceptionv4", "mnasnet")   # the serve default mix
RATES = "2.0,5.0"
REQUESTS = 20                         # real requests per model and plan
K_MAX = 4
FORCED_PLAN = Plan((6, 4), (2, 2))    # a second split, both sides non-empty
OUTPUT_TOL = 1e-4                     # GPU-prefix output vs host-only forward
CLOSED_LOOP = 50                      # sequential warm requests per model
DEVICE = torch.device("cuda")

# NVIDIA H100 SXM data sheet (dense): device memory rate and the peak rate
# of the units each input type runs on (float32 outside the tensor cores,
# as TF32 is disabled; bfloat16 on the tensor cores).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.float32: 67e12, torch.bfloat16: 989e12}

# Every kernel of the port: its wrapper (which counts launches), plain
# version, source, and the TPU kernel of the JAX package it replaces.
KERNELS = [
    {
        "name": "block_matmul",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/block_matmul.cu",
        "replaces": "src/repro/kernels/block_matmul.py:17",
        "wrapper": matmul,
        "plain": matmul_plain,
        "library": torch.matmul,
    },
    {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:26",
        "wrapper": causal_attention,
    },
    {
        "name": "wkv6",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/wkv6.cu",
        "replaces": "src/repro/kernels/wkv6.py:30",
        "wrapper": wkv6,
    },
]

# (M, K, N): tests/test_kernels.py::TestMatmul's aligned shapes, and ragged ones.
TEST_SHAPES = [(128, 128, 128), (256, 128, 64), (64, 256, 128), (512, 64, 256)]
RAGGED_SHAPES = [(1, 1, 1), (37, 200, 13), (129, 65, 31), (1000, 3, 70)]
# bfloat16 only: ragged tiles with 16-byte rows on the tensor-core route.
TENSOR_CORE_SHAPES = [(200, 64, 264), (1000, 1032, 520)]
TOL = {torch.float32: 1e-3, torch.bfloat16: 2e-2}   # TestMatmul's tolerances
LARGE_SHAPE = (4096, 4096, 4096)                     # checked and timed in bfloat16 only


def main_path_shapes() -> list[tuple[int, int, int]]:
    """The pointwise products of one forward of each served model, in order."""
    return [s for name in MODELS for s in pointwise_shapes(PAPER_CNN_SPECS[name])]


def operands(shape, dtype, seed):
    m, k, n = shape
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((m, k), generator=g).to(dtype).to(DEVICE)
    y = torch.randn((k, n), generator=g).to(dtype).to(DEVICE)
    return x, y


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    print(smi.stdout.strip())
    kind = torch.cuda.get_device_name(0)
    print(f"torch device: {kind} (count {torch.cuda.device_count()}); torch {torch.__version__}, CUDA {torch.version.cuda}")
    return kind


def phase_build() -> None:
    names = [Path(k["source"]).stem for k in KERNELS]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(names)) as ex:
        paths = list(ex.map(build.build, names))
    print(f"build: {len(paths)} CUDA source(s) in {time.perf_counter() - t0:.2f} s")
    for path in paths:
        print(f"  {path.relative_to(ROOT)}")
        for line in path.with_name(path.name + ".log").read_text().splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                print(f"    {line.strip()}")


def find_cuobjdump() -> str | None:
    """``cuobjdump`` from PATH, the CUDA toolkit, or Triton's own copy."""
    found = shutil.which("cuobjdump")
    if found:
        return found
    dirs = [Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin"]
    spec = importlib.util.find_spec("triton")
    if spec and spec.submodule_search_locations:
        dirs.append(Path(spec.submodule_search_locations[0]) / "backends" / "nvidia" / "bin")
    for d in dirs:
        if (d / "cuobjdump").exists():
            return str(d / "cuobjdump")
    return None


def phase_tensor_cores(name: str, opcode: str) -> int:
    """Count the tensor-core instructions (``opcode``: HGMMA for Hopper's
    wgmma, HMMA for mma.sync) in each kernel of library ``name``'s SASS;
    fails when there are none or when no ``cuobjdump`` is found."""
    tool = find_cuobjdump()
    if tool is None:
        raise RuntimeError("cuobjdump is not available: the tensor-core route cannot be shown")
    lib = build.library_path(name)
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True, check=True, timeout=300).stdout
    counts, fn = Counter(), None
    for line in sass.splitlines():
        header = re.match(r"\s*Function : (\S+)", line)
        if header:
            fn = header.group(1)
            counts[fn] += 0
        elif fn and re.search(rf"\b{opcode}\b", line):
            counts[fn] += 1
    print(f"SASS of {lib.relative_to(ROOT)} ({tool}): {opcode} instructions per kernel")
    for fn_name, n in counts.items():
        print(f"  {n:5d}  {fn_name}")
    total = sum(counts.values())
    if total == 0:
        raise AssertionError(f"no {opcode} instruction in the {name} library: the tensor-core route is missing")
    return total


def phase_kernel_vs_plain(kernel: dict) -> dict:
    """Hold the kernel against its plain version; returns what the kernels
    line reports: the largest error on the main path's (float32) shapes,
    every shape checked and how many took each route.  Both routes must
    occur."""
    fn, plain = kernel["wrapper"], kernel["plain"]
    main = main_path_shapes()
    shapes = list(dict.fromkeys(main + TEST_SHAPES + RAGGED_SHAPES))
    checked, main_err, routes = [], 0.0, Counter()
    for dtype, extra in ((torch.float32, []), (torch.bfloat16, TENSOR_CORE_SHAPES + [LARGE_SHAPE])):
        for i, shape in enumerate(shapes + extra):
            x, y = operands(shape, dtype, seed=i)
            got = fn(x, y)
            torch.cuda.synchronize()
            want = plain(x, y)
            err = float((got.float() - want.float()).abs().max())
            tol = TOL[dtype]
            ok = torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)
            r = matmul_route(dtype, shape[0], shape[2], shape[1])
            routes[r] += 1
            print(f"  {kernel['name']} {str(dtype)[6:]} {shape} {r}: max_abs_err={err:.3e} tol={tol} {'ok' if ok else 'MISMATCH'}")
            if not ok:
                raise AssertionError(f"{kernel['name']} disagrees with its plain version at {shape} {dtype}")
            if dtype == torch.float32 and shape in main:
                main_err = max(main_err, err)
            checked.append([*shape, str(dtype)[6:]])
    if set(routes) != {"cuda-core", "tensor-core"}:
        raise AssertionError(f"block_matmul's checks did not take both routes: {dict(routes)}")
    return {"max_abs_err": main_err, "shapes_checked": checked, "routes": dict(routes)}


@contextlib.contextmanager
def recording_matmul_routes(routes: Counter):
    """Count the route of every call the CNN stages make to the matmul
    wrapper on the card (host suffixes compute the plain version).  The
    wrapper itself, and its launch count, are unchanged."""
    wrapped = cnn.matmul

    def rec(x, y, out_dtype=None):
        if x.device.type == "cuda":
            routes[matmul_route(x.dtype, x.shape[0], y.shape[1], x.shape[1])] += 1
        return wrapped(x, y, out_dtype)

    cnn.matmul = rec
    try:
        yield
    finally:
        cnn.matmul = wrapped


def phase_main_path() -> tuple[Plan, dict[str, int], dict[str, int]]:
    """Serve the mix on the card; returns the SwapLess plan, each kernel's
    launches on the path and block_matmul's routes there."""
    routes = Counter()
    for k in KERNELS:
        k["wrapper"].launches = 0
    t0 = time.perf_counter()
    with recording_matmul_routes(routes):
        plan, done = serve.main([
            "--models", ",".join(MODELS), "--rates", RATES,
            "--requests", str(REQUESTS), "--k-max", str(K_MAX), "--device", DEVICE.type,
        ])
        models = [build_executable(PAPER_CNN_SPECS[n], seed=i, device=DEVICE) for i, n in enumerate(MODELS)]
        print(f"forced split {FORCED_PLAN.partition} cores {FORCED_PLAN.cores}:")
        done_forced = serve.run_requests(models, FORCED_PLAN, K_MAX, REQUESTS, DEVICE)
        serve.report_latencies(MODELS, done_forced)
    launches = {k["name"]: k["wrapper"].launches for k in KERNELS}
    print(f"main path: {time.perf_counter() - t0:.2f} s, launches {launches}, block_matmul routes {dict(routes)}")

    # Every request completed, with finite outputs equal to a host-only
    # forward of the same weights (serve builds model i from seed i).
    host = [build_executable(PAPER_CNN_SPECS[n], seed=i, device="cpu") for i, n in enumerate(MODELS)]
    for run_plan, records in ((plan, done), (FORCED_PLAN, done_forced)):
        assert len(records) == len(MODELS) * REQUESTS, len(records)
        for c in records:
            if not c.ok:
                raise RuntimeError(f"request of {MODELS[c.model_idx]} failed") from c.error
        for i, m in enumerate(host):
            mine = sorted((c for c in records if c.model_idx == i), key=lambda c: c.submit_time)
            for s, c in enumerate(mine):
                assert c.output.device.type == "cpu" and bool(torch.isfinite(c.output).all())
                want = m.make_input(s)
                for seg in m.segments:
                    want = seg(want)
                torch.testing.assert_close(c.output, want, rtol=OUTPUT_TOL, atol=OUTPUT_TOL)
        print(f"outputs of plan {run_plan.partition} match the host-only forward to {OUTPUT_TOL}")

    # One pointwise product per prefix stage, each on the card; the CNNs
    # have no attention or recurrence.
    expected = REQUESTS * (sum(plan.partition) + sum(FORCED_PLAN.partition))
    assert launches == {"block_matmul": expected, "flash_attention": 0, "wkv6": 0}, (launches, expected)
    # Every product of the path is float32 and takes the CUDA-core route.
    assert routes == {"cuda-core": expected}, (dict(routes), expected)
    return plan, launches, dict(routes)


def phase_breakdown(plan: Plan) -> None:
    """Warm latency without queueing, and each stage's share of it."""
    models = [build_executable(PAPER_CNN_SPECS[n], seed=i, device=DEVICE) for i, n in enumerate(MODELS)]
    lat = {n: [] for n in MODELS}
    eng = ServingEngine(models, plan, k_max=K_MAX, device=DEVICE)
    try:
        for i, m in enumerate(models):       # warm every path once
            eng.submit(i, m.make_input(0))
        assert all(c.ok for c in eng.drain(timeout=120.0))
        for s in range(CLOSED_LOOP):
            for i, m in enumerate(models):
                eng.submit(i, m.make_input(s))
                (c,) = eng.drain(timeout=120.0)
                assert c.ok
                lat[MODELS[i]].append(c.latency * 1e3)
    finally:
        eng.shutdown()
    print(f"closed loop, plan {plan.partition} cores {plan.cores}, {CLOSED_LOOP} warm requests per model, one at a time:")
    for name, ls in lat.items():
        q = torch.tensor(ls, dtype=torch.float64).quantile(torch.tensor([0.5, 0.8], dtype=torch.float64))
        print(f"  {name:<14} median={float(q[0]):.3f}ms p80={float(q[1]):.3f}ms max={max(ls):.3f}ms")

    # Each stage alone: on the card (CUDA events over back-to-back calls,
    # host launch overhead included) and on one host core (as a pool
    # worker runs it).
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for m, p in zip(models, plan.partition):
            print(f"  stages of {m.name} (prefix {p}), ms per call: card / one host core")
            x_dev = m.make_input(0).to(DEVICE)
            x_host = m.make_input(0)
            for j, seg in enumerate(m.segments):
                dev_ms = time_ms(lambda: seg(x_dev), 50)
                t0 = time.perf_counter()
                for _ in range(20):
                    y_host = seg(x_host)
                host_ms = (time.perf_counter() - t0) / 20 * 1e3
                side = "card" if j < p else "host"
                print(f"    stage {j} {tuple(x_host.shape[1:])}: {dev_ms:.4f} / {host_ms:.4f}  (runs on the {side})")
                x_dev, x_host = seg(x_dev), y_host
    finally:
        torch.set_num_threads(threads)


def time_ms(fn, iters: int, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_graph_ms(fn, calls: int = 20, replays: int = 20) -> float:
    """Device time per call with the host's launch overhead taken out:
    ``calls`` calls captured in one CUDA graph, replayed ``replays`` times."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return time_ms(graph.replay, replays, warmup=2) / calls


def bound(shape, dtype) -> tuple[float, str]:
    """Least time (ms) for (M,K)@(K,N) -> (M,N) in ``dtype``: each input read
    once and the output written once at the memory rate, or 2MNK operations
    at the peak rate of the type, whichever is longer."""
    m, k, n = shape
    size = torch.empty((), dtype=dtype).element_size()
    t_bytes = (m * k + k * n + m * n) * size / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * m * n * k / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_times(kernel: dict) -> dict:
    """Per-shape times; the totals over the main path's products are the
    kernels line's numbers."""
    fn, plain, lib = kernel["wrapper"], kernel["plain"], kernel["library"]
    rows = [(s, torch.float32) for s in dict.fromkeys(main_path_shapes())]
    rows.append((LARGE_SHAPE, torch.bfloat16))
    per_shape = {}
    print(f"times of {kernel['name']} (ms per call, CUDA events):")
    for shape, dtype in rows:
        x, y = operands(shape, dtype, seed=0)
        r = matmul_route(dtype, shape[0], shape[2], shape[1])
        iters = 20 if shape == LARGE_SHAPE else 200
        t = {
            "ms": time_ms(lambda: fn(x, y), iters),
            "plain_ms": time_ms(lambda: plain(x, y), iters),
            "library_ms": time_ms(lambda: lib(x, y), iters),
            "graph_ms": time_graph_ms(lambda: fn(x, y), calls=5 if shape == LARGE_SHAPE else 20),
            "plain_graph_ms": time_graph_ms(lambda: plain(x, y), calls=5 if shape == LARGE_SHAPE else 20),
            "library_graph_ms": time_graph_ms(lambda: lib(x, y), calls=5 if shape == LARGE_SHAPE else 20),
        }
        t["bound_ms"], t["bound_by"] = bound(shape, dtype)
        per_shape[(shape, dtype)] = t
        print(
            f"  {str(dtype)[6:]} M={shape[0]} K={shape[1]} N={shape[2]} {r}: "
            f"kernel={t['ms']:.6f} plain={t['plain_ms']:.6f} torch.matmul={t['library_ms']:.6f} "
            f"bound={t['bound_ms']:.6f} ({t['bound_by']}) share={t['bound_ms'] / t['ms']:.4%}; "
            f"from a CUDA graph: kernel={t['graph_ms']:.6f} plain={t['plain_graph_ms']:.6f} "
            f"torch.matmul={t['library_graph_ms']:.6f} share={t['bound_ms'] / t['graph_ms']:.4%}"
        )
    main = [per_shape[(s, torch.float32)] for s in main_path_shapes()]
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "graph_ms", "plain_graph_ms", "library_graph_ms")
    totals = {key: sum(r[key] for r in main) for key in keys}
    by_bytes = sum(r["bound_ms"] for r in main if r["bound_by"] == "bytes")
    totals["bound_by"] = "bytes" if by_bytes >= totals["bound_ms"] / 2 else "operations"
    print(
        f"  main path ({len(main)} products, one forward of each of {', '.join(MODELS)}): "
        f"kernel={totals['ms']:.6f} plain={totals['plain_ms']:.6f} "
        f"torch.matmul={totals['library_ms']:.6f} bound={totals['bound_ms']:.6f} ({totals['bound_by']}); "
        f"from a CUDA graph: kernel={totals['graph_ms']:.6f} plain={totals['plain_graph_ms']:.6f} "
        f"torch.matmul={totals['library_graph_ms']:.6f}"
    )
    return totals


# --------------------------------------------------------------------------
# Model zoo: prefill and decode of gemma3-1b (flash_attention) and rwkv6-7b
# (wkv6) at full width and depth
# --------------------------------------------------------------------------
ZOO = ("gemma3-1b", "rwkv6-7b")
# Cut from INPUT_SHAPES["prefill_32k"] (32 prompts of 32768 tokens) to stay
# within the smoke run's time; 2048 is the reference's CHUNKED_SEQ_THRESHOLD
# and four of gemma3-1b's 512-token windows.
ZOO_BATCH, ZOO_PROMPT, ZOO_DECODE = 2, 2048, 32
ZOO_PROFILE_DECODE = 4   # decode steps under the profiler (its post-processing grows with events)
ZOO_CHECK_LEN = {"gemma3-1b": 1024, "rwkv6-7b": 256}   # f32 check: 2 windows; 8 wkv chunks
ZOO_CHECK_PREFILL = 16
ZOO_CHECK_TOL = 2e-3   # tests/test_prefill_decode.py's prefill tolerance
FLASH_TOL = {torch.float32: 5e-4, torch.bfloat16: 3e-2}   # TestFlashAttention
WKV_TOL = 2e-3                                             # TestWKV6
# (B, S, H, KV, hd, window): TestFlashAttention's shapes, a property-sweep
# sample, the first-token case, gemma3's GQA at hd 256, and ragged lengths.
FLASH_TEST_SHAPES = [
    (2, 128, 4, 2, 32, 0), (2, 128, 4, 2, 32, 64), (2, 128, 4, 2, 32, 17),
    (1, 256, 4, 2, 64, 100), (1, 32, 1, 1, 16, 16), (1, 64, 2, 2, 16, 0),
    (1, 64, 4, 1, 256, 16),
]
FLASH_RAGGED_SHAPES = [
    (1, 1, 2, 2, 16, 0), (1, 37, 4, 2, 32, 0), (2, 37, 2, 1, 64, 5),
    (1, 100, 2, 1, 128, 0), (2, 600, 4, 1, 256, 512), (1, 1000, 16, 16, 64, 0),
    (1, 33, 4, 1, 256, 0), (2, 2047, 4, 1, 256, 512),
]
# (B, T, H, hd): TestWKV6's shapes and property-sweep sample, and ragged ones.
WKV_TEST_SHAPES = [(1, 64, 2, 16), (2, 32, 2, 8), (1, 16, 1, 8), (1, 128, 4, 32)]
WKV_RAGGED_SHAPES = [(1, 1, 2, 64), (1, 37, 3, 32), (3, 100, 4, 64), (2, 33, 64, 64)]


def flash_operands(shape, dtype, seed):
    b, s, h, kv, hd, _ = shape
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((b, s, h, hd), generator=g).to(dtype).to(DEVICE)
    k = torch.randn((b, s, kv, hd), generator=g).to(dtype).to(DEVICE)
    v = torch.randn((b, s, kv, hd), generator=g).to(dtype).to(DEVICE)
    return q, k, v


def wkv_operands(shape, dtype, seed, with_state, decays="mild"):
    """r, k, v in ``dtype``; float32 u and initial state; float32 decays,
    ``mild``: exp(-exp(-2 + noise)) as the model's initialisation gives them
    (|log w| about 0.14); ``strong``: exp(-exp(x)) with |log w| from 0.0025
    up to 20, a stretch of 20 tokens of w = 0 and one of 70 tokens of
    w = 1 - 1e-4."""
    b, t, h, hd = shape
    g = torch.Generator().manual_seed(seed)
    r, k, v = (torch.randn((b, t, h, hd), generator=g).to(dtype).to(DEVICE) for _ in range(3))
    if decays == "mild":
        w = torch.exp(-torch.exp(-2.0 + 0.5 * torch.randn((b, t, h, hd), generator=g)))
    else:
        x = torch.rand((b, t, h, hd), generator=g) * (math.log(20.0) + 6.0) - 6.0
        w = torch.exp(-torch.exp(x))
        w[:, t // 4:t // 4 + 20] = 0.0
        w[:, t // 2:t // 2 + 70] = 1.0 - 1e-4
    w = w.to(DEVICE)
    u = (0.1 * torch.randn((h, hd), generator=g)).to(DEVICE)
    state = torch.randn((b, h, hd, hd), generator=g).to(DEVICE) if with_state else None
    return r, k, v, w, u, state


def check_flash(shapes, dtypes) -> float:
    """Kernel vs plain version; returns the largest absolute error."""
    worst = 0.0
    for dtype in dtypes:
        for i, shape in enumerate(shapes):
            q, k, v = flash_operands(shape, dtype, seed=i)
            scale, window = shape[4] ** -0.5, shape[5]
            got = causal_attention(q, k, v, scale=scale, window=window)
            torch.cuda.synchronize()
            want = causal_attention_plain(q, k, v, scale=scale, window=window)
            err = float((got.float() - want.float()).abs().max())
            tol = FLASH_TOL[dtype]
            ok = torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)
            print(
                f"  flash_attention {str(dtype)[6:]} (B,S,H,KV,hd,window)={shape} {route(dtype, shape[4])}: "
                f"max_abs_err={err:.3e} tol={tol} {'ok' if ok else 'MISMATCH'}"
            )
            if not ok:
                raise AssertionError(f"flash_attention disagrees with its plain version at {shape} {dtype}")
            worst = max(worst, err)
    return worst


def check_wkv6(shapes, dtypes, decays="mild") -> float:
    """Kernel vs plain version, from a zero and from a random state, output
    and final state, both finite; returns the largest absolute error."""
    worst = 0.0
    for dtype in dtypes:
        for i, shape in enumerate(shapes):
            for with_state in (False, True):
                args = wkv_operands(shape, dtype, seed=i, with_state=with_state, decays=decays)
                out, state = wkv6(*args)
                torch.cuda.synchronize()
                want_out, want_state = wkv6_plain(*args)
                err = max(float((out - want_out).abs().max()), float((state - want_state).abs().max()))
                finite = bool(torch.isfinite(out).all() and torch.isfinite(state).all())
                ok = finite and torch.allclose(out, want_out, rtol=WKV_TOL, atol=WKV_TOL) and torch.allclose(
                    state, want_state, rtol=WKV_TOL, atol=WKV_TOL
                )
                print(
                    f"  wkv6 r,k,v {str(dtype)[6:]} (B,T,H,hd)={shape} {wkv_route(dtype, shape[3])} {decays} decays, "
                    f"{'random' if with_state else 'zero'} state: max_abs_err={err:.3e} "
                    f"(|out| up to {float(want_out.abs().max()):.1f}) finite={finite} tol={WKV_TOL} {'ok' if ok else 'MISMATCH'}"
                )
                if not ok:
                    raise AssertionError(f"wkv6 disagrees with its plain version at {shape} {dtype} ({decays} decays)")
                worst = max(worst, err)
    return worst


@contextlib.contextmanager
def recording_kernel_calls(calls: Counter):
    """Count each (kernel, shape, dtype) the model path calls its wrappers
    with.  The wrappers themselves, and their launch counts, are unchanged."""
    flash, recur = attention.causal_attention, rwkv.wkv6

    def flash_rec(q, k, v, *, scale, window=0):
        calls["flash_attention", (*q.shape[:3], k.shape[2], q.shape[3], window), q.dtype] += 1
        return flash(q, k, v, scale=scale, window=window)

    def wkv_rec(r, k, v, w, u, state=None):
        calls["wkv6", tuple(r.shape), r.dtype] += 1
        return recur(r, k, v, w, u, state)

    attention.causal_attention, rwkv.wkv6 = flash_rec, wkv_rec
    try:
        yield
    finally:
        attention.causal_attention, rwkv.wkv6 = flash, recur


def launch_counts() -> dict[str, int]:
    return {k["name"]: k["wrapper"].launches for k in KERNELS}


def serve_prompts(cfg, params, tokens, timed: bool):
    """prefill_step on ``tokens``, then ZOO_DECODE greedy decode_steps.
    Returns (launches after prefill, launches after decode, all logits
    finite, prefill ms, decode ms per token); the times are CUDA events
    when ``timed``."""
    max_len = tokens.shape[1] + ZOO_DECODE
    start, mid, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    torch.cuda.synchronize()
    start.record()
    logits, caches = tf.prefill_step(cfg, params, {"tokens": tokens}, max_len)
    mid.record()
    after_prefill = launch_counts()
    finite = torch.isfinite(logits).all()
    for i in range(ZOO_DECODE):
        nxt = logits[:, -1].argmax(dim=-1, keepdim=True)
        logits, caches = tf.decode_step(cfg, params, caches, nxt, tokens.shape[1] + i)
        finite &= torch.isfinite(logits).all()
    end.record()
    end.synchronize()
    prefill_ms = start.elapsed_time(mid) if timed else float("nan")
    decode_ms = mid.elapsed_time(end) / ZOO_DECODE if timed else float("nan")
    return after_prefill, launch_counts(), bool(finite), prefill_ms, decode_ms


def device_breakdown(label: str, fn) -> None:
    """Device time by kernel over one call of ``fn`` (torch.profiler), and the
    share of the wall time in which the device was busy.  The profiler's own
    host overhead lengthens the wall time, so that share is a lower bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = sorted(
        (
            (e.self_device_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
        ),
        reverse=True,
    )
    busy = sum(t for t, _, _ in kernels)
    if busy <= 0:
        print(f"  {label}: the profiler saw no device time (busy share not measured)")
        return
    print(
        f"  {label}: device busy {busy:.3f} ms of {wall_ms:.3f} ms wall under the profiler "
        f"({busy / wall_ms:.2%}); device time by kernel:"
    )
    for t, n, key in kernels[:8]:
        print(f"    {t:10.3f} ms {t / busy:8.2%}  x{n:<6} {key[:100]}")


def phase_zoo_path(name: str, calls: Counter) -> dict[str, int]:
    """Serve ZOO_BATCH prompts of ZOO_PROMPT tokens of ``name`` in bfloat16
    at full width and depth; returns each kernel's launches in one prefill
    and decode."""
    cfg = ARCHS[name]
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = tf.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(0), device=DEVICE)
    tokens = torch.randint(
        0, cfg.vocab_size, (ZOO_BATCH, ZOO_PROMPT), device=DEVICE,
        generator=torch.Generator(device=DEVICE).manual_seed(1),
    )
    print(
        f"{name}: {tf.count_params(cfg) / 1e9:.3f} B parameters in bfloat16, "
        f"init {time.perf_counter() - t0:.2f} s"
    )
    for k in KERNELS:
        k["wrapper"].launches = 0
    with recording_kernel_calls(calls):
        after_prefill, after_decode, finite, _, _ = serve_prompts(cfg, params, tokens, timed=False)
    want = {
        "block_matmul": 0,
        "flash_attention": cfg.n_layers if cfg.block == "transformer" else 0,
        "wkv6": cfg.n_layers if cfg.block == "rwkv6" else 0,
    }
    print(f"  launches: after prefill {after_prefill}, after {ZOO_DECODE} decode steps {after_decode}")
    assert after_prefill == after_decode == want, (after_prefill, after_decode, want)
    assert finite, f"{name}: non-finite logits"
    _, _, finite, prefill_ms, decode_ms = serve_prompts(cfg, params, tokens, timed=True)
    assert finite, f"{name}: non-finite logits"
    peak = torch.cuda.max_memory_allocated() / 2**30
    max_len = ZOO_PROMPT + ZOO_DECODE
    device_breakdown("one prefill", lambda: tf.prefill_step(cfg, params, {"tokens": tokens}, max_len))
    logits, caches = tf.prefill_step(cfg, params, {"tokens": tokens}, max_len)
    nxt = logits[:, -1].argmax(dim=-1, keepdim=True)

    def decode_steps():
        for i in range(ZOO_PROFILE_DECODE):
            tf.decode_step(cfg, params, caches, nxt, ZOO_PROMPT + i)

    device_breakdown(f"{ZOO_PROFILE_DECODE} decode steps", decode_steps)
    del logits, caches
    full = INPUT_SHAPES["prefill_32k"]
    print(
        f"  warm: prefill of {ZOO_BATCH} x {ZOO_PROMPT} tokens {prefill_ms:.3f} ms, "
        f"decode {decode_ms:.3f} ms per step of {ZOO_BATCH} tokens, all logits finite, "
        f"peak memory {peak:.2f} GiB (batch and length cut from {full.name}'s "
        f"{full.global_batch} x {full.seq_len}); {time.perf_counter() - t0:.2f} s"
    )
    del params
    torch.cuda.empty_cache()
    return {k: v for k, v in after_decode.items() if v}


def phase_zoo_check(name: str) -> None:
    """float32 at full width and depth: the full forward of T tokens
    (kernels on every layer) against prefill_step of the first
    ZOO_CHECK_PREFILL tokens plus teacher-forced decode_steps, which launch
    no hand kernel; logits within ZOO_CHECK_TOL and the same argmax at
    every position."""
    cfg, t_len = ARCHS[name], ZOO_CHECK_LEN[name]
    t0 = time.perf_counter()
    params = tf.init_params(
        cfg, torch.Generator(device=DEVICE).manual_seed(2), device=DEVICE, dtype=torch.float32
    )
    tokens = torch.randint(
        0, cfg.vocab_size, (1, t_len), device=DEVICE, generator=torch.Generator(device=DEVICE).manual_seed(3)
    )
    full = tf.unembed(cfg, params, tf.backbone(cfg, params, tf.embed_inputs(cfg, params, {"tokens": tokens})))[0]
    errs = torch.zeros(t_len, device=DEVICE)
    excess = torch.zeros(t_len, device=DEVICE)       # max(|a - b| - tol * |b|) per position
    agree = torch.zeros(t_len, dtype=torch.bool, device=DEVICE)
    gap = torch.zeros(t_len, device=DEVICE)          # top-2 gap of the full forward's logits

    def compare(t, logits):
        want = full[t]
        d = (logits - want).abs()
        errs[t] = d.max()
        excess[t] = (d - ZOO_CHECK_TOL * want.abs()).max()
        agree[t] = logits.argmax() == want.argmax()
        top2 = want.topk(2).values
        gap[t] = top2[0] - top2[1]

    p = ZOO_CHECK_PREFILL
    logits, caches = tf.prefill_step(cfg, params, {"tokens": tokens[:, :p]}, max_len=t_len)
    compare(p - 1, logits[0, 0])
    for t in range(p, t_len):
        logits, caches = tf.decode_step(cfg, params, caches, tokens[:, t : t + 1], t)
        compare(t, logits[0, 0])
    span = slice(p - 1, t_len)
    worst, worst_excess = float(errs[span].max()), float(excess[span].max())
    n_agree, n = int(agree[span].sum()), t_len - p + 1
    print(
        f"{name} float32, {t_len} tokens: full forward vs prefill of {p} + {t_len - p} decode steps: "
        f"max_abs_err={worst:.3e} (|logit| up to {float(full.abs().max()):.2f}), tol {ZOO_CHECK_TOL} abs + rel, "
        f"argmax agrees at {n_agree}/{n} positions (smallest top-2 gap {float(gap[span].min()):.3e}); "
        f"{time.perf_counter() - t0:.2f} s"
    )
    if worst_excess > ZOO_CHECK_TOL or n_agree != n:
        raise AssertionError(f"{name}: prefill + decode disagrees with the full forward")
    del params, full, caches
    torch.cuda.empty_cache()


def flash_bound(key, dtype) -> tuple[float, str]:
    """Least time (ms): q, k, v read and out written once at the memory
    rate, or 4 * hd operations per unmasked (query, key) pair and head (the
    two products) at the peak rate of the type, whichever is longer."""
    b, s, h, kv, hd, window = key
    size = torch.empty((), dtype=dtype).element_size()
    t_bytes = (2 * b * s * h * hd + 2 * b * s * kv * hd) * size / HBM_BYTES_PER_S * 1e3
    w = window if window > 0 else s
    pairs = sum(min(i + 1, w) for i in range(s))
    t_ops = 4.0 * hd * pairs * b * h / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def wkv_bound(key, dtype) -> tuple[float, str]:
    """Least time (ms): r, k, v (``dtype``), w, u, the initial state read
    and out and the final state (float32) written once at the memory rate,
    or 5 * hd^2 operations per token and head (r^T S, k v^T, diag(w) S + kv)
    at the peak rate of r, k, v's type, whichever is longer."""
    b, t, h, hd = key
    size = torch.empty((), dtype=dtype).element_size()
    n = b * t * h * hd
    t_bytes = (3 * n * size + n * 4 + h * hd * 4 + 2 * b * h * hd * hd * 4 + n * 4) / HBM_BYTES_PER_S * 1e3
    t_ops = 5.0 * hd * hd * b * t * h / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sdpa_call(q, k, v, scale, window):
    """The library yardstick: one F.scaled_dot_product_attention call on the
    same inputs (heads-first views, GQA by enable_gqa; the causal flag for
    global layers, a boolean mask, made once, for windowed ones)."""
    qh, kh, vh = (a.transpose(1, 2) for a in (q, k, v))
    if window <= 0:
        return lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=True, scale=scale, enable_gqa=True)
    pos = torch.arange(q.shape[1], device=q.device)
    mask = (pos[None, :] <= pos[:, None]) & (pos[:, None] - pos[None, :] < window)
    return lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask, scale=scale, enable_gqa=True)


def phase_zoo_times(calls: Counter) -> dict[str, dict]:
    """Times of flash_attention and wkv6 at each shape their path called
    them with; the totals over one prefill (each shape times its calls) are
    the kernels line's numbers."""
    totals = {}
    for name in ("flash_attention", "wkv6"):
        rows = [(key, dtype, n) for (kname, key, dtype), n in calls.items() if kname == name]
        tot = Counter()
        by_bytes = 0.0
        print(f"times of {name} (ms per call, CUDA events) at its model-zoo path's shapes:")
        for key, dtype, n in rows:
            if name == "flash_attention":
                q, k, v = flash_operands(key, dtype, seed=0)
                scale, window = key[4] ** -0.5, key[5]
                fn = lambda: causal_attention(q, k, v, scale=scale, window=window)  # noqa: E731
                plain = lambda: causal_attention_plain(q, k, v, scale=scale, window=window)  # noqa: E731
                lib = sdpa_call(q, k, v, scale, window)
                lib_err = float((lib().transpose(1, 2).float() - fn().float()).abs().max())
                bound_ms, bound_by = flash_bound(key, dtype)
                label = f"(B,S,H,KV,hd,window)={key}"
            else:
                args = wkv_operands(key, dtype, seed=0, with_state=False)
                fn = lambda: wkv6(*args)  # noqa: E731
                plain = lambda: wkv6_plain(*args)  # noqa: E731
                lib = None
                bound_ms, bound_by = wkv_bound(key, dtype)
                label = f"(B,T,H,hd)={key} {wkv_route(dtype, key[3])}"
            t = {
                "ms": time_ms(fn, 20),
                "graph_ms": time_graph_ms(fn, calls=10, replays=5),
                "plain_ms": time_ms(plain, 2, warmup=1),
                "library_ms": time_ms(lib, 20) if lib else None,
                "library_graph_ms": time_graph_ms(lib, calls=10, replays=5) if lib else None,
                "bound_ms": bound_ms,
            }
            print(
                f"  {str(dtype)[6:]} {label}, {n} calls per prefill: kernel={t['ms']:.6f} "
                f"graph={t['graph_ms']:.6f} plain={t['plain_ms']:.6f} "
                + (f"sdpa={t['library_ms']:.6f} sdpa_graph={t['library_graph_ms']:.6f} "
                   f"(max |sdpa - kernel| {lib_err:.3e}) " if lib else "library=none ")
                + f"bound={bound_ms:.6f} ({bound_by}) share={bound_ms / t['ms']:.4%} "
                f"graph share={bound_ms / t['graph_ms']:.4%}"
            )
            for key2, val in t.items():
                if val is not None:
                    tot[key2] += n * val
            if bound_by == "bytes":
                by_bytes += n * bound_ms
        out = {
            "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": "bytes" if by_bytes >= tot["bound_ms"] / 2 else "operations",
            "library_ms": tot["library_ms"] if name == "flash_attention" else None,
            "graph_ms": tot["graph_ms"],
            "library_graph_ms": tot["library_graph_ms"] if name == "flash_attention" else None,
        }
        print(f"  one prefill ({sum(n for _, _, n in rows)} calls): " + ", ".join(
            f"{k2}={v2:.6f}" if isinstance(v2, float) else f"{k2}={v2}" for k2, v2 in out.items()
        ))
        totals[name] = out
    return totals


# --------------------------------------------------------------------------
# SwapLess simulators, plan evaluator and online controller on the card: the
# reference's jitted recurrences (ROADMAP B1-B5), ported as torch ops
# --------------------------------------------------------------------------
SIM_HW = EDGE_TPU_PLATFORM
SWAP_BATCH = DisciplineSpec(kind="swap_batch", batch_cap=64)
LINDLEY_SIZES = (7, 4097, 1 << 20)      # 2^20 is the replica engine's size
DELAY_TOL = 2e-6                        # tests/test_jax_sim.py, seconds of delay
STAT_REL = 1e-4                         # means and p99, torch vs stepper backend
BACKEND_REQUESTS = 6000
REPLICA_REQUESTS, REPLICAS = 1 << 20, 32
# benchmarks/jax_throughput.py::_RATES: collab8 at ~0.6 TPU utilization (at
# 25 req/s per tenant its 4 full-TPU squeezenets would saturate the queue).
REPLICA_RATES = [2.4] * 4 + [15.0] * 4
REPLICA_REL = 2e-4
EVAL_RTOL = 5e-5
# benchmarks/fig8_dynamic.py: mnasnet + inceptionv4, seed 5.
FIG8_MODELS = ("mnasnet", "inceptionv4")
FIG8_PHASES = [
    RatePhase(0.0, 300.0, (5.0, 1.0)),
    RatePhase(300.0, 600.0, (5.0, 3.0)),
    RatePhase(600.0, 900.0, (5.0, 5.0)),
]
FIG8_KW = dict(replan_period=30.0, window=30.0, initial_rates=(5.0, 1.0))


def sim_mixes() -> dict[str, tuple[list[TenantSpec], Plan]]:
    """benchmarks/sim_throughput.py::_mixes, without its size caps."""
    sq, mb = paper_profile("squeezenet"), paper_profile("mobilenetv2")
    eff, gpu = paper_profile("efficientnet"), paper_profile("gpunet")
    mn = paper_profile("mnasnet")
    collab_profiles = [sq] * 4 + [mb] * 4
    collab = Plan(tuple([sq.num_partition_points] * 4 + [1] * 4), tuple([0] * 4 + [1] * 4))
    thrash_profiles = [sq, mb, mn, eff] * 4
    thrash = Plan(tuple(p.num_partition_points for p in thrash_profiles), tuple(0 for _ in thrash_profiles))
    mixes = {
        "collab8": ([TenantSpec(p, 1.0) for p in collab_profiles], collab),
        "swap2": ([TenantSpec(p, 1.0) for p in (eff, gpu)], Plan((6, 5), (0, 0))),
        "thrash16": ([TenantSpec(p, 1.0) for p in thrash_profiles], thrash),
    }
    for ts, plan in mixes.values():
        validate_plan(plan, ts, SIM_HW.cpu.n_cores)
    return mixes


def poisson_columns(rates, n_req, seed) -> Trace:
    """Merged-Poisson trace with per-model rates (sorted, unit scale), as
    tests/test_jax_sim.py and benchmarks/jax_throughput.py draw it."""
    rng = np.random.default_rng(seed)
    lam = float(sum(rates))
    arr = np.cumsum(rng.exponential(1.0 / lam, n_req))
    mi = rng.choice(len(rates), size=n_req, p=np.asarray(rates) / lam).astype(np.int64)
    return Trace(mi, arr)


@contextlib.contextmanager
def capturing(module, name: str, calls: list):
    """Record the arguments of every call to ``module.name`` (a torch-op
    function of the port) while the block runs, so that the call can be
    timed alone at the shapes its path gave it."""
    fn = getattr(module, name)

    def rec(*args, **kwargs):
        calls.append((args, kwargs))
        return fn(*args, **kwargs)

    setattr(module, name, rec)
    try:
        yield fn
    finally:
        setattr(module, name, fn)


def device_activity(fn) -> dict:
    """Kernels and copies the profiler saw on the card during one call of
    ``fn`` (after a warm call); ``None`` counts where it saw nothing."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    for _ in range(2):   # the profiler now and then reports an empty cycle
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = copies = 0
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                if e.name.startswith(("Memcpy", "Memset")):
                    copies += 1
                else:
                    kernels += 1
        if kernels:
            return {"kernels": kernels, "copies": copies}
    return {"kernels": None, "copies": None}


def op_bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """Least time (ms) for float32 work: bytes at the memory rate or
    operations at the float32 peak, whichever is longer."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS_PER_S[torch.float32] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*xs) -> int:
    return sum(x.numel() * x.element_size() for x in xs if isinstance(x, torch.Tensor))


def timed_host(fn, reps: int = 1):
    """(result, best host ms over ``reps``)."""
    best, out = math.inf, None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return out, best


def op_entry(replaces: str, fn, n_bytes: float, n_ops: float, host_ms: float, iters: int, **extra) -> dict:
    """One torch_ops row: device time per call (CUDA events), launches per
    call (profiler), the bound, and the host NumPy time of the same work."""
    ms = time_ms(fn, iters, warmup=2)
    bound_ms, bound_by = op_bound(n_bytes, n_ops)
    return {
        "replaces": replaces, "ms": ms, **device_activity(fn), "bound_ms": bound_ms,
        "bound_by": bound_by, "bound_share": bound_ms / ms, "host_numpy_ms": host_ms, **extra,
    }


def phase_lindley() -> dict:
    """``lindley_ends`` on the card against the float64 ``_server_ends``;
    returns B1's row, timed at 2^20 requests."""
    row = None
    torch_stepper.lindley_ends(np.arange(4.0), np.ones(4), 0.0, device=DEVICE)   # context and allocator warm-up
    for n in LINDLEY_SIZES:
        rng = np.random.default_rng(n)
        enq = np.cumsum(rng.exponential(0.005, n))   # 200 req/s: 2^20 requests reach ~5,240 s
        svc = rng.exponential(0.004, n)               # utilization 0.8
        calls = []
        with capturing(torch_stepper, "_delays", calls):
            got, card_ms = timed_host(lambda: torch_stepper.lindley_ends(enq, svc, 0.0, device=DEVICE))
        want, host_ms = timed_host(lambda: _server_ends(enq, svc, 0.0))
        err = float(np.abs((got - enq) - (want - enq)).max())
        print(f"  lindley_ends n={n}: clock {enq[-1]:.1f} s, max |delay - float64| = {err:.3e} s "
              f"(tol {DELAY_TOL}); card {card_ms:.3f} ms with copies, _server_ends {host_ms:.3f} ms")
        if not err <= DELAY_TOL:
            raise AssertionError(f"lindley_ends at n={n} is {err:.3e} s off the float64 recurrence")
        if n == LINDLEY_SIZES[-1]:
            (args, _), = calls
            a, b, x_init, c, l = args
            row = op_entry(
                "src/repro/serving/jax_stepper.py:88", lambda: torch_stepper._delays(a, b, x_init, c, l),
                n_bytes=3 * a.numel() * 4, n_ops=2 * a.numel(), host_ms=host_ms, iters=20,
                shape=[int(a.shape[0]), c, l], max_abs_err_s=err, call_with_copies_ms=card_ms,
            )
    return row


def phase_backends() -> dict:
    """``simulate(backend="torch")`` against the stepper on the three mixes."""
    out = {}
    for name, (ts, plan) in sim_mixes().items():
        trace = poisson_columns([2.0] * len(ts), BACKEND_REQUESTS, seed=11)
        want, host_ms = timed_host(lambda: simulate(ts, plan, SIM_HW, trace, warmup_frac=0.0))
        got, card_ms = timed_host(lambda: simulate(ts, plan, SIM_HW, trace, warmup_frac=0.0, backend="torch", device=DEVICE))
        worst = 0.0
        assert got.misses == want.misses and got.tpu_requests == want.tpu_requests, name
        for m in range(len(ts)):
            assert len(got.latencies[m]) == len(want.latencies[m]), (name, m)
            assert np.array_equal(got.arrivals[m], want.arrivals[m]), (name, m)
            for stat in ("mean_latency", "p99"):
                a, b = getattr(want, stat)(m), getattr(got, stat)(m)
                worst = max(worst, abs(b - a) / abs(a))
                if not math.isclose(b, a, rel_tol=STAT_REL, abs_tol=1e-6):
                    raise AssertionError(f"{name} model {m} {stat}: torch {b} vs stepper {a}")
        print(f"  {name}: {BACKEND_REQUESTS} requests, integer observables equal, worst mean/p99 "
              f"rel diff {worst:.3e} (tol {STAT_REL}); torch backend {card_ms:.1f} ms, stepper {host_ms:.1f} ms")
        out[name] = {"worst_rel": worst, "torch_ms": card_ms, "stepper_ms": host_ms}
    return out


def phase_replicas() -> dict:
    """The Monte-Carlo replica engine at the reference benchmark's headline
    size: parity on two replicas, then throughput against the NumPy
    stepper; returns the engine's numbers and B2's and B3's rows."""
    ts, plan = sim_mixes()["collab8"]
    profs = [t.profile for t in ts]
    trace = poisson_columns(REPLICA_RATES, REPLICA_REQUESTS, seed=0)
    scales = np.random.default_rng(1).uniform(0.8, 1.25, size=(REPLICAS, len(profs)))
    mi = trace.model_idx

    stats = make_backend("torch", profs, plan, SIM_HW, device=DEVICE).run_trace_replicas(trace, scales[:2])
    worst = 0.0
    for r in range(2):
        want = simulate(ts, plan, SIM_HW, Trace(mi, trace.arrival, scales[r][mi]), warmup_frac=0.0)
        assert list(stats.misses) == want.misses
        assert math.isclose(stats.tpu_busy[r], want.tpu_busy, rel_tol=1e-4)
        for m in range(len(profs)):
            assert stats.counts[m] == len(want.latencies[m])
            a = want.mean_latency(m)
            worst = max(worst, abs(stats.mean_latency[r, m] - a) / a)
            if not math.isclose(stats.mean_latency[r, m], a, rel_tol=REPLICA_REL):
                raise AssertionError(f"replica {r} model {m}: {stats.mean_latency[r, m]} vs {a}")
    print(f"  parity on 2 replicas x {REPLICA_REQUESTS} requests: worst mean rel diff {worst:.3e} (tol {REPLICA_REL}), "
          f"counts, misses and busy equal")

    sim = make_backend("torch", profs, plan, SIM_HW, device=DEVICE)
    tpu_calls, cpu_calls = [], []
    with capturing(torch_stepper, "_tpu_replicas", tpu_calls), capturing(torch_stepper, "_cpu_replicas", cpu_calls):
        sim.run_trace_replicas(trace, scales)     # first run: allocator warm-up
    walls, events = [], []
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        sim.run_trace_replicas(trace, scales)
        end.record()
        walls.append(time.perf_counter() - t0)
        end.synchronize()
        events.append(start.elapsed_time(end) / 1e3)
    t0 = time.perf_counter()
    for r in range(REPLICAS):
        simulate(ts, plan, SIM_HW, Trace(mi, trace.arrival, scales[r][mi]), warmup_frac=0.0)
    numpy_s = time.perf_counter() - t0
    work = REPLICA_REQUESTS * REPLICAS
    engine = {
        "n_requests": REPLICA_REQUESTS, "n_replicas": REPLICAS, "card_wall_s": min(walls),
        "card_events_s": min(events), "numpy_stepper_s": numpy_s,
        "card_replica_requests_per_s": work / min(walls), "numpy_replica_requests_per_s": work / numpy_s,
        "parity_worst_rel": worst,
    }
    print(f"  run_trace_replicas on the card: {min(walls):.4f} s wall, {min(events):.4f} s between CUDA events "
          f"(best of 3) = {work / min(walls):.4g} replica-requests/s; NumPy stepper over the {REPLICAS} replicas "
          f"{numpy_s:.3f} s = {work / numpy_s:.4g} replica-requests/s ({numpy_s / min(walls):.2f}x)")

    (args, _), = tpu_calls
    base, miss_load, g, tm, sc, x_init, c, l, n_models = args
    r_, p_ = REPLICAS, base.numel()
    b2 = op_entry(
        "src/repro/serving/jax_stepper.py:161", lambda: torch_stepper._tpu_replicas(*args),
        n_bytes=nbytes(base, miss_load, g, tm, sc, x_init) + 4 * r_ * p_ + 8 * r_ * n_models + 8 * r_,
        n_ops=4 * r_ * p_, host_ms=numpy_s * 1e3, iters=5, shape=[r_, c, l],
        note="host_numpy_ms is the whole NumPy stepper over the replicas",
    )
    (args3, _) = cpu_calls[0]
    d_tpu, sel, g_host, svc, x0, c3, l3 = args3
    n_i = sel.numel()
    b3 = op_entry(
        "src/repro/serving/jax_stepper.py:184", lambda: torch_stepper._cpu_replicas(*args3),
        n_bytes=nbytes(sel, g_host, svc) + 2 * 4 * r_ * n_i + 8 * r_, n_ops=4 * r_ * n_i,
        host_ms=None, iters=10, shape=[r_, c3, l3], calls_per_run=len(cpu_calls),
    )
    for key, row in (("B2", b2), ("B3", b3)):
        print(f"  {key}: {row['ms']:.4f} ms a call on the card, {row['kernels']} kernels + {row['copies']} copies, "
              f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}, {row['bound_share']:.2%})")
    device_breakdown("B2, one call", lambda: torch_stepper._tpu_replicas(*args))
    return {"engine": engine, "B2": b2, "B3": b3}


def feasible_plans(ts, k_max, n_plans=48, seed=2):
    rng = np.random.default_rng(seed)
    p_max = np.array([t.profile.num_partition_points for t in ts])
    P = rng.integers(0, p_max + 1, size=(n_plans, len(ts)))
    K = np.zeros_like(P)
    keep = np.ones(n_plans, dtype=bool)
    for b in range(n_plans):
        try:
            K[b] = prop_alloc(ts, P[b], k_max)
        except ValueError:
            keep[b] = False
    return P[keep], K[keep]


def phase_evaluator() -> dict:
    """``TorchPlanEvaluator`` on the card against the NumPy batch, and
    ``hill_climb(evaluator=...)`` against the NumPy batched climb; returns
    B4's and B5's rows, timed per frontier call of the warm climb."""
    rows = {}
    extensions = 0
    for name, (base_ts, _) in sim_mixes().items():
        rates = np.random.default_rng(1).uniform(0.5, 4.0, len(base_ts))
        ts = [TenantSpec(t.profile, float(r), deadline=0.5) for t, r in zip(base_ts, rates)]
        k_max = max(4, len(ts))
        et = EvalTables.build(ts, SIM_HW, k_max)
        ev = TorchPlanEvaluator.from_tables(et, device=DEVICE)
        P, K = feasible_plans(ts, k_max)
        for disc in (FCFS, SWAP_BATCH):
            want = latency.objective_batch(ts, P, K, SIM_HW, tables=et, discipline=disc)
            got = ev.objective_batch(P, K, discipline=disc)
            finite = np.isfinite(want)
            err = float(np.max(np.abs(got[finite] / want[finite] - 1.0)))
            if not (np.array_equal(np.isinf(want), np.isinf(got)) and err <= EVAL_RTOL):
                raise AssertionError(f"{name} {disc.kind}: evaluator off the NumPy batch by {err:.3e}")
            print(f"  {name} {disc.kind}: {len(P)} plans, max rel diff {err:.3e} (rtol {EVAL_RTOL})")
        # A deadline-miss value is a rate-weighted sum of probabilities formed
        # as 1 - (1 - p)(1 - q): float32 leaves ~1e-7 of each, so that sum
        # (total rate ~16/s here) is held to 1e-6 absolute as well (the
        # reference's JaxPlanEvaluator is off the NumPy batch by as much).
        for obj, atol in ((p_tail(0.99), 1e-7), (deadline_miss(), 1e-6)):
            want = latency.penalized_objective_batch(ts, P, K, SIM_HW, tables=et, objective=obj)
            got = ev.penalized_objective_batch(P, K, objective=obj, deadlines=np.full(len(ts), 0.5))
            if not np.allclose(got, want, rtol=EVAL_RTOL, atol=atol):
                raise AssertionError(f"{name} {obj.kind}: evaluator off the NumPy batch")
        cold, _ = hill_climb(ts, SIM_HW, k_max, tables=et, batch=True)
        calls = []
        with capturing(ev, "penalized_objective_batch", calls):
            cold_dev, _ = hill_climb(ts, SIM_HW, k_max, evaluator=ev)
            warm_dev, _ = hill_climb(ts, SIM_HW, k_max, evaluator=ev, init_plan=cold)
        warm, _ = hill_climb(ts, SIM_HW, k_max, tables=et, batch=True, init_plan=cold)
        sb, _ = hill_climb(ts, SIM_HW, k_max, tables=et, batch=True, discipline=SWAP_BATCH)
        sb_dev, _ = hill_climb(ts, SIM_HW, k_max, evaluator=ev, discipline=SWAP_BATCH)
        if (cold_dev, warm_dev, sb_dev) != (cold, warm, sb):
            raise AssertionError(f"{name}: hill_climb on the card committed other plans")
        print(f"  {name}: hill_climb plans identical cold, warm and under swap_batch ({len(calls)} calls "
              f"in the cold + warm climbs)")
        # Per frontier call: the largest batch the climbs scored, a full
        # frontier of [4n, n] plans from the warm climb.
        (fp, fk), _ = max(calls, key=lambda call: len(call[0][0]))
        n_bytes = nbytes(ev.pstack, ev.pkstack, ev.rates, ev.svc_tab, ev.tl_tab) + 2 * fp.size * 8 + 2 * len(fp) * 4
        for disc, key in ((FCFS, "fcfs"), (SWAP_BATCH, "swap_batch")):
            _, host_ms = timed_host(lambda: latency.penalized_objective_batch(
                ts, fp, fk, SIM_HW, tables=et, discipline=disc), reps=5)
            before = ev.extensions
            _, wall_ms = timed_host(lambda: ev.penalized_objective_batch(fp, fk, discipline=disc))
            extended = ev.extensions > before
            # About 30 float32 operations per tenant per sweep: one sweep for
            # FCFS, 62 (+ 541 when extended) for swap_batch.
            sweeps = 1 if key == "fcfs" else 62 + 541 * extended
            rows[f"B4 {name} {key}"] = op_entry(
                "src/repro/core/jax_eval.py:186",
                lambda: ev.penalized_objective_batch(fp, fk, discipline=disc),
                n_bytes=n_bytes, n_ops=sweeps * fp.size * 30, host_ms=host_ms, iters=5,
                shape=list(fp.shape), call_wall_ms=wall_ms, extended=bool(extended),
            )
        obj = p_tail(0.99)
        _, host_ms = timed_host(lambda: latency.penalized_objective_batch(
            ts, fp, fk, SIM_HW, tables=et, objective=obj), reps=5)
        _, wall_ms = timed_host(lambda: ev.penalized_objective_batch(fp, fk, objective=obj), reps=5)
        rows[f"B5 {name} p_tail"] = op_entry(
            "src/repro/core/jax_eval.py:102", lambda: ev.penalized_objective_batch(fp, fk, objective=obj),
            n_bytes=n_bytes + nbytes(ev.ix_tab, ev.bnd_tab, ev.s1c_tab, ev.npoints), n_ops=fp.size * 60,
            host_ms=host_ms, iters=10, shape=list(fp.shape), call_wall_ms=wall_ms,
        )
        if name == "thrash16":
            device_breakdown("B4 thrash16 swap_batch, one frontier call",
                             lambda: ev.penalized_objective_batch(fp, fk, discipline=SWAP_BATCH))
        extensions += ev.extensions
    # A mix whose damped fixed point does not settle in 60 sweeps
    # (tests/test_torch_eval.py::test_swap_batch_extension): the masked
    # 540-sweep extension runs on the card.  Row 0 is inf in float32 (as in
    # the reference's JaxPlanEvaluator) where float64 settles; the others
    # agree with the NumPy batch.
    ts = [TenantSpec(paper_profile(n), r) for n, r in zip(
        ("mnasnet", "mobilenetv2", "efficientnet"), (33.952794612593195, 15.90244329367047, 14.879704988613526))]
    et = EvalTables.build(ts, SIM_HW, 4)
    p_max = np.array([t.profile.num_partition_points for t in ts])
    P = np.stack([p_max, p_max - 1, np.maximum(p_max - 2, 0)])
    K = np.stack([prop_alloc(ts, row, 4) for row in P])
    ev = TorchPlanEvaluator.from_tables(et, device=DEVICE)
    got = ev.objective_batch(P, K, discipline=SWAP_BATCH)
    want = latency.objective_batch(ts, P, K, SIM_HW, tables=et, discipline=SWAP_BATCH)
    if not (ev.extensions == 1 and np.isinf(got[0]) and np.allclose(got[1:], want[1:], rtol=EVAL_RTOL)):
        raise AssertionError(f"extension case: {got} on the card, NumPy {want}, extensions {ev.extensions}")
    print(f"  extension case: the 540-sweep extension ran; {got} against NumPy {want}")
    extensions += ev.extensions
    for key, row in rows.items():
        print(f"  {key} {row['shape']}: {row['ms']:.4f} ms a call on the card (CUDA events), {row['call_wall_ms']:.4f} ms "
              f"wall with copies; {row['kernels']} kernels + {row['copies']} copies; NumPy {row['host_numpy_ms']:.4f} ms; "
              f"bound {row['bound_ms']:.2e} ms ({row['bound_by']})")
    print(f"  calls that ran the 540-sweep extension: {extensions}")
    rows["extension_calls"] = extensions
    return rows


def phase_online() -> dict:
    """``run_adaptive`` on the Fig. 8 trace: the device stepper and a
    planner scoring each frontier on the card, against the defaults (host
    stepper, NumPy planner)."""
    profs = [paper_profile(n) for n in FIG8_MODELS]
    trace = dynamic_trace(FIG8_PHASES, seed=5)
    k_max = SIM_HW.cpu.n_cores

    def planner(tenants, platform, k, *, tables=None, init_plan=None):
        ev = TorchPlanEvaluator.build(tenants, platform, k, tables=tables, device=DEVICE)
        return hill_climb(tenants, platform, k, evaluator=ev, init_plan=init_plan)

    want, host_ms = timed_host(lambda: run_adaptive(profs, trace, SIM_HW, k_max, **FIG8_KW))
    got, card_ms = timed_host(lambda: run_adaptive(
        profs, trace, SIM_HW, k_max, backend="torch", device=DEVICE, planner=planner, **FIG8_KW))
    if got.replan_times != want.replan_times or got.plans != want.plans:
        raise AssertionError("run_adaptive on the card re-planned differently")
    worst = 0.0
    for m in range(len(profs)):
        a, b = want.sim.mean_latency(m), got.sim.mean_latency(m)
        worst = max(worst, abs(b - a) / a)
        if not math.isclose(b, a, rel_tol=STAT_REL):
            raise AssertionError(f"model {m}: mean {b} on the card vs {a}")
    out = {
        "replans": len(got.plans), "worst_mean_rel": worst,
        "card_max_planner_ms": max(got.plan_compute_seconds) * 1e3,
        "card_median_planner_ms": float(np.median(got.plan_compute_seconds)) * 1e3,
        "numpy_max_planner_ms": max(want.plan_compute_seconds) * 1e3,
        "numpy_median_planner_ms": float(np.median(want.plan_compute_seconds)) * 1e3,
        "card_run_ms": card_ms, "host_run_ms": host_ms,
    }
    print(f"  {len(got.plans)} re-plans, identical times and plans; worst per-model mean rel diff {worst:.3e}; "
          f"planner ms per re-plan, max / median: card evaluator {out['card_max_planner_ms']:.3f} / "
          f"{out['card_median_planner_ms']:.3f}, NumPy {out['numpy_max_planner_ms']:.3f} / "
          f"{out['numpy_median_planner_ms']:.3f}; whole run {card_ms:.1f} ms (torch backend) vs {host_ms:.1f} ms (stepper)")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    def phase(title, fn, *args):
        t0 = time.perf_counter()
        print(f"== {title}")
        result = fn(*args)
        print(f"== {title}: {time.perf_counter() - t0:.2f} s")
        return result

    kind = phase("device", phase_device)
    phase("build", phase_build)
    matmul_hgmma = phase("tensor cores: HGMMA in the block_matmul library", phase_tensor_cores, "block_matmul", "HGMMA")
    hgmma = phase("tensor cores: HGMMA in the flash_attention library", phase_tensor_cores, "flash_attention", "HGMMA")
    hmma = phase("tensor cores: HMMA in the wkv6 library", phase_tensor_cores, "wkv6", "HMMA")
    matmul_k, flash_k, wkv_k = KERNELS
    checks = {"block_matmul": phase("kernel vs plain: block_matmul", phase_kernel_vs_plain, matmul_k)}
    phase("kernel vs plain: flash_attention, test and ragged shapes", check_flash,
          FLASH_TEST_SHAPES + FLASH_RAGGED_SHAPES, (torch.float32, torch.bfloat16))
    phase("kernel vs plain: wkv6, test and ragged shapes", check_wkv6,
          WKV_TEST_SHAPES + WKV_RAGGED_SHAPES, (torch.float32, torch.bfloat16))
    phase("kernel vs plain: wkv6 at strong decays, ragged shapes", check_wkv6,
          WKV_RAGGED_SHAPES, (torch.float32, torch.bfloat16), "strong")
    plan, cnn_launches, path_routes = phase("main path: SwapLess serving of the CNN mix", phase_main_path)
    phase("where the time goes", phase_breakdown, plan)

    calls = Counter()
    launches = {"block_matmul": cnn_launches["block_matmul"]}
    for name in ZOO:
        launches.update(phase(f"model-zoo path: {name}", phase_zoo_path, name, calls))
    print("model-zoo kernel calls per prefill: " + "; ".join(
        f"{k} {key} {str(dt)[6:]} x{n}" for (k, key, dt), n in calls.items()
    ))
    for name, check in (("flash_attention", check_flash), ("wkv6", check_wkv6)):
        path_shapes = list(dict.fromkeys(key for (k, key, _), _n in calls.items() if k == name))
        path_dtypes = tuple(dict.fromkeys(dt for (k, _key, dt) in calls if k == name))
        checks[name] = {"max_abs_err": phase(
            f"kernel vs plain: {name} at the model-zoo path's shapes", check, path_shapes, path_dtypes
        )}
        phase(f"kernel vs plain: {name} at the path's shapes in float32", check, path_shapes, (torch.float32,))
        if name == "wkv6":
            phase("kernel vs plain: wkv6 at the path's shapes, strong decays", check_wkv6,
                  path_shapes, path_dtypes + (torch.float32,), "strong")
    for name in ZOO:
        phase(f"model-zoo correctness: {name} float32", phase_zoo_check, name)

    # wkv6's route at each (type, head_dim) it ran at on the path and in the
    # float32 full-forward check.
    wkv_routes = {
        f"{str(dt)[6:]} hd {key[3]}": wkv_route(dt, key[3])
        for (k, key, dt) in calls if k == "wkv6"
    } | {f"float32 hd {ARCHS['rwkv6-7b'].resolved_head_dim}": wkv_route(torch.float32, ARCHS['rwkv6-7b'].resolved_head_dim)}
    torch_ops = {"B1": phase("torch ops: lindley_ends on the card (B1)", phase_lindley)}
    torch_ops["backends"] = phase("torch ops: simulate(backend='torch') against the stepper", phase_backends)
    torch_ops.update(phase("torch ops: the replica engine (B2, B3)", phase_replicas))
    torch_ops.update(phase("torch ops: the plan evaluator (B4, B5)", phase_evaluator))
    torch_ops["online"] = phase("torch ops: online control on the Fig. 8 trace", phase_online)
    times = {"block_matmul": phase("times: block_matmul", phase_times, matmul_k)}
    times.update(phase("times: flash_attention and wkv6", phase_zoo_times, calls))

    line = []
    for k in KERNELS:
        name = k["name"]
        assert launches[name] > 0, f"{name} was not launched on its path"
        line.append({
            "name": name,
            "route": k["route"],
            "source": k["source"],
            "replaces": k["replaces"],
            "launches": launches[name],
            "max_abs_err": checks[name]["max_abs_err"],
            **times[name],
            **({"shapes_checked": checks[name]["shapes_checked"]} if "shapes_checked" in checks[name] else {}),
            **({"sass_hgmma": matmul_hgmma, "routes": {"main path": path_routes, "kernel vs plain": checks[name]["routes"]}}
               if name == "block_matmul" else {}),
            **({"sass_hgmma": hgmma} if name == "flash_attention" else {}),
            **({"sass_hmma": hmma, "routes": wkv_routes} if name == "wkv6" else {}),
        })
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.2f} s")
    print(json.dumps({"torch_ops": torch_ops}))
    print(json.dumps({"kernels": line}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
