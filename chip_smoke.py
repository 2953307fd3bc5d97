#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line):

1. device: the card's name and power limit, as ``nvidia-smi`` reports them;
2. build: every CUDA source of the serving path, compiled in parallel from
   the checkout (``src/repro_torch/kernels/csrc``) into ``build/repro_torch``;
3. kernel vs plain: each kernel's wrapper on the card at the serving path's
   shapes (and the reference's test shapes, and ragged ones), held against
   its plain PyTorch version;
4. main path: ``repro_torch.launch.serve`` serving inceptionv4 + mnasnet
   through the GPU-prefix / host-suffix engine, under the SwapLess plan and
   under a forced split, with every output held against a host-only forward
   of the same weights and each kernel's launches counted;
5. where the time goes: warm requests one at a time (closed loop) under
   the SwapLess plan, and each stage's time on the card and on one host
   core;
6. times: CUDA-event times of each kernel, its plain version and the one
   PyTorch call that computes the same function, beside the card's bound,
   launched eagerly and replayed from a CUDA graph (device time alone).

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Exits non-zero without a
result when no CUDA device is present.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.core.planner import Plan  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.matmul import matmul, matmul_plain  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
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

# Every kernel of the serving path: its wrapper (which counts launches),
# plain version, source, and the TPU kernel of the JAX package it replaces.
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
]

# (M, K, N): tests/test_kernels.py::TestMatmul's aligned shapes, and ragged ones.
TEST_SHAPES = [(128, 128, 128), (256, 128, 64), (64, 256, 128), (512, 64, 256)]
RAGGED_SHAPES = [(1, 1, 1), (37, 200, 13), (129, 65, 31), (1000, 3, 70)]
TOL = {torch.float32: 1e-3, torch.bfloat16: 2e-2}   # TestMatmul's tolerances
LARGE_SHAPE = (4096, 4096, 4096)                     # timed in bfloat16 only


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
    print(f"torch device: {kind} (count {torch.cuda.device_count()})")
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
            if "registers" in line or "spill" in line:
                print(f"    {line.strip()}")


def phase_kernel_vs_plain(kernel: dict) -> dict:
    """Hold the kernel against its plain version; returns what the kernels
    line reports: the largest error on the main path's (float32) shapes and
    every shape checked."""
    fn, plain = kernel["wrapper"], kernel["plain"]
    main = main_path_shapes()
    checked, main_err = [], 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for i, shape in enumerate(dict.fromkeys(main + TEST_SHAPES + RAGGED_SHAPES)):
            x, y = operands(shape, dtype, seed=i)
            got = fn(x, y)
            torch.cuda.synchronize()
            want = plain(x, y)
            err = float((got.float() - want.float()).abs().max())
            tol = TOL[dtype]
            ok = torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)
            print(f"  {kernel['name']} {str(dtype)[6:]} {shape}: max_abs_err={err:.3e} tol={tol} {'ok' if ok else 'MISMATCH'}")
            if not ok:
                raise AssertionError(f"{kernel['name']} disagrees with its plain version at {shape} {dtype}")
            if dtype == torch.float32 and shape in main:
                main_err = max(main_err, err)
            checked.append([*shape, str(dtype)[6:]])
    return {"max_abs_err": main_err, "shapes_checked": checked}


def phase_main_path() -> tuple[Plan, dict[str, int]]:
    """Serve the mix on the card; returns the SwapLess plan and each
    kernel's launches on the path."""
    for k in KERNELS:
        k["wrapper"].launches = 0
    t0 = time.perf_counter()
    plan, done = serve.main([
        "--models", ",".join(MODELS), "--rates", RATES,
        "--requests", str(REQUESTS), "--k-max", str(K_MAX), "--device", DEVICE.type,
    ])
    models = [build_executable(PAPER_CNN_SPECS[n], seed=i, device=DEVICE) for i, n in enumerate(MODELS)]
    print(f"forced split {FORCED_PLAN.partition} cores {FORCED_PLAN.cores}:")
    done_forced = serve.run_requests(models, FORCED_PLAN, K_MAX, REQUESTS, DEVICE)
    serve.report_latencies(MODELS, done_forced)
    launches = {k["name"]: k["wrapper"].launches for k in KERNELS}
    print(f"main path: {time.perf_counter() - t0:.2f} s, launches {launches}")

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

    # One pointwise product per prefix stage, each on the card.
    expected = REQUESTS * (sum(plan.partition) + sum(FORCED_PLAN.partition))
    assert launches["block_matmul"] == expected, (launches, expected)
    for name, n in launches.items():
        assert n > 0, f"{name} was not launched on the main path"
    return plan, launches


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
            f"  {str(dtype)[6:]} M={shape[0]} K={shape[1]} N={shape[2]}: "
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    kind = phase_device()
    phase_build()
    print("kernel vs plain version on the card:")
    checks = {k["name"]: phase_kernel_vs_plain(k) for k in KERNELS}
    plan, launches = phase_main_path()
    phase_breakdown(plan)
    times = {k["name"]: phase_times(k) for k in KERNELS}

    line = []
    for k in KERNELS:
        name = k["name"]
        line.append({
            "name": name,
            "route": k["route"],
            "source": k["source"],
            "replaces": k["replaces"],
            "launches": launches[name],
            "max_abs_err": checks[name]["max_abs_err"],
            **times[name],
            "shapes_checked": checks[name]["shapes_checked"],
        })
    print(json.dumps({"kernels": line}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
