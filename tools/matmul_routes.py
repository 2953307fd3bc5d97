#!/usr/bin/env python3
"""Probe the two routes of ``block_matmul`` on one NVIDIA GPU.

    python3 tools/matmul_routes.py [--baseline OLD.cu] [--check] [--path] [--sweep]

Builds ``src/repro_torch/kernels/csrc/block_matmul.cu`` as ``kernels/build.py``
does, and, for the comparisons below, two copies of it compiled with
``BLOCK_MATMUL_TC_MIN_MNK`` forced to 0 (every eligible bfloat16 call on the
tensor cores) and to the largest value (every call on the CUDA cores), plus
an older source of the same C interface given by ``--baseline`` (for
example the first version, ``git show 80c2a25:src/repro_torch/kernels/csrc/block_matmul.cu``).
Each build's ptxas report (registers, spills) is printed.

- ``--check``: the wrapper against ``matmul_plain`` at a small and a path
  shape (float32), then the tensor-core route on one 128 x 256 tile with
  B = I and A = I (which shows a wrong swizzle or descriptor as a permuted
  or zeroed output), then at ragged tensor-core shapes and 4096^3;
- ``--path``: CUDA-event times of the serving path's 18 float32 products and
  of 4096^3 bfloat16, eager (the wrapper's host path included) and from a
  CUDA graph, the baseline and this kernel in turns (baseline, new, new,
  baseline) beside ``torch.matmul`` and the bound;
- ``--sweep``: bfloat16 products at growing sizes on each route (the forced
  builds), from a CUDA graph: where the tensor-core route starts to win.

Prints the card's name and power limit first.  Exits non-zero without a
CUDA device or when a check fails.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.matmul import matmul, matmul_plain, route  # noqa: E402

PROBE_DIR = build.BUILD_DIR / "probe"
FORCE = {"tc": "0LL", "cc": "9223372036854775807LL"}   # BLOCK_MATMUL_TC_MIN_MNK
# (M, K, N), by M * N * K: 2^18 .. 2^21 in detail around the threshold.
SWEEP = [(64, 64, 64), (64, 64, 128), (128, 64, 64), (64, 128, 128), (128, 64, 128), (128, 128, 64),
         (96, 128, 128), (128, 128, 128), (256, 64, 128), (128, 256, 256), (256, 256, 256),
         (512, 256, 512), (512, 512, 512), (1024, 512, 1024), (1024, 1024, 1024), (2048, 1024, 2048),
         (2048, 2048, 2048)]


def compile_variant(name: str, src: Path, defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    PROBE_DIR.mkdir(parents=True, exist_ok=True)
    out = PROBE_DIR / f"{name}.so"
    cmd = [build._nvcc(), *build.NVCC_FLAGS, *defines, "-o", str(out), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src} ({name}):\n{proc.stdout}{proc.stderr}")
    report = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
              if "registers" in ln or "spill" in ln or "entry function" in ln]
    print(f"built {name} from {src.name}:\n    " + "\n    ".join(report))
    fn = ctypes.CDLL(str(out)).block_matmul
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def raw_call(fn):
    """(x, y) -> x @ y through a build's C entry, with the first version's
    host path (a device context and a stream lookup on every call)."""
    def call(x, y):
        out = torch.empty((x.shape[0], y.shape[1]), dtype=x.dtype, device=x.device)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = fn(x.data_ptr(), y.data_ptr(), out.data_ptr(), x.shape[0], y.shape[1], x.shape[1],
                     int(x.dtype == torch.bfloat16), int(x.dtype == torch.bfloat16), stream)
        if err:
            raise RuntimeError(f"launch failed with CUDA error {err}")
        return out
    return call


def agree(label, got, want, tol) -> float:
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    ok = torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)
    print(f"  {label}: max_abs_err={err:.3e} tol={tol} {'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"{label} disagrees")
    return err


def check() -> None:
    print("check: cuda-core route, float32")
    for shape in [(37, 200, 13), (1, 256, 256), (1024, 16, 16), (64, 64, 64)]:
        x, y = smoke.operands(shape, torch.float32, seed=0)
        agree(f"float32 {shape} {route(x.dtype, shape[0], shape[2], shape[1])}", matmul(x, y), matmul_plain(x, y), 1e-3)
    print("check: tensor-core route on one 128 x 256 tile")
    dev = smoke.DEVICE
    assert route(torch.bfloat16, 128, 256, 256) == route(torch.bfloat16, 128, 256, 128) == "tensor-core"
    x = torch.randn(128, 256, device=dev).bfloat16()
    eye = torch.eye(256, device=dev, dtype=torch.bfloat16)
    agree("A @ I (B = I)", matmul(x, eye), x, 0.0)
    y = torch.randn(128, 256, device=dev).bfloat16()
    agree("I @ B (A = I)", matmul(torch.eye(128, device=dev, dtype=torch.bfloat16), y), y, 0.0)
    for shape in [(128, 256, 256), (200, 64, 264), (1000, 1032, 520), (128, 128, 128), (4096, 4096, 4096)]:
        x, y = smoke.operands(shape, torch.bfloat16, seed=1)
        r = route(x.dtype, shape[0], shape[2], shape[1])
        for out_dtype in (torch.bfloat16, torch.float32):
            agree(f"bfloat16 {shape} -> {str(out_dtype)[6:]} {r}", matmul(x, y, out_dtype),
                  matmul_plain(x, y, out_dtype), 2e-2)


def time_pair(label, shape, dtype, base, new, lib, iters):
    """Eager and graph times of baseline and new in turns, and of lib."""
    x, y = smoke.operands(shape, dtype, seed=0)
    graph_calls = 5 if iters < 100 else 20
    t = {"base": [], "new": [], "base_g": [], "new_g": []}
    for who in ("base", "new", "new", "base"):
        fn = base if who == "base" else new
        t[who].append(smoke.time_ms(lambda: fn(x, y), iters))
        t[who + "_g"].append(smoke.time_graph_ms(lambda: fn(x, y), calls=graph_calls))
    row = {k: sum(v) / len(v) for k, v in t.items()}
    row["lib"] = smoke.time_ms(lambda: lib(x, y), iters)
    row["lib_g"] = smoke.time_graph_ms(lambda: lib(x, y), calls=graph_calls)
    row["bound"], by = smoke.bound(shape, dtype)
    print(f"  {label} {str(dtype)[6:]} M={shape[0]} K={shape[1]} N={shape[2]}: "
          f"eager base={row['base']:.6f} new={row['new']:.6f} torch.matmul={row['lib']:.6f}; "
          f"graph base={row['base_g']:.6f} new={row['new_g']:.6f} torch.matmul={row['lib_g']:.6f}; "
          f"bound={row['bound']:.6f} ({by}) graph share={row['bound'] / row['new_g']:.4%}")
    return row


def path_times(base) -> None:
    print("times (ms per call, CUDA events): baseline and new in turns (base, new, new, base)")
    rows = []
    shapes = smoke.main_path_shapes()
    cache = {}
    for s in shapes:
        if s not in cache:
            cache[s] = time_pair("path", s, torch.float32, base, matmul, torch.matmul, 200)
        rows.append(cache[s])
    sums = {k: sum(r[k] for r in rows) for k in rows[0]}
    print(f"  sum over the {len(rows)} path products: "
          + " ".join(f"{k}={v:.6f}" for k, v in sums.items()))
    time_pair("large", smoke.LARGE_SHAPE, torch.bfloat16, base, matmul, torch.matmul, 20)


def sweep(tc, cc) -> None:
    print("sweep: bfloat16, graph ms per call, each route forced")
    for shape in SWEEP:
        x, y = smoke.operands(shape, torch.bfloat16, seed=0)
        agree(f"tc {shape}", tc(x, y), matmul_plain(x, y), 2e-2)
        t_cc = smoke.time_graph_ms(lambda: cc(x, y))
        t_tc = smoke.time_graph_ms(lambda: tc(x, y))
        t_lib = smoke.time_graph_ms(lambda: torch.matmul(x, y))
        m, k, n = shape
        print(f"  M*N*K={m * n * k} {shape}: cuda-core={t_cc:.6f} tensor-core={t_tc:.6f} "
              f"torch.matmul={t_lib:.6f} -> {'tensor-core' if t_tc < t_cc else 'cuda-core'}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, help="an older block_matmul source to time beside this one")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--path", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("matmul_routes: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smoke.phase_device()
    t0 = time.perf_counter()
    if args.path and not args.baseline:
        ap.error("--path compares with --baseline")
    src = build.CSRC_DIR / "block_matmul.cu"
    jobs = {}
    if args.baseline:
        jobs["baseline"] = (args.baseline.resolve(), ())
    if args.sweep:
        jobs |= {f"force_{r}": (src, (f"-DBLOCK_MATMUL_TC_MIN_MNK={v}",)) for r, v in FORCE.items()}
    with ThreadPoolExecutor(len(jobs) + 1) as ex:
        lib = ex.submit(build.build, "block_matmul")
        built = {name: ex.submit(compile_variant, name, *job) for name, job in jobs.items()}
        path = lib.result()
        fns = {name: f.result() for name, f in built.items()}
    report = [ln.strip() for ln in path.with_name(path.name + ".log").read_text().splitlines()
              if "registers" in ln or "spill" in ln or "entry function" in ln]
    print(f"built {path.relative_to(ROOT)}:\n    " + "\n    ".join(report))
    print(f"builds: {time.perf_counter() - t0:.2f} s")
    if args.check:
        check()
    if args.path:
        path_times(raw_call(fns["baseline"]))
    if args.sweep:
        sweep(raw_call(fns["force_tc"]), raw_call(fns["force_cc"]))
    print("matmul_routes: done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
