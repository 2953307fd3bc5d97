#!/usr/bin/env python3
"""Where the wkv6 chunk kernel's time goes, phase by phase, on one GPU.

    python3 tools/wkv6_phases.py

Builds a copy of ``src/repro_torch/kernels/csrc/wkv6.cu`` whose chunk kernel
(``tc::chunk_kernel``) reads ``clock64()`` after each of its block barriers
and around its loads, for block 0 and two of its threads: thread 0 (warp 0,
a diagonal warp) and thread 256 (warp 8, a product warp).  It runs that copy
at rwkv6-7b's shape (B 2, T 2048, H 64, hd 64) as its prefill calls it (r,
k, v bfloat16, w float32) and as its training does (all four float32), and
prints for each the SM cycles per chunk step spent in each segment, beside
the device time per call of the kernel itself and of the copy (CUDA events
over calls replayed from a CUDA graph).  The copy is built
into ``build/repro_torch/`` and is not the kernel the port runs.  Exits
non-zero without a card.
"""
from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.wkv6 import wkv6  # noqa: E402

SHAPE = (2, 2048, 64, 64)
CALLS = 5
OBSERVERS = (0, 256)   # threads of block 0: a diagonal warp's and a product warp's
# The segments, in the order of their stamps in the chunk kernel's loop.
SEGMENTS = (
    "wait for chunk c's copies, and the state store before it",
    "phase 1 (running sums, R^ K^ R' K' v)",
    "F (warps 0-7); chunk c + 1's v copies issued (warps 8-15)",
    "phase 2 (A on warps 0-7; S' and (R^F)S on warps 8-15)",
    "barrier after phase 2",
    "phase 3: issue chunk c + 1's r, k, w copies (warps 0-7)",
    "phase 3: A v and the stores (warps 8-15)",
    "barrier after phase 3",
)


def instrumented_source() -> str:
    src = (build.CSRC_DIR / "wkv6.cu").read_text()
    head, body = src.split("namespace tc {", 1)
    start = body.index("chunk_kernel(")
    end = body.index("// Allows `kernel`")
    kernel = body[start:end].replace(
        "const int tid = static_cast<int>(threadIdx.x);",
        "const int tid = static_cast<int>(threadIdx.x);\n  long long clk_last = clock64();", 1)
    count = [0]

    def stamp(m):
        count[0] += 1
        text = m.group(0)
        if text.startswith("cp_async_commit"):
            return f"STAMP({count[0]}); " + text
        if m.end() < len(m.string) and m.string.startswith("\n\n    // Phase 3", m.end()):
            # the end of phase 2: one stamp before its barrier, one after
            count[0] += 1
            return f"STAMP({count[0] - 1}); " + text + f" STAMP({count[0]});"
        return text.replace(";", f"; STAMP({count[0]});", 1)

    kernel = re.sub(
        r"__syncthreads\(\);(?=\n\n    // Phase 3)|__syncthreads\(\);|if \(c \+ 1 < n_chunks\) issue_rkw\(c \+ 1\);"
        r"|cp_async_commit\(\);(?=   // chunk c)",
        stamp, kernel)
    if count[0] != len(SEGMENTS):
        raise RuntimeError(f"found {count[0]} stamp sites, expected {len(SEGMENTS)}: update SEGMENTS")
    observers = " || ".join(f"threadIdx.x == {t}" for t in OBSERVERS)
    return head + f"""
__device__ unsigned long long g_clk[{len(OBSERVERS)}][16];
#define STAMP(i) if (blockIdx.x == 0 && ({observers})) {{ \\
    const long long now = clock64(); \\
    g_clk[threadIdx.x == {OBSERVERS[0]} ? 0 : 1][i] += now - clk_last; clk_last = now; }}
namespace tc {{""" + body[:start] + kernel + body[end:] + """
extern "C" int wkv6_clocks(unsigned long long* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_clk, sizeof(g_clk)));
}
extern "C" int wkv6_clocks_reset() {
  static unsigned long long zero[sizeof(g_clk) / sizeof(unsigned long long)] = {};
  return static_cast<int>(cudaMemcpyToSymbol(g_clk, zero, sizeof(g_clk)));
}
"""


def graph_ms(fn, calls: int = 10, replays: int = 5) -> float:
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
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def main() -> int:
    if not torch.cuda.is_available():
        print("wkv6_phases: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip())
    cu = build.BUILD_DIR / "wkv6_phases.cu"
    so = build.BUILD_DIR / "wkv6_phases.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu.write_text(instrumented_source())
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC_DIR), "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode:
        print(proc.stdout + proc.stderr, file=sys.stderr)
        return 1
    lib = ctypes.CDLL(str(so))
    lib.wkv6.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.wkv6.restype = ctypes.c_int

    for rkv in (torch.bfloat16, torch.float32):
        phases(lib, rkv)
    return 0


def phases(lib, rkv: torch.dtype) -> None:
    """The cycles per chunk step of the instrumented copy, r, k, v in
    ``rkv`` and w float32, and the device time of it and of the kernel."""
    b, t, h, hd = SHAPE
    g = torch.Generator().manual_seed(0)
    r, k, v = (torch.randn(SHAPE, generator=g).to(rkv).cuda() for _ in range(3))
    w = torch.exp(-torch.exp(-2.0 + 0.5 * torch.randn(SHAPE, generator=g))).cuda()
    u = (0.1 * torch.randn((h, hd), generator=g)).cuda()
    state = torch.zeros((b, h, hd, hd), device="cuda")
    out = torch.empty(SHAPE, device="cuda")
    final = torch.empty((b, h, hd, hd), device="cuda")

    def copy():
        err = lib.wkv6(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(), state.data_ptr(),
                       out.data_ptr(), final.data_ptr(), b, t, h, hd, int(rkv == torch.bfloat16), 0,
                       torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"instrumented wkv6 launch failed with CUDA error {err}")

    copy()
    torch.cuda.synchronize()
    want, _ = wkv6(r, k, v, w, u, state)
    torch.testing.assert_close(out, want, rtol=1e-6, atol=1e-5)   # the copy computes what the kernel does
    lib.wkv6_clocks_reset()
    for _ in range(CALLS):
        copy()
    torch.cuda.synchronize()
    clocks = (ctypes.c_ulonglong * (16 * len(OBSERVERS)))()
    lib.wkv6_clocks(clocks)
    steps = CALLS * ((t + 63) // 64)
    print(f"wkv6 chunk kernel, (B,T,H,hd)={SHAPE} r,k,v {str(rkv)[6:]}: SM cycles per chunk step, block 0, "
          f"{CALLS} calls x {steps // CALLS} chunks")
    print(f"  {'segment':<58} {'thread 0':>9} {'thread 256':>11}")
    for i, label in enumerate(SEGMENTS, start=1):
        print(f"  {label:<58} {clocks[i] / steps:9.0f} {clocks[16 + i] / steps:11.0f}")
    print(f"  {'total':<58} {sum(clocks[:16]) / steps:9.0f} {sum(clocks[16:]) / steps:11.0f}")
    print(f"device ms per call from a CUDA graph: kernel {graph_ms(lambda: wkv6(r, k, v, w, u, state)):.6f}, "
          f"instrumented copy {graph_ms(copy):.6f}")


if __name__ == "__main__":
    sys.exit(main())
