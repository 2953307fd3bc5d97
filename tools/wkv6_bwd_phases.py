#!/usr/bin/env python3
"""Where the wkv6 backward's time goes, kernel by kernel and phase by phase, on one GPU.

    python3 tools/wkv6_bwd_phases.py

Builds a copy of ``src/repro_torch/kernels/csrc/wkv6_bwd.cu`` whose
``grads_kernel`` reads ``clock64()`` after each of its block barriers and
at its end, on thread 0 of every block, and adds the cycles of each segment
over the blocks.  It runs that copy at rwkv6-7b's train shape (B 2, T 2048,
H 64, hd 64, float32) and prints the SM cycles per block spent in each
segment, then the device time per call of each of the three kernels
(``torch.profiler`` over ten calls) and of the whole call and the copy
(CUDA events over calls replayed from a CUDA graph).  The copy is built
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
from repro_torch.kernels import wkv6 as wkv6_mod  # noqa: E402
from repro_torch.kernels.wkv6 import wkv6_bwd  # noqa: E402

SHAPE = (2, 2048, 64, 64)
CALLS = 5
# grads_kernel's segments, in the order of their stamps: one after each
# block barrier, one at the end.
SEGMENTS = (
    "phase 0: the chunk's rows land (cp.async)",
    "w = 1 past T",
    "phase 1: pf, pb, sub-block totals",
    "F",
    "phase 2: dA and A (tensor cores), A inside sub-blocks",
    "phase 3: dv, D, E and dw's column sums (tensor cores)",
    "D and E into shared memory",
    "phase 4: dr, dk, dw's terms through S^a, G^a | dw's pairs",
    "phase 4: dw out",
    "du's partials",
)


def instrumented_source() -> str:
    src = (build.CSRC_DIR / "wkv6_bwd.cu").read_text()
    start = src.index("grads_kernel(const TR*")
    end = src.index("\n}\n", start) + 1
    kernel = src[start:end].replace(
        "const int tid = static_cast<int>(threadIdx.x);",
        "const int tid = static_cast<int>(threadIdx.x);\n  long long clk_last = clock64();", 1)
    count = [0]

    def stamp(m):
        count[0] += 1
        return m.group(0) + f" STAMP({count[0]});"

    kernel = re.sub(r"__syncthreads\(\);", stamp, kernel)
    count[0] += 1
    kernel += f"  STAMP({count[0]});\n"
    if count[0] != len(SEGMENTS):
        raise RuntimeError(f"found {count[0]} stamp sites, expected {len(SEGMENTS)}: update SEGMENTS")
    head = src[:start]
    anchor = head.rindex("template <typename TR, typename TW, int HD>")
    return head[:anchor] + f"""__device__ unsigned long long g_clk[16];
#define STAMP(i) if (threadIdx.x == 0) {{ \\
    const long long now = clock64(); \\
    atomicAdd(&g_clk[i], static_cast<unsigned long long>(now - clk_last)); clk_last = now; }}
""" + head[anchor:] + kernel + src[end:] + """
extern "C" int wkv6_bwd_clocks(unsigned long long* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_clk, sizeof(g_clk)));
}
extern "C" int wkv6_bwd_clocks_reset() {
  static unsigned long long zero[16] = {};
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


def kernel_ms(fn, calls: int = 10) -> dict[str, float]:
    """Device ms per call of each kernel that ``fn`` launches (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            m = re.search(r"(\w+_kernel)", e.key)
            out[m.group(1) if m else e.key[:40]] = e.self_device_time_total / 1e3 / calls
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("wkv6_bwd_phases: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip())
    cu = build.BUILD_DIR / "wkv6_bwd_phases.cu"
    so = build.BUILD_DIR / "wkv6_bwd_phases.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu.write_text(instrumented_source())
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC_DIR), "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode:
        print(proc.stdout + proc.stderr, file=sys.stderr)
        return 1
    lib = ctypes.CDLL(str(so))
    lib.wkv6_bwd.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.wkv6_bwd.restype = ctypes.c_int

    b, t, h, hd = SHAPE
    g = torch.Generator().manual_seed(0)
    r, k, v, dout = (torch.randn(SHAPE, generator=g).cuda() for _ in range(4))
    w = torch.exp(-torch.exp(-2.0 + 0.5 * torch.randn(SHAPE, generator=g))).cuda()
    u = (0.1 * torch.randn((h, hd), generator=g)).cuda()
    nc = -(-t // wkv6_mod.BWD_CHUNK)
    outs = [torch.empty(SHAPE, device="cuda") for _ in range(4)]
    du_part = torch.empty((b, h, nc, hd), device="cuda")
    dstate = torch.empty((b, h, hd, hd), device="cuda")
    ckpt = torch.empty(b * h * nc * hd * (2 * hd + 1), device="cuda")

    def copy():
        err = lib.wkv6_bwd(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(), None,
                           dout.data_ptr(), None, *(o.data_ptr() for o in outs), du_part.data_ptr(),
                           dstate.data_ptr(), ckpt.data_ptr(), b, t, h, hd, 0, 0,
                           torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"instrumented wkv6_bwd launch failed with CUDA error {err}")

    copy()
    torch.cuda.synchronize()
    want = wkv6_bwd(r, k, v, w, u, None, dout)
    for got, ref in zip(outs, want[:4]):   # the copy computes what the kernels do
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
    lib.wkv6_bwd_clocks_reset()
    for _ in range(CALLS):
        copy()
    torch.cuda.synchronize()
    clocks = (ctypes.c_ulonglong * 16)()
    lib.wkv6_bwd_clocks(clocks)
    blocks = CALLS * b * h * nc
    print(f"wkv6_bwd grads_kernel, (B,T,H,hd)={SHAPE} float32: SM cycles per block (thread 0), "
          f"summed over {CALLS} calls x {blocks // CALLS} blocks")
    for i, label in enumerate(SEGMENTS, start=1):
        print(f"  {label:<58} {clocks[i] / blocks:9.0f}")
    print(f"  {'total':<58} {sum(clocks) / blocks:9.0f}")
    call = lambda: wkv6_bwd(r, k, v, w, u, None, dout)  # noqa: E731
    per = kernel_ms(call)
    print("device ms per call by kernel (torch.profiler): " + ", ".join(f"{n} {t_:.6f}" for n, t_ in per.items()))
    print(f"device ms per call from a CUDA graph: wkv6_bwd {graph_ms(call):.6f}, instrumented copy {graph_ms(copy):.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
