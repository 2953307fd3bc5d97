#!/usr/bin/env python3
"""Variants of flash_attention's backward kernels on the card: what each
part of the design costs and buys.

    python3 tools/flash_bwd_variants.py [--variants as-is,one-mma,...]

Each variant is a copy of ``src/repro_torch/kernels/csrc/flash_attention_bwd.cu``
(and ``tf32.cuh``) with a few text edits, built with the package's own nvcc
flags into ``build/flash_bwd_variants/``.  At the train paths' float32
shapes every variant is timed in turns, from a CUDA graph (whole call) and
under ``torch.profiler`` (each kernel), and its gradient is held against
``causal_attention_bwd_plain`` in float32 and in float64 (row errors as
``chip_smoke.py`` reckons them).  Variants marked "timing only" compute
wrong gradients on purpose: they take a part out to show what it costs.

- ``as-is``: the kernels as they stand;
- ``one-mma`` (timing only): each split product keeps its hi*hi mma and
  drops the two correction mmas, so the HMMAs fall to a third;
- ``no-split`` (timing only): operands go to the tensor cores unsplit (the
  split's ALU work gone, the mmas kept);
- ``tf32-dq-dp``: dQ's do v^T in split TF32 instead of on the FP64 tensor
  cores;
- ``no-fast-path``: every tile pair takes the per-element mask;
- ``chain-2``: tensor-core accumulators flushed every 2 k8 steps instead
  of CHAIN.

Ends with a JSON line of every reading.  Needs one card; exits non-zero
without one.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

fa, build = cs.fa_mod, cs.build
OUT = ROOT / "build" / "flash_bwd_variants"
SPLIT = """  hi = __float_as_uint(x) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi));"""
CORRECTIONS = """  if constexpr (!AX) tf32::mma(e, al, bh0, bh1);
  if constexpr (!BX) tf32::mma(e, ah, bl0, bl1);"""
DQ_DP = "rows_by_rows_f64<T, HD, NTA>(dp, dos, vs, m0, n0a, lane);"
# name: (edits of the .cu, edits of tf32.cuh, timing only)
VARIANTS = {
    "as-is": ([], [], False),
    "one-mma": ([(CORRECTIONS, "")], [], True),
    "no-split": ([], [(SPLIT, "  hi = __float_as_uint(x);\n  lo = hi;")], True),
    "tf32-dq-dp": ([(DQ_DP, "rows_by_rows<T, HD, NTA, false>(dp, dp, dos, vs, dos, vs, m0, n0a, lane);")], [], False),
    "no-fast-path": ([("if (all_visible(", "if (false && all_visible(")], [], False),
    "chain-2": ([("constexpr int CHAIN = 4;", "constexpr int CHAIN = 2;")], [], False),
}


def edited(text: str, edits) -> str:
    for old, new in edits:
        if old not in text:
            raise ValueError(f"edit does not apply: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def build_variant(name: str) -> Path:
    src_edits, hdr_edits, _ = VARIANTS[name]
    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    (d / "flash_attention_bwd.cu").write_text(edited((build.CSRC_DIR / "flash_attention_bwd.cu").read_text(), src_edits))
    (d / "tf32.cuh").write_text(edited((build.CSRC_DIR / "tf32.cuh").read_text(), hdr_edits))
    so = d / "flash_attention_bwd.so"
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(d / "flash_attention_bwd.cu")],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on variant {name}:\n{proc.stdout}{proc.stderr}")
    return so


def kernel_ms(call) -> dict[str, float]:
    """Device ms per call of each backward kernel, over 3 calls."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            call()
        torch.cuda.synchronize()
    per = Counter()
    for e in prof.key_averages():
        for name in cs.BWD_KERNEL_NAMES:
            if name in e.key:
                per[name] += e.device_time_total / 3e3
    return dict(per)


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_bwd_variants: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    names = ap.parse_args().variants.split(",")
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.phase_device()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names) + 1) as ex:
        fwd = ex.submit(build.build, "flash_attention")
        libs = dict(zip(names, ex.map(build_variant, names)))
        fwd.result()
    print(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s")
    fns = {}
    for name, so in libs.items():
        fn = ctypes.CDLL(str(so)).flash_attention_bwd
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int] + [
            ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    readings = []
    for i, shape in enumerate(cs.TRAIN_BWD_SHAPES):
        q, k, v = cs.flash_operands(shape, torch.float32, seed=i)
        do = torch.randn(q.shape, generator=torch.Generator().manual_seed(100 + i)).to(cs.DEVICE)
        scale, window = shape[4] ** -0.5, shape[5]
        o = cs.causal_attention(q, k, v, scale=scale, window=window)
        want = cs.causal_attention_bwd_plain(q, k, v, o, do, scale=scale, window=window)
        exact = cs.causal_attention_bwd_plain(*(a.double() for a in (q, k, v, o, do)), scale=scale, window=window)
        floor, floor64 = cs.grad_row_floor(want), cs.grad_row_floor(exact)

        def call():
            return cs.causal_attention_bwd(q, k, v, o, do, scale=scale, window=window)

        graph = {n: [] for n in fns}
        for rnd in range(2):   # in turns, the order reversed in the second round
            for name in (names if rnd == 0 else names[::-1]):
                fa._bwd_kernel = lambda fn=fns[name]: fn
                graph[name].append(cs.time_graph_ms(call, calls=5, replays=3))
        print(f"(B,S,H,KV,hd,window)={shape}, float32:")
        for name in names:
            fa._bwd_kernel = lambda fn=fns[name]: fn
            got = call()
            torch.cuda.synchronize()
            r = {
                "shape": list(shape), "variant": name, "timing_only": VARIANTS[name][2],
                "graph_ms": graph[name], "kernel_ms": kernel_ms(call),
                "row_err_vs_plain": [cs.grad_row_err(a, b, floor) for a, b in zip(got, want)],
                "row_err_vs_float64": [cs.grad_row_err(a, b, floor64) for a, b in zip(got, exact)],
            }
            readings.append(r)
            print(f"  {name:13s} graph {r['graph_ms'][0]:.4f} / {r['graph_ms'][1]:.4f} ms; "
                  + ", ".join(f"{n} {t:.4f}" for n, t in r["kernel_ms"].items())
                  + "; dq, dk, dv row err vs plain " + " ".join(f"{e:.2e}" for e in r["row_err_vs_plain"])
                  + ", vs float64 " + " ".join(f"{e:.2e}" for e in r["row_err_vs_float64"])
                  + (" (timing only)" if r["timing_only"] else ""))
        plain64 = [cs.grad_row_err(a, b, floor64) for a, b in zip(want, exact)]
        print("  float32 plain vs float64: " + " ".join(f"{e:.2e}" for e in plain64))
        readings.append({"shape": list(shape), "variant": "plain float32", "row_err_vs_float64": plain64})
        del q, k, v, o, do, want, exact, got
    print(json.dumps({"flash_bwd_variants": readings, "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
