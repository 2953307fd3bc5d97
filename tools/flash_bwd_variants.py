#!/usr/bin/env python3
"""Variants of flash_attention's backward kernels on the card: what each
part of the design costs and buys.

    python3 tools/flash_bwd_variants.py [--variants as-is,one-mma,...] [--baseline FILE]
    git show REV:src/repro_torch/kernels/csrc/flash_attention_bwd.cu > build/flash_bwd_parent.cu

Each variant is a copy of ``src/repro_torch/kernels/csrc/flash_attention_bwd.cu``
(with its headers) with a few text edits, built with the package's own nvcc
flags into ``build/flash_bwd_variants/``.  Every variant is timed in turns
(order reversed in the second round) from a CUDA graph (whole call) and
under ``torch.profiler`` (each of the four kernels), and its gradient is
held against ``causal_attention_bwd_plain`` and against it in float64 (row
errors as ``chip_smoke.py`` reckons them).  Variants marked "timing only"
compute wrong gradients on purpose: they take a part out to show what it
costs.

Two groups, each at its own shapes:

- the split-TF32 route at the float32 train shapes (``TRAIN_BWD_SHAPES``):
  ``as-is``; ``one-mma`` (timing only: each split product keeps its hi*hi
  mma); ``no-split`` (timing only: operands unsplit); ``tf32-dq-dp``
  (dQ's do v^T in split TF32, not on the FP64 tensor cores);
  ``no-fast-path`` (every tile pair takes the per-element mask);
  ``chain-2`` (accumulators flushed every 2 k8 steps);
- the wgmma route at the bf16 production shapes (``PROD_FLASH_SHAPES``):
  ``as-is``; ``tc-reduce-one-block`` (the reduction with one block per cut tile, as
  the split-TF32 route launches it);
  ``tc-no-delta`` (timing only: the stats kernel skips delta = do . o);
  and, with ``--baseline FILE``, ``baseline``: another version of the
  source (e.g. the parent's, from ``git show``), called with the work list
  at the split-TF32 route's tile rows, which that version's bf16 route
  takes.

Each wgmma reading also prints the bytes each kernel stages into shared
memory per call (q, do, k, v tiles and statistics, computed from the shape
and the work list; the reduction's partial sums read and dk, dv written)
and that over the kernel's time.  Ends with a JSON line of every reading.
Needs one card; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
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
REDUCE_SPAN = "constexpr int REDUCE_SPAN = 2 * TILE_ROWS * HD / (8 * THREADS);"
DELTA_LOOP = "for (int r = warp; r < TILE_ROWS; r += WG / 32) {"
# name: (edits of the .cu, edits of tf32.cuh, timing only)
VARIANTS = {
    "as-is": ([], [], False),
    "one-mma": ([(CORRECTIONS, "")], [], True),
    "no-split": ([], [(SPLIT, "  hi = __float_as_uint(x);\n  lo = hi;")], True),
    "tf32-dq-dp": ([(DQ_DP, "rows_by_rows<T, HD, NTA, false>(dp, dp, dos, vs, dos, vs, m0, n0a, lane);")], [], False),
    "no-fast-path": ([("if (all_visible(", "if (false && all_visible(")], [], False),
    "chain-2": ([("constexpr int CHAIN = 4;", "constexpr int CHAIN = 2;")], [], False),
}
TC_VARIANTS = {
    "as-is": ([], [], False),
    "tc-reduce-one-block": ([(REDUCE_SPAN, "constexpr int REDUCE_SPAN = 1;")], [], False),
    "tc-no-delta": ([(DELTA_LOOP, "for (int r = warp; r < 0; r += WG / 32) {")], [], True),
}
KERNEL = re.compile(r"\b(stats_kernel|dkdv_kernel|dkdv_reduce_kernel|dq_kernel)\b")


def edited(text: str, edits) -> str:
    for old, new in edits:
        if old not in text:
            raise ValueError(f"edit does not apply: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def build_variant(name: str, source: str, src_edits, hdr_edits) -> Path:
    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    for header in build.CSRC_DIR.glob("*.cuh"):
        shutil.copy(header, d / header.name)
    (d / "flash_attention_bwd.cu").write_text(edited(source, src_edits))
    (d / "tf32.cuh").write_text(edited((build.CSRC_DIR / "tf32.cuh").read_text(), hdr_edits))
    so = d / "flash_attention_bwd.so"
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(d / "flash_attention_bwd.cu")],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on variant {name}:\n{proc.stdout}{proc.stderr}")
    return so


def entry(so: Path):
    fn = ctypes.CDLL(str(so)).flash_attention_bwd
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int] + [
        ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launcher(fn, rows: int):
    """``causal_attention_bwd``'s CUDA path with entry ``fn`` and the work
    list at tiles of ``rows``."""
    def call(q, k, v, o, do, scale, window):
        b, s, h, hd = q.shape
        kv = k.shape[2]
        _, slots = fa._dkdv_items(b, s, h, kv, rows, window)
        items, splits = fa._dkdv_plan(b, s, h, kv, rows, window, q.device)
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        stats = torch.empty((2, b, h, s), dtype=torch.float32, device=q.device)
        partial = torch.empty((max(slots, 1), 2, rows, hd), dtype=torch.float32, device=q.device)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), dq.data_ptr(),
                 dk.data_ptr(), dv.data_ptr(), stats[0].data_ptr(), stats[1].data_ptr(), partial.data_ptr(),
                 items.data_ptr(), len(items), splits.data_ptr(), len(splits), b, s, h, kv, hd, scale, window,
                 int(q.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"flash_attention_bwd launch failed with CUDA error {err}")
        return dq, dk, dv
    return call


def kernel_ms(call) -> dict[str, float]:
    """Device ms per call of each backward kernel, over 3 calls."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):   # a profile with no device events is retried once
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                call()
            torch.cuda.synchronize()
        per = Counter()
        for e in prof.key_averages():
            m = KERNEL.search(e.key)
            if m:
                per[m.group(1)] += e.device_time_total / 3e3
        if per:
            return dict(per)
    return {}


def staged_bytes(shape) -> dict[str, int]:
    """Bytes each wgmma-route kernel copies into shared memory per call (the
    reduction: partial sums read, dk and dv written), from the shape, the
    tiles (64 query rows a block in the stats and dQ kernels) and the work
    list at 64 rows."""
    b, s, h, kv, hd, window = shape
    row = hd * 2
    bm, dq_bk = 64, 32 if hd == 256 else 64

    def key_tiles(q0, bk):
        end = min(q0 + bm, s)
        begin = (max(0, q0 - window + 1) // bk) * bk if window > 0 else 0
        return -(-(end - begin) // bk)

    blocks = [q0 for q0 in range(0, s, bm)]
    stats = b * h * sum(bm * row + key_tiles(q0, 64) * 64 * row for q0 in blocks)
    dq = b * h * sum(2 * bm * row + key_tiles(q0, dq_bk) * 2 * dq_bk * row for q0 in blocks)
    items = fa.dkdv_work(b, s, h, kv, 64, window)
    steps = int(((items[:, 3] - items[:, 2]) * (items[:, 5] - items[:, 4])).sum())
    dkdv = len(items) * 2 * 64 * row + steps * (2 * 64 * row + 2 * 64 * 4)
    cut = items[items[:, 6] >= 0]
    reduce = len(cut) * 2 * 64 * hd * 4 + len(fa.dkdv_splits(items)) * 2 * 64 * row
    return {"stats_kernel": stats, "dkdv_kernel": dkdv, "dkdv_reduce_kernel": reduce, "dq_kernel": dq}


def run_group(label, shapes, dtype, calls, timing_only, tc: bool) -> list[dict]:
    readings = []
    for i, shape in enumerate(shapes):
        q, k, v = cs.flash_operands(shape, dtype, seed=i)
        do = torch.randn(q.shape, generator=torch.Generator().manual_seed(100 + i)).to(dtype).to(cs.DEVICE)
        scale, window = shape[4] ** -0.5, shape[5]
        o = cs.causal_attention(q, k, v, scale=scale, window=window)
        want = cs.causal_attention_bwd_plain(q, k, v, o, do, scale=scale, window=window)
        exact = cs.causal_attention_bwd_plain(*(a.double() for a in (q, k, v, o, do)), scale=scale, window=window)
        floor, floor64 = cs.grad_row_floor(want), cs.grad_row_floor(exact)
        names = list(calls)
        graph = {n: [] for n in names}
        for rnd in range(2):   # in turns, the order reversed in the second round
            for name in (names if rnd == 0 else names[::-1]):
                fn = calls[name]
                graph[name].append(cs.time_graph_ms(lambda: fn(q, k, v, o, do, scale, window), calls=5, replays=3))
        print(f"{label} (B,S,H,KV,hd,window)={shape}, {str(dtype)[6:]}:")
        for name in names:
            fn = calls[name]
            got = fn(q, k, v, o, do, scale, window)
            torch.cuda.synchronize()
            r = {
                "shape": list(shape), "dtype": str(dtype)[6:], "variant": name, "timing_only": timing_only[name],
                "graph_ms": graph[name], "kernel_ms": kernel_ms(lambda: fn(q, k, v, o, do, scale, window)),
                "row_err_vs_plain": [cs.grad_row_err(a, b, floor) for a, b in zip(got, want)],
                "row_err_vs_float64": [cs.grad_row_err(a, b, floor64) for a, b in zip(got, exact)],
            }
            if tc and name != "baseline":
                r["staged_bytes"] = staged_bytes(shape)
            readings.append(r)
            print(f"  {name:20s} graph {r['graph_ms'][0]:.4f} / {r['graph_ms'][1]:.4f} ms; "
                  + ", ".join(f"{n} {t:.4f}" for n, t in sorted(r["kernel_ms"].items()))
                  + "; dq, dk, dv row err vs plain " + " ".join(f"{e:.2e}" for e in r["row_err_vs_plain"])
                  + ", vs float64 " + " ".join(f"{e:.2e}" for e in r["row_err_vs_float64"])
                  + (" (timing only)" if r["timing_only"] else ""))
            if "staged_bytes" in r:
                print("    staged into shared memory: " + ", ".join(
                    f"{n} {nb / 1e6:.1f} MB" + (f" ({nb / 1e9 / (r['kernel_ms'][n] / 1e3) / 1e3:.2f} TB/s)"
                                                 if r["kernel_ms"].get(n) else "")
                    for n, nb in r["staged_bytes"].items()))
        plain64 = [cs.grad_row_err(a, b, floor64) for a, b in zip(want, exact)]
        print(f"  {str(dtype)[6:]} plain vs float64: " + " ".join(f"{e:.2e}" for e in plain64))
        readings.append({"shape": list(shape), "variant": "plain", "row_err_vs_float64": plain64})
        del q, k, v, o, do, want, exact
    return readings


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_bwd_variants: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(dict.fromkeys([*VARIANTS, *TC_VARIANTS])))
    ap.add_argument("--baseline", default=None, help="another flash_attention_bwd.cu to time beside the wgmma route")
    args = ap.parse_args()
    names = args.variants.split(",")
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.phase_device()
    source = (build.CSRC_DIR / "flash_attention_bwd.cu").read_text()
    tables = {**VARIANTS, **TC_VARIANTS}
    jobs = {n: (source, *tables[n][:2]) for n in names}
    if args.baseline:
        jobs["baseline"] = (Path(args.baseline).read_text(), [], [])
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs) + 1) as ex:
        fwd = ex.submit(build.build, "flash_attention")
        libs = dict(zip(jobs, ex.map(lambda n: build_variant(n, *jobs[n]), jobs)))
        fwd.result()
    print(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s")

    def at_rows(name, dtype):
        """The variant's entry, called with the work list at the tile rows
        that ``dtype``'s route takes at the call's head_dim."""
        fn = entry(libs[name])
        return lambda *a: launcher(fn, fa.bwd_tile_rows(a[0].shape[3], dtype))(*a)

    readings = []
    f32 = {n: at_rows(n, torch.float32) for n in names if n in VARIANTS}
    if f32:
        readings += run_group("split TF32", cs.TRAIN_BWD_SHAPES, torch.float32, f32,
                              {n: VARIANTS[n][2] for n in f32}, tc=False)
    tc = {n: at_rows(n, torch.bfloat16) for n in names if n in TC_VARIANTS}
    timing_only = {n: TC_VARIANTS[n][2] for n in tc}
    if args.baseline:   # its bf16 route is the split-TF32 design, at that route's rows
        tc["baseline"], timing_only["baseline"] = at_rows("baseline", torch.float32), False
    if tc:
        readings += run_group("wgmma", cs.PROD_FLASH_SHAPES, torch.bfloat16, tc, timing_only, tc=True)
    print(json.dumps({"flash_bwd_variants": readings, "device": torch.cuda.get_device_name(0),
                      "card": cs.card_line()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
