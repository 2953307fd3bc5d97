#!/usr/bin/env python3
"""Variants of flash_attention's split-TF32 forward kernel on the card:
what each part of the design costs and buys.

    python3 tools/flash_fwd_variants.py [--variants as-is,one-mma,...] [--baseline FILE]

Each variant is a copy of ``src/repro_torch/kernels/csrc/flash_attention.cu``
(and ``tf32.cuh``) with a few text edits, built with the package's own nvcc
flags into ``build/flash_fwd_variants/``.  At the train paths' float32
shapes every variant is timed in turns from a CUDA graph, and its output is
held against ``causal_attention_plain`` in float32 and in float64 (row
errors as ``chip_smoke.py`` reckons them).  Variants marked "timing only"
compute wrong outputs on purpose: they take a part out to show what it
costs.

- ``as-is``: the kernel as it stands;
- ``one-mma`` (timing only): each split product keeps its hi*hi mma and
  drops the two correction mmas, so the HMMAs fall to a third;
- ``no-split`` (timing only): operands go to the tensor cores unsplit (the
  split's ALU work gone, the mmas kept);
- ``no-fast-path``: every tile takes the per-element mask;
- ``chain-8``: q k^T's tensor-core accumulators added into the float32
  sum every 8 k8 steps instead of CHAIN.

``--baseline FILE`` adds one more variant, ``baseline``: another version of
the whole source with the same C entry (for example the parent commit's,
from ``git show <commit>:src/repro_torch/kernels/csrc/flash_attention.cu``
into a file under ``build/``), built with the headers as they stand.

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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

fa, build = cs.fa_mod, cs.build
OUT = ROOT / "build" / "flash_fwd_variants"
SPLIT = """  hi = __float_as_uint(x) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi));"""
CORRECTIONS = """  if constexpr (!AX) tf32::mma(c, al, bh0, bh1);
  if constexpr (!BX) tf32::mma(c, ah, bl0, bl1);"""
FAST_PATH = "if (k0 + BK - 1 <= w0 && "
# name: (edits of the .cu, edits of tf32.cuh, timing only)
VARIANTS = {
    "as-is": ([], [], False),
    "one-mma": ([(CORRECTIONS, "")], [], True),
    "no-split": ([], [(SPLIT, "  hi = __float_as_uint(x);\n  lo = hi;")], True),
    "no-fast-path": ([(FAST_PATH, "if (false && " + FAST_PATH[4:])], [], False),
    "chain-8": ([("constexpr int CHAIN = 4;", "constexpr int CHAIN = 8;")], [], False),
}


def edited(text: str, edits) -> str:
    for old, new in edits:
        if old not in text:
            raise ValueError(f"edit does not apply: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def build_variant(name: str, source: str, src_edits, hdr_edits) -> Path:
    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    (d / "flash_attention.cu").write_text(edited(source, src_edits))
    (d / "tf32.cuh").write_text(edited((build.CSRC_DIR / "tf32.cuh").read_text(), hdr_edits))
    so = d / "flash_attention.so"
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(d / "flash_attention.cu")],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on variant {name}:\n{proc.stdout}{proc.stderr}")
    return so


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_fwd_variants: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--baseline", default=None, help="another flash_attention.cu to time beside the variants")
    args = ap.parse_args()
    names = args.variants.split(",")
    source = (build.CSRC_DIR / "flash_attention.cu").read_text()
    jobs = {name: (source, *VARIANTS[name][:2]) for name in names}
    timing_only = {name: VARIANTS[name][2] for name in names}
    if args.baseline:
        jobs["baseline"] = (Path(args.baseline).read_text(), [], [])
        timing_only["baseline"] = False
        names.append("baseline")
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.phase_device()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as ex:
        libs = dict(zip(jobs, ex.map(lambda n: build_variant(n, *jobs[n]), jobs)))
    print(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s")
    fns = {}
    for name, so in libs.items():
        fn = ctypes.CDLL(str(so)).flash_attention
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                                                                    ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    readings = []
    for i, shape in enumerate(cs.TRAIN_BWD_SHAPES):
        q, k, v = cs.flash_operands(shape, torch.float32, seed=i)
        scale, window = shape[4] ** -0.5, shape[5]
        want = cs.causal_attention_plain(q, k, v, scale=scale, window=window)
        exact = cs.causal_attention_plain(q.double(), k.double(), v.double(), scale=scale, window=window)

        def call():
            return cs.causal_attention(q, k, v, scale=scale, window=window)

        graph = {n: [] for n in fns}
        for rnd in range(2):   # in turns, the order reversed in the second round
            for name in (names if rnd == 0 else names[::-1]):
                fa._kernel = lambda fn=fns[name]: fn
                graph[name].append(cs.time_graph_ms(call, calls=5, replays=3))
        bound = cs.flash_bound(shape, torch.float32, cs.SPLIT_TF32_OPS_PER_S)[0]
        print(f"(B,S,H,KV,hd,window)={shape}, float32 (split-TF32 bound {bound:.4f} ms):")
        for name in names:
            fa._kernel = lambda fn=fns[name]: fn
            got = call()
            torch.cuda.synchronize()
            r = {
                "shape": list(shape), "variant": name, "timing_only": timing_only[name], "graph_ms": graph[name],
                "row_err_vs_plain": cs.row_rel_err(got, want), "row_err_vs_float64": cs.row_rel_err(got, exact),
            }
            readings.append(r)
            print(f"  {name:13s} graph {r['graph_ms'][0]:.4f} / {r['graph_ms'][1]:.4f} ms; row err vs plain "
                  f"{r['row_err_vs_plain']:.2e}, vs float64 {r['row_err_vs_float64']:.2e}"
                  + (" (timing only)" if r["timing_only"] else ""))
        readings.append({"shape": list(shape), "variant": "plain float32",
                         "row_err_vs_float64": cs.row_rel_err(want, exact)})
        print(f"  float32 plain vs float64: {readings[-1]['row_err_vs_float64']:.2e}")
        del q, k, v, want, exact, got
    print(json.dumps({"flash_fwd_variants": readings, "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
