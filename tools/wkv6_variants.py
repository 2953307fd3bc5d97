#!/usr/bin/env python3
"""Variants of wkv6's chunk kernel on the card: what parts of its design cost
and buy, and the kernel against another version of its source.

    python3 tools/wkv6_variants.py [--variants as-is,v-unsplit,...] [--baseline FILE]

Each variant is a copy of ``src/repro_torch/kernels/csrc/wkv6.cu`` with a few
text edits, built with the package's own nvcc flags into
``build/wkv6_variants/``.  At rwkv6-7b's shape (2, 2048, 64, 64), with r, k,
v float32 (its training) and bfloat16 (its prefill), w float32, every
variant is timed in turns from a CUDA graph, and its output and final state
are held against ``wkv6_plain`` per row (``chip_smoke.py``'s rule: each
row's error over its norm, floored at 0.1 of the RMS row norm), in float32
and, for float32 r, k, v, in float64.  Variants marked "timing only"
compute less exactly on purpose: they take a part out to show what it
costs.

- ``as-is``: the kernel as it stands;
- ``v-unsplit`` (timing only): float32 v goes to the tensor cores unsplit,
  as bfloat16 v does (two products in place of three for A v and the state
  update);
- ``late-v``: chunk c + 1's v is copied in phase 3 with r, k and w, instead
  of while F and phase 2 run;
- ``unroll-4``: the product warps' two phase-2 loops unrolled by 4 (they
  spill in some type pairs).

``--baseline FILE`` adds one more variant, ``baseline``: another version of
the whole source with the same C entry (for example the parent commit's,
from ``git show <commit>:src/repro_torch/kernels/csrc/wkv6.cu`` into a file
under ``build/``), built against the headers as they stand.

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

wkv6_mod, build = cs.wkv6_mod, cs.build
OUT = ROOT / "build" / "wkv6_variants"
SHAPE = (2, 2048, 64, 64)
EARLY_V = """    if (!diag_warp) {
      if (c + 1 < n_chunks) issue_v(c + 1);
    } else {"""
PHASE3_PRODUCTS = """      if (c + 1 < n_chunks) issue_rkw(c + 1);
    } else {"""
LOOPS = ("#pragma unroll 2\n        for (int k0 = 0; k0 < CL; k0 += 8) {",
         "#pragma unroll 2\n      for (int k0 = 0; k0 < HD; k0 += 8) {")
# name: (edits of the .cu, timing only)
VARIANTS = {
    "as-is": ([], False),
    "v-unsplit": ([("constexpr bool V_EXACT = exact_tf32<TR>();", "constexpr bool V_EXACT = true;")], True),
    "late-v": ([(EARLY_V, "    if (!diag_warp) {\n    } else {"),
                (PHASE3_PRODUCTS, PHASE3_PRODUCTS + "\n      if (c + 1 < n_chunks) issue_v(c + 1);")], False),
    "unroll-4": ([(loop, loop.replace("unroll 2", "unroll 4")) for loop in LOOPS], False),
}


def edited(text: str, edits) -> str:
    for old, new in edits:
        if old not in text:
            raise ValueError(f"edit does not apply: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def build_variant(name: str, source: str, edits) -> tuple[Path, str]:
    """The variant's library and the ptxas report of its chunk kernels."""
    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    (d / "wkv6.cu").write_text(edited(source, edits))
    so = d / "wkv6.so"
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC_DIR), "-o", str(so),
                           str(d / "wkv6.cu")], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on variant {name}:\n{proc.stdout}{proc.stderr}")
    return so, proc.stdout + proc.stderr


def spills(report: str) -> dict[str, str]:
    """Registers and spill bytes of each chunk-kernel instantiation."""
    out, fn = {}, None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("chunk_kernelI", 1)[1].split("EEv", 1)[0] if "chunk_kernelI" in line else None
        elif fn and ("spill" in line or "registers" in line):
            out[fn] = f"{out.get(fn, '')} {line.split('ptxas info    :')[-1].strip()}".strip()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("wkv6_variants: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--baseline", default=None, help="another wkv6.cu to time beside the variants")
    args = ap.parse_args()
    names = args.variants.split(",")
    source = (build.CSRC_DIR / "wkv6.cu").read_text()
    jobs = {name: (source, VARIANTS[name][0]) for name in names}
    timing_only = {name: VARIANTS[name][1] for name in names}
    if args.baseline:
        jobs["baseline"] = (Path(args.baseline).read_text(), [])
        timing_only["baseline"] = False
        names.append("baseline")
    cs.phase_device()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as ex:
        built = dict(zip(jobs, ex.map(lambda n: build_variant(n, *jobs[n]), jobs)))
    print(f"built {len(built)} variants in {time.perf_counter() - t0:.1f} s")
    fns = {}
    for name, (so, report) in built.items():
        print(f"  {name}: " + "; ".join(f"{k}: {v}" for k, v in spills(report).items()))
        fn = ctypes.CDLL(str(so)).wkv6
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    readings = []
    for rkv in (torch.float32, torch.bfloat16):
        operands = cs.wkv_operands(SHAPE, rkv, seed=0, with_state=True, decays="strong")
        want = wkv6_mod.wkv6_plain(*operands)
        floors = [cs.grad_row_floor([x]) for x in want]
        exact = wkv6_mod.wkv6_plain(*(None if a is None else a.double() for a in operands)) \
            if rkv == torch.float32 else None

        def call():
            return wkv6_mod.wkv6(*operands)

        graph = {n: [] for n in fns}
        for rnd in range(2):   # in turns, the order reversed in the second round
            for name in (names if rnd == 0 else names[::-1]):
                wkv6_mod._kernel = lambda fn=fns[name]: fn
                graph[name].append(cs.time_graph_ms(call, calls=10, replays=5))
        bound = cs.wkv_bound(SHAPE, rkv)[0]
        print(f"(B,T,H,hd)={SHAPE}, r,k,v {str(rkv)[6:]}, strong decays, random state (bound {bound:.4f} ms):")
        for name in names:
            wkv6_mod._kernel = lambda fn=fns[name]: fn
            got = call()
            torch.cuda.synchronize()
            r = {"rkv": str(rkv)[6:], "variant": name, "timing_only": timing_only[name], "graph_ms": graph[name],
                 "row_err_vs_plain": [cs.grad_row_err(a, b, f) for a, b, f in zip(got, want, floors)]}
            if exact is not None:
                floors64 = [cs.grad_row_floor([x]) for x in exact]
                r["row_err_vs_float64"] = [cs.grad_row_err(a, b, f) for a, b, f in zip(got, exact, floors64)]
            readings.append(r)
            print(f"  {name:10s} graph {r['graph_ms'][0]:.5f} / {r['graph_ms'][1]:.5f} ms; row err (out, state) "
                  f"vs plain {r['row_err_vs_plain'][0]:.2e}, {r['row_err_vs_plain'][1]:.2e}"
                  + (f", vs float64 {r['row_err_vs_float64'][0]:.2e}, {r['row_err_vs_float64'][1]:.2e}"
                     if exact is not None else "")
                  + (" (timing only)" if r["timing_only"] else ""))
        del operands, want, exact, got
    print(json.dumps({"wkv6_variants": readings, "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
