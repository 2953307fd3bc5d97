#!/usr/bin/env python3
"""The MoE models' serving and training readings on the card, from two
versions of the repo in turns.

    python3 tools/moe_turns.py --baseline DIR [--turns base,here,here,base] [--out DIR]

``DIR`` holds another checkout of the repo (for example the parent commit,
``git archive <commit> | tar -x -C build/parent``).  Each turn runs in a
process of its own, from one tree's ``chip_smoke.py`` and ``src/``: the
kernels' build, ``chip_smoke.phase_zoo_path`` of grok-1-314b (4 layers)
and llama4-maverick-400b-a17b (2 layers): 2 prompts of 2048 positions and
32 decode steps in bfloat16, with the ``moe_ffn`` range's share of one
profiled prefill and of 4 profiled decode steps; then phase 7g's
production train step of grok-1-314b at the depth its plan gives
(``plan_family``, ``phase_prod_family``: 4 microbatches of 1 x 4096, the
step profiled with its host ops for the ``moe_ffn`` range), the predicted
peak beside the measured one; and, where the tree has it,
``phase_moe_graph``.  A part that raises is recorded with its error and
the turn goes on.

Each turn's whole output goes to ``<out>/moe_turns_<i>_<tree>.log``; the
readings of every turn to ``<out>/moe_turns.json`` (``--out``, by
default ``build/moe_turns``) and, one turn a line and all of them as the
last line, to stdout.  Needs one card; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import io
import json
import os
import re
import subprocess
import sys
import time
import traceback
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MODELS = ("grok-1-314b", "llama4-maverick-400b-a17b")
TRAINED = "grok-1-314b"
NUM = r"([0-9.]+)"


def zoo_readings(text: str) -> dict:
    """The numbers ``phase_zoo_path`` prints: prefill and decode ms, peak
    GiB, the device's busy share and the MoE range's share (the program's
    ``moe`` span; ``moe_ffn`` in trees before it), in the profiled prefill
    and in the profiled decode steps."""
    warm = re.search(rf"prefill of .* positions {NUM} ms, decode {NUM} ms per step.*peak memory {NUM} GiB", text)
    busy = re.findall(rf"device busy {NUM} ms of {NUM} ms wall", text)
    share = re.findall(rf"range (?:moe_ffn|moe) x\d+: kernels inside it {NUM} ms, {NUM}%", text)
    out = {"prefill_ms": float(warm[1]), "decode_ms": float(warm[2]), "peak_gib": float(warm[3])}
    for part, b, r in zip(("prefill", "decode"), busy, share):
        out[f"{part}_device_ms"] = float(b[0])
        out[f"{part}_busy_share"] = float(b[0]) / float(b[1])
        out[f"{part}_moe_ffn_ms"] = float(r[0])
        out[f"{part}_moe_ffn_share"] = float(r[1]) / 100
    return out


def train_readings(text: str, rec: dict | None) -> dict:
    """Phase 7g's record, and the ratio and ``moe_ffn`` share it printed
    (printed before any check that could raise)."""
    out = {k: v for k, v in (rec or {}).items() if isinstance(v, (int, float, str))}
    ratio = re.search(rf"peak: predicted {NUM} GiB .*measured {NUM} GiB .*ratio {NUM}", text)
    if ratio:
        out |= {"predicted_peak_gib": float(ratio[1]), "measured_peak_gib": float(ratio[2]),
                "peak_ratio": float(ratio[3])}
    step = re.search(rf"warm: train step {NUM} ms", text)
    if step:
        out["step_ms"] = float(step[1])
    busy = re.search(rf"one train step: device busy {NUM} ms", text)
    share = re.search(rf"range (?:moe_ffn|moe) x(\d+): kernels inside it {NUM} ms, {NUM}%", text)
    if busy:
        out["device_ms"] = float(busy[1])
    if share:
        out |= {"moe_ffn_calls": int(share[1]), "moe_ffn_forward_ms": float(share[2]),
                "moe_ffn_forward_share": float(share[3]) / 100}
    return out


def one_turn(tree: Path) -> dict:
    """Every part of a turn, in this process, from ``tree``."""
    sys.path[:0] = [str(tree), str(tree / "src")]
    os.chdir(tree)
    import torch

    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    record = {"tree": str(tree), "card": cs.card_line()}

    def part(name, fn, *args):
        buf = io.StringIO()
        t0 = time.perf_counter()
        result = None
        try:
            with contextlib.redirect_stdout(buf):
                result = fn(*args)
        except Exception as exc:           # recorded; the turn goes on
            record.setdefault("errors", {})[name] = f"{type(exc).__name__}: {exc}"[:2000]
            traceback.print_exc()
        text = buf.getvalue()
        print(f"== {name}: {time.perf_counter() - t0:.2f} s\n{text}", flush=True)
        return result, text

    part("build", cs.phase_build)
    for name in MODELS:
        _, text = part(f"zoo {name}", cs.phase_zoo_path, name, Counter())
        with contextlib.suppress(TypeError, IndexError):
            record[f"zoo {name}"] = zoo_readings(text)
    if hasattr(cs, "phase_moe_graph"):
        record["moe_cuda_graph"], _ = part("moe_ffn in a CUDA graph", cs.phase_moe_graph)

    # What the earlier parts leave allocated: the 7g step's measured peak
    # counts from there.
    left = [t for t in gc.get_objects() if isinstance(t, torch.Tensor) and t.is_cuda and t.nbytes >= 64 * 2**20]
    record["before 7g"] = {"allocated_gib": torch.cuda.memory_allocated() / 2**30,
                           "large_tensors": [(tuple(t.shape), str(t.dtype), t.nbytes / 2**30) for t in left]}
    del left
    # The step's profile with its host ops, for the MoE range, in both
    # trees alike.
    breakdown = cs.device_breakdown
    cs.device_breakdown = lambda label, fn, host_ops=True: breakdown(label, fn, True)
    planned, _ = part(f"plan {TRAINED}", cs.plan_family, TRAINED)
    if planned is not None:
        mesh = cs.make_host_mesh(1, 1)
        try:
            rec, text = part(f"7g {TRAINED}", cs.phase_prod_family, TRAINED, mesh, Counter(), planned)
        finally:
            torch.distributed.destroy_process_group()
        record[f"7g {TRAINED}"] = train_readings(text, rec)
    return record


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", help="another checkout of the repo ('base' in --turns)")
    ap.add_argument("--turns", default="base,here,here,base")
    ap.add_argument("--out", default=str(ROOT / "build" / "moe_turns"), help="directory for the logs and readings")
    ap.add_argument("--one", help=argparse.SUPPRESS)      # a turn's own process: the tree
    args = ap.parse_args()
    if args.one:
        print("MOE_TURN " + json.dumps(one_turn(Path(args.one)), default=str), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("moe_turns: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 2
    trees = {"here": ROOT}
    if args.baseline:
        trees["base"] = Path(args.baseline).resolve()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    turns = []
    for i, label in enumerate(args.turns.split(",")):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, __file__, "--one", str(trees[label])], capture_output=True, text=True)
        (out / f"moe_turns_{i}_{label}.log").write_text(proc.stdout + proc.stderr)
        line = [ln for ln in proc.stdout.splitlines() if ln.startswith("MOE_TURN ")]
        rec = json.loads(line[-1][len("MOE_TURN "):]) if line else {"errors": {"turn": proc.stderr[-2000:]}}
        rec |= {"turn": i, "label": label, "rc": proc.returncode, "seconds": time.perf_counter() - t0}
        turns.append(rec)
        print(json.dumps(rec), flush=True)
    (out / "moe_turns.json").write_text(json.dumps(turns, indent=1))
    print(json.dumps({"turns": turns}))
    return 0 if all(t["rc"] == 0 and not t.get("errors") for t in turns) else 1


if __name__ == "__main__":
    sys.exit(main())
