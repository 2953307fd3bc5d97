#!/usr/bin/env python3
"""A benchmark cell's traced run, with the card's idle time split by the
program span the host was in.

    python3 tools/idle_split.py --workload hymba-1.5b.train-4k --seed 12345 [--seconds 50] [--out DIR]

Runs the cell as ``perfbench/run.py --trace 1`` does (set-up, window,
traced stretches, check) and prints its result line's per-layer metrics,
then splits the gaps between the device's operations in the card-alone
traced stretch by the innermost span of the program that was open on the
host (``perfbench/harness/spans.py::idle_by_span``: ``embed``, ``layer``,
``attention``, ``ssm``, ``ssm.scan``, ``cache``, ``mlp``, ``moe``,
``head``, ``train.*``, or ``caller`` outside every root), each in seconds
and as a share of the stretch's wall time, and the spans' count a root.
The record goes to ``<out>/idle_split_<cell>_<seed>.json`` (``--out``, by
default ``build/idle_split``).  Needs the cards the cell asks for.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from collections import Counter
from pathlib import Path

T_START = time.perf_counter()

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "perfbench"
sys.path[:0] = [str(BENCH), str(BENCH / "reference"), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=50.0)
    ap.add_argument("--out", default=str(ROOT / "build" / "idle_split"))
    args = ap.parse_args(argv)

    import torch

    from harness import check, spans, spec
    from harness.context import Context
    from repro_torch import tracing

    if not torch.cuda.is_available():
        print("a traced run needs a CUDA card", file=sys.stderr)
        return 2
    import run

    bench = spec.manifest()
    cell = spec.cell(args.workload, bench)
    traffic = spec.traffic_file(cell["traffic"])
    ranges = [r for m in spec.metrics_of("per_layer", cell["name"], bench)
              for r in getattr(spec.metric_reader(m["name"]), "RANGES", [])]
    ctx = Context(cell=cell, conf=spec.config_file(cell["config"], bench), traffic=traffic,
                  check=spec.workload_file(cell["name"]).get("check", {}), seed=args.seed, seconds=args.seconds,
                  trace=True, device=torch.device("cuda", 0), t_start=T_START, ranges=ranges)
    outcome = spec.generator(traffic).run(ctx)
    correct, _ = check.verdict(outcome.numbers, spec.workload_file(cell["name"])["limits"])
    metrics = {k: v["value"] for k, v in run.metric_values(outcome, ctx, bench, True).items()}

    r = outcome.reading
    root, expected = (("train.step", spec.generator(traffic).TRACE_STEPS) if "steps" in outcome.window
                      else ("prefill", len(outcome.window["traced_lengths"])))
    recorded = tracing.spans()
    split = spans.idle_by_span(r, recorded, root, expected) or {}
    found = spans.roots(r, recorded, root, expected) or []
    ids = {s.id for s in found}
    per_root = Counter(s.name for s in recorded if s.root in ids)
    record = {
        "cell": cell["name"], "seed": args.seed, "card": torch.cuda.get_device_name(0), "correct": correct,
        "e2e": outcome.e2e, "metrics": metrics, "window_s": r.window_s, "busy_s": r.busy_s,
        "idle_s": sum(e - s for s, e in spans.gaps(r)) / 1e9, "roots": len(found),
        "spans_per_root": {k: v / max(len(found), 1) for k, v in per_root.items()},
        "split_s": split, "split_pct": {k: 100.0 * v / r.window_s for k, v in split.items()},
    }
    print(f"{cell['name']} seed {args.seed} on {record['card']}: correct {correct}; window {r.window_s:.6f} s, "
          f"busy {r.busy_s:.6f} s, gaps {record['idle_s']:.6f} s; {len(found)} roots '{root}'")
    for k, v in sorted(metrics.items()):
        print(f"  {k:36s} {v:10.4f}")
    print("  idle by innermost span (s, % of the window):")
    for k, v in sorted(split.items(), key=lambda kv: -kv[1]):
        print(f"    {k:20s} {v:10.6f} {100.0 * v / r.window_s:8.4f}%")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"idle_split_{cell['name']}_{args.seed}.json"
    path.write_text(json.dumps(record, indent=1))
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
