"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The cell's entry in ``BENCHMARK.json`` names
its configuration and traffic mix; the harness finds their files, and the
per-layer metrics' readers, by those names (``harness/spec.py``).  With
``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics and the profiler's busy and window
seconds.  The run fails, printing no result, without as many CUDA cards as
the cell asks for, or when JAX or the JAX package is loaded once the
window has closed.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
sys.path[:0] = [str(BENCH_DIR), str(BENCH_DIR / "reference"), str(ROOT / "src")]

# Build and kernel caches at fixed paths inside the checkout; nothing that
# the program uses should load JAX.
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is JAX's
    or the JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def metric_values(outcome, ctx, bench: dict, trace: bool) -> dict:
    from harness import spec

    name = ctx.cell["name"]
    if not trace:
        out = {}
        for m in spec.metrics_of("end_to_end", name, bench):
            out[m["name"]] = {"value": outcome.e2e[m["name"]], "unit": m["unit"]}
        return out
    out = {}
    for m in spec.metrics_of("per_layer", name, bench):
        value = spec.metric_reader(m["name"]).read(ctx, outcome)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result_line(cell: dict, conf: dict, traffic: dict, workload: dict, bench: dict, *, seed: int, seconds: float,
                trace: bool, device) -> dict:
    """Everything of a run after the look for the card: the generator's set-up,
    window, traced stretches and check, read into the result line."""
    import torch

    from harness import check, spec
    from harness.context import Context

    ranges = []
    if trace:
        for m in spec.metrics_of("per_layer", cell["name"], bench):
            ranges += getattr(spec.metric_reader(m["name"]), "RANGES", [])
    ctx = Context(cell=cell, conf=conf, traffic=traffic, check=workload.get("check", {}), seed=seed,
                  seconds=seconds, trace=trace, device=device, t_start=T_START, ranges=ranges)
    outcome = spec.generator(traffic).run(ctx)
    correct, checks = check.verdict(outcome.numbers, workload["limits"])
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": kind, "count": cell["chips"],
           "memory_peak_bytes": outcome.memory_peak}
    result = {"correct": correct, "attempted": outcome.attempted, "failed": outcome.failed,
              "metrics": metric_values(outcome, ctx, bench, trace), "device": dev}
    if trace:
        r = outcome.reading
        dev["busy_s"], dev["window_s"] = r.busy_s, r.window_s
        result["breakdown"] = r.breakdown()
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    args = parse(argv)
    from harness import check, spec

    bench = spec.manifest()
    cell = spec.cell(args.workload, bench)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{cell['name']} needs {cell['chips']} CUDA card(s); this machine has {n}", file=sys.stderr)
        return 2
    import repro_torch

    if ROOT / "src" not in Path(repro_torch.__file__).resolve().parents:
        print(f"the program under test is this checkout's src/repro_torch, not {repro_torch.__file__}", file=sys.stderr)
        return 2

    result = result_line(cell, spec.config_file(cell["config"], bench), spec.traffic_file(cell["traffic"]),
                         spec.workload_file(cell["name"]), bench, seed=args.seed,
                         seconds=args.seconds, trace=bool(args.trace), device=torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package are loaded: {found}", file=sys.stderr)
        return 3
    check.print_checks(result["checks"], result["correct"])
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
