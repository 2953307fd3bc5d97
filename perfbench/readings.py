"""Readings from which a cell's correctness limits are set: the compared
numbers of sound runs of the program over many seeds (the lower reading of
each number is their largest), and of the stand-ins that a comparison has
to fail (the control, the reference with fp8 products in the program's
place, and for a train cell a planted fault) on a few seeds (the upper
reading is their smallest).  All in one process on the card.

    python3 perfbench/readings.py --workload <cell> --seeds 11,12,... \
        --stand-in-seeds 21,22,23 --stand-ins control[,half_batch] \
        --seconds 3 --out readings-<cell>.json

A program seed runs the cell as ``run.py`` does with a short window of
``--seconds`` (the window still serves every checked request); a stand-in
seed runs no window.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH_DIR), str(BENCH_DIR / "reference"), str(BENCH_DIR.parent / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--stand-in-seeds", default="")
    ap.add_argument("--stand-ins", default="control")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    import torch

    from harness import spec
    from harness.context import Context, release

    if not torch.cuda.is_available():
        print("readings are taken on a CUDA card", file=sys.stderr)
        return 2
    bench = spec.manifest()
    cell = spec.cell(args.workload, bench)
    conf, traffic = spec.config_file(cell["config"], bench), spec.traffic_file(cell["traffic"])
    check = spec.workload_file(cell["name"]).get("check", {})
    drv = spec.generator(traffic)

    def ctx(seed):
        return Context(cell=cell, conf=conf, traffic=traffic, check=check, seed=seed, seconds=args.seconds,
                       trace=False, device=torch.device("cuda", 0), t_start=time.perf_counter())

    record = {"cell": cell["name"], "card": torch.cuda.get_device_name(0), "program": {}, "stand_ins": {}}
    for s in [int(x) for x in args.seeds.split(",") if x]:
        t0 = time.perf_counter()
        out = drv.run(ctx(s))
        record["program"][s] = {"numbers": out.numbers, "e2e": out.e2e, "seconds": time.perf_counter() - t0,
                                "checked": out.window.get("checked"), "check_s": out.window.get("check_s")}
        print(f"program seed {s}: {out.numbers} ({time.perf_counter() - t0:.1f} s; "
              f"{out.window.get('checked')} checked in {out.window.get('check_s')} s)", flush=True)
        del out
        release(torch.device("cuda", 0))
    kinds = [k for k in args.stand_ins.split(",") if k]
    for s in [int(x) for x in args.stand_in_seeds.split(",") if x]:
        t0 = time.perf_counter()
        got = drv.readings(ctx(s), kinds)
        record["stand_ins"][s] = got
        print(f"stand-ins seed {s}: {got} ({time.perf_counter() - t0:.1f} s)", flush=True)
        release(torch.device("cuda", 0))

    def extreme(rows, pick):
        names = sorted({k for r in rows for k in r})
        return {k: pick(r[k] for r in rows if k in r) for k in names}

    if record["program"]:
        record["lower"] = extreme([r["numbers"] for r in record["program"].values()], max)
        print("lower readings (largest of the program's):", record["lower"])
    for kind in kinds:
        rows = [r[kind] for r in record["stand_ins"].values()]
        if rows:
            record[f"upper.{kind}"] = extreme(rows, min)
            print(f"upper readings of {kind} (smallest):", record[f"upper.{kind}"])
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(record, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
