#!/usr/bin/env python3
"""A train bundle's memory plan against the card, op by op.

    python3 tools/plan_trace.py [--arch grok-1-314b] [--layers 1] [--out DIR]

Builds phase 7g's bundle of ``--arch`` at ``--layers`` layers
(``chip_smoke.PROD_FAMILY_SHAPE``: 4 microbatches of 1 x 4096, bf16, the
whole model's moments), counts it on fake card tensors as the plan does
(``roofline.counter.count`` over a one-rank fake group), then runs the same
bundle once on the card under the same counter, on a one-rank NCCL mesh.
After every op it records the counter's live bytes in both runs and, in
the real one, ``torch.cuda.memory_allocated``.  It prints the three peaks
(the plan, the counter on the card's tensors, the allocator) with the op
at each, the first op where the fake and real counts part, and the ops
where the counter and the allocator move apart most.  Every row goes to
``<out>/plan_trace_<arch>.json`` (``--out``, by default
``build/plan_trace``).  Needs one card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.roofline import counter  # noqa: E402

MIB = 2**20


class Logged(counter._Counter):
    """The counter, with its live bytes (and, on the card's tensors, the
    allocator's) after every op."""

    def __init__(self, sharded: bool, real: bool = False):
        super().__init__(sharded)
        self.real = real
        self.rows: list[tuple[str, int, int]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if func.namespace != "prim":          # queries (prim::device) reach fake tensors alone
            self.rows.append((func.name(), self.live, torch.cuda.memory_allocated() if self.real else 0))
        return out


def bundle_for(name: str, layers: int, mesh):
    full = cs.PROD_FAMILY_CFG.get(name, cs.ARCHS[name])
    with cs.full_depth_moments(cs.ARCHS[name]):
        return cs.build_train(dataclasses.replace(full, n_layers=layers), cs.PROD_FAMILY_SHAPE, mesh)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="grok-1-314b")
    ap.add_argument("--layers", type=int, default=1)
    ap.add_argument("--out", default=str(ROOT / "build" / "plan_trace"), help="directory for the rows")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("plan_trace: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 2
    from repro_torch.launch.dryrun import dryrun_mesh, start_fake_group

    made = []
    plain_counter = counter._Counter
    counter._Counter = lambda sharded: made.append(Logged(sharded)) or made[-1]
    start_fake_group(1)
    try:
        _, memory = counter.count(bundle_for(args.arch, args.layers, dryrun_mesh((1, 1), ("data", "model"))))
    finally:
        counter._Counter = plain_counter
        torch.distributed.destroy_process_group()
    fake = made[-1].rows

    mesh = cs.make_host_mesh(1, 1)
    try:
        bundle = bundle_for(args.arch, args.layers, mesh)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        real_args = cs.materialize(bundle, torch.Generator(device=cs.DEVICE).manual_seed(0), cs.DEVICE)
        c = Logged(False, real=True)
        for t in counter._tensors(real_args):
            c.hold(t)
        with c:
            out = bundle.fn(*real_args)
        torch.cuda.synchronize()
        allocator_peak = torch.cuda.max_memory_allocated() - base
        del out, real_args
    finally:
        torch.distributed.destroy_process_group()
    real = [(n, live, alloc - base) for n, live, alloc in c.rows]

    def at_peak(rows, col):
        i = max(range(len(rows)), key=lambda j: rows[j][col])
        return {"op": i, "name": rows[i][0], "gib": rows[i][col] / 2**30}

    same_ops = [a[0] for a in fake] == [b[0] for b in real]
    part = next((i for i, (a, b) in enumerate(zip(fake, real)) if a[0] != b[0] or abs(a[1] - b[1]) > 16 * MIB), None)
    gap = [r[2] - r[1] for r in real]            # allocator less the counter, on the card
    steps = sorted(range(1, len(gap)), key=lambda i: -abs(gap[i] - gap[i - 1]))[:12]
    report = {
        "arch": args.arch, "layers": args.layers, "card": cs.card_line(),
        "plan_peak_gib": memory["peak_bytes"] / 2**30, "plan_peak": at_peak(fake, 1),
        "counter_on_card_peak": at_peak(real, 1), "allocator_peak_gib": allocator_peak / 2**30,
        "allocator_peak_in_the_log": at_peak(real, 2), "ops_fake": len(fake), "ops_real": len(real),
        "same_op_sequence": same_ops,
        "first_part": None if part is None else {
            "op": part, "fake": fake[part][:2], "real": real[part][:2],
            "before": [f[0] for f in fake[max(part - 5, 0):part + 1]]},
        "counter_and_allocator_part_most_at": [
            {"op": i, "name": real[i][0], "gap_mib_before": gap[i - 1] / MIB, "gap_mib_after": gap[i] / MIB}
            for i in sorted(steps)],
    }
    print(json.dumps(report, indent=1))
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"plan_trace_{args.arch}.json").write_text(json.dumps({**report, "fake": fake, "real": real}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
