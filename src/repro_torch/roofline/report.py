"""Render the roofline table (EXPERIMENTS.md §Roofline) from dry-run JSONL.

    PYTHONPATH=src python -m repro_torch.roofline.report experiments/dryrun/dryrun_16x16.jsonl
"""
from __future__ import annotations

import json
import sys


def load(path: str) -> list[dict]:
    recs = [json.loads(l) for l in open(path)]
    order = {"train_4k": 0, "prefill_32k": 1, "decode_32k": 2, "long_500k": 3}
    recs.sort(key=lambda r: (r["arch"], order.get(r["shape"], 9)))
    return recs


def markdown_table(recs: list[dict]) -> str:
    lines = [
        "| arch | shape | peak GiB/dev | compute s | memory s | collective s "
        "| bottleneck | MODEL_FLOPS | useful ratio | one-line diagnosis |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r["status"] == "skipped":
            lines.append(
                f"| {r['arch']} | {r['shape']} | — | — | — | — | skipped | — | — "
                f"| {r['reason'][:60]} |"
            )
            continue
        if r["status"] != "ok":
            lines.append(
                f"| {r['arch']} | {r['shape']} | — | — | — | — | ERROR | — | — "
                f"| {r.get('error','')[:60]} |"
            )
            continue
        ro = r["roofline"]
        peak = (r["memory"]["peak_bytes"] or 0) / 2**30
        diag = _diagnose(ro)
        lines.append(
            f"| {r['arch']} | {r['shape']} | {peak:.2f} "
            f"| {ro['compute_s']:.4f} | {ro['memory_s']:.4f} "
            f"| {ro['collective_s']:.4f} | {ro['bottleneck']} "
            f"| {ro['model_flops']:.2e} | {ro['useful_flops_ratio']:.3f} "
            f"| {diag} |"
        )
    return "\n".join(lines)


def _diagnose(ro: dict) -> str:
    """One sentence on what would move the dominant term down."""
    b = ro["bottleneck"]
    if b == "compute":
        if ro["useful_flops_ratio"] < 0.5:
            return "compute-bound with low useful ratio: cut remat/capacity waste"
        return "compute-bound near useful flops: increase per-chip batch or quantize"
    if b == "memory":
        ratio = ro["memory_s"] / max(ro["compute_s"], 1e-12)
        if ratio > 20:
            return (
                "HBM traffic >> flops: fuse attention/scan intermediates "
                "(Pallas flash/WKV kernels), larger chunk sizes"
            )
        return "memory-bound: improve fusion, bf16 intermediates, bigger tiles"
    cb = ro.get("collective_breakdown", {})
    if cb:
        top = max((k for k in cb), key=lambda k: cb[k])
        return (
            f"collective-bound (mostly {top}): reshard to cut {top}, "
            "overlap collectives with compute, or batch them"
        )
    return "collective-bound: reshard or overlap"


def main() -> None:
    path = sys.argv[1] if len(sys.argv) > 1 else "experiments/dryrun/dryrun_16x16.jsonl"
    print(markdown_table(load(path)))


if __name__ == "__main__":
    main()
