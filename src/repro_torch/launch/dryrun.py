"""Multi-pod dry run: build and count every (arch x input-shape) step on the
production meshes, and record per-rank memory, FLOPs, bytes and collective
statistics.

Port of the JAX package's ``launch/dryrun.py``.  The reference lowers and
compiles each step for 512 forced host devices and reads XLA's memory and
cost analyses; torch has no compiler to ask, so each step runs once on fake
tensors (``launch.steps``' abstract arguments, no storage) over a fake
process group of the mesh's size, as rank 0 would run it, and
``roofline.counter.count`` counts what that rank executes (see there).  In
the record ``lower_s`` is the time to build the step's bundle and
``compile_s`` the time of the counted fake run; ``memory`` holds the
counter's per-rank argument, output, temporary and peak bytes, and
``roofline`` the three-term analysis of the counted costs on the H100
(``analyze_compiled``).

The fake tensors are on the card where torch is built with CUDA, and on
the host otherwise: a host-only torch cannot run autograd on fake CUDA
tensors.  Either way the hand kernels take their fake forms, which
allocate what the card's wrappers allocate, so the plan is the card's.
Usage:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-1b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod

Results are appended as JSON lines under experiments/dryrun_torch/.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.configs import ARCHS, INPUT_SHAPES
from repro_torch.launch.steps import build_step
from repro_torch.roofline.analysis import analyze_compiled
from repro_torch.roofline.counter import count

# §Perf knobs applied under --opt.  Per-arch overrides come from the
# hillclimb iterations in EXPERIMENTS.md §Perf.
OPT_DEFAULT = dict(use_chunked_scan=True)
OPT_OVERRIDES: dict[str, dict] = {
    # 7.5B params: weight all-gather (ZeRO-3) is ~50x cheaper than
    # tensor-parallel activation all-reduce at batch 1/chip.
    "rwkv6-7b": dict(use_chunked_scan=True, parallelism="fsdp"),
    # d_inner=3200 is not 256-divisible, so ZeRO sharding degenerates for
    # half the tensors; TP + chunked SSD is the best fitting config.
    "hymba-1.5b": dict(use_chunked_scan=True),
    # 8 experts cannot map onto a 16-wide axis; refactor the logical mesh to
    # 32x8 so experts are expert-parallel on 'model' (d_model over 'data').
    "grok-1-314b": dict(use_chunked_scan=True,
                         mesh=(32, 8), capacity_factor=1.0),
}


def fake_device_type() -> str:
    """Where the dry run keeps its fake tensors: the card where torch has
    CUDA, the host otherwise."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def dryrun_mesh(shape: tuple[int, ...], axes: tuple[str, ...]):
    """A ``DeviceMesh`` of ``shape`` over the default process group (a fake
    one of ``prod(shape)`` ranks), on ``fake_device_type()``.  Nothing is
    allocated on the card, so this needs none of the checks of the
    launchers' meshes."""
    return init_device_mesh(fake_device_type(), shape, mesh_dim_names=axes)


def start_fake_group(n_ranks: int) -> bool:
    """Start a fake process group of ``n_ranks`` (its collectives move
    nothing) unless a group exists; True if this call started it.  A group
    of another size raises."""
    if dist.is_initialized():
        if dist.get_world_size() != n_ranks:
            raise RuntimeError(
                f"a process group of {dist.get_world_size()} ranks exists; the mesh needs {n_ranks}"
            )
        return False
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n_ranks)
    return True


def run_one(
    arch_name: str,
    shape_name: str,
    *,
    multi_pod: bool = False,
    optimized: bool = False,
    out_dir: str = "experiments/dryrun_torch",
    verbose: bool = True,
) -> dict:
    cfg = ARCHS[arch_name]
    mesh_shape: tuple | None = None
    if optimized:
        ov = dict(OPT_OVERRIDES.get(arch_name, OPT_DEFAULT))
        mesh_shape = ov.pop("mesh", None)
        cfg = dataclasses.replace(cfg, **ov)
    shape = INPUT_SHAPES[shape_name]
    mesh_tag = "2x16x16" if multi_pod else "16x16"
    record: dict = {
        "arch": arch_name,
        "shape": shape_name,
        "mesh": mesh_tag,
        "variant": "optimized" if optimized else "baseline",
        "status": "",
    }
    if not cfg.supports_shape(shape_name):
        record["status"] = "skipped"
        record["reason"] = (
            "full-attention arch: long_500k decode requires sub-quadratic "
            "attention (see DESIGN.md Sec. 4)"
        )
        _append(out_dir, record)
        if verbose:
            print(f"[skip] {arch_name} x {shape_name}: full attention")
        return record

    dims = mesh_shape if mesh_shape is not None else (16, 16)
    if mesh_shape is not None:
        record["mesh_factorization"] = list(mesh_shape)
    if multi_pod:
        dims, axes = (2, *dims), ("pod", "data", "model")
    else:
        axes = ("data", "model")
    record["device"] = fake_device_type()
    started = start_fake_group(math.prod(dims))
    try:
        t0 = time.time()
        bundle = build_step(cfg, shape, dryrun_mesh(dims, axes))
        t_lower = time.time() - t0
        costs, memory = count(bundle)
        t_compile = time.time() - t0 - t_lower
        record["status"] = "ok"
        record["lower_s"] = round(t_lower, 1)
        record["compile_s"] = round(t_compile, 1)
        record["memory"] = memory
        record.update(analyze_compiled(cfg, shape, bundle.mesh, costs))
        if verbose:
            gb = record["memory"]["peak_bytes"] / 2**30
            print(
                f"[ok]   {arch_name} x {shape_name} ({mesh_tag}): "
                f"peak={gb:.2f} GiB/device, "
                f"compute={record['roofline']['compute_s']:.4f}s "
                f"memory={record['roofline']['memory_s']:.4f}s "
                f"collective={record['roofline']['collective_s']:.4f}s "
                f"-> {record['roofline']['bottleneck']} "
                f"[lower {record['lower_s']}s compile {record['compile_s']}s]"
            )
    except Exception as e:  # noqa: BLE001 -- record the failure, keep sweeping
        record["status"] = "error"
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-2000:]
        if verbose:
            print(f"[FAIL] {arch_name} x {shape_name}: {record['error']}")
    finally:
        if started:
            dist.destroy_process_group()
    _append(out_dir, record)
    return record


def _append(out_dir: str, record: dict) -> None:
    os.makedirs(out_dir, exist_ok=True)
    suffix = "_opt" if record.get("variant") == "optimized" else ""
    fname = os.path.join(out_dir, f"dryrun_{record['mesh']}{suffix}.jsonl")
    with open(fname, "a") as f:
        f.write(json.dumps(record) + "\n")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=None, help="one architecture id")
    ap.add_argument("--shape", default=None, help="one input-shape id")
    ap.add_argument("--all", action="store_true", help="sweep all pairs")
    ap.add_argument("--multi-pod", action="store_true", help="2x16x16 mesh")
    ap.add_argument("--opt", action="store_true", help="apply §Perf knobs")
    ap.add_argument("--out-dir", default="experiments/dryrun_torch")
    args = ap.parse_args()

    pairs: list[tuple[str, str]]
    if args.all:
        pairs = [(a, s) for a in ARCHS for s in INPUT_SHAPES]
    else:
        assert args.arch and args.shape, "--arch and --shape (or --all)"
        pairs = [(args.arch, args.shape)]

    n_ok = n_skip = n_fail = 0
    for a, s in pairs:
        rec = run_one(
            a, s,
            multi_pod=args.multi_pod,
            optimized=args.opt,
            out_dir=args.out_dir,
        )
        n_ok += rec["status"] == "ok"
        n_skip += rec["status"] == "skipped"
        n_fail += rec["status"] == "error"
    print(f"\ndry-run summary: {n_ok} ok, {n_skip} skipped, {n_fail} failed")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
