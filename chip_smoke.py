#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line):

1. device: the card's name and power limit, as ``nvidia-smi`` reports them;
2. build: every CUDA source of the port (``src/repro_torch/kernels/csrc``:
   block_matmul, flash_attention, its backward flash_attention_bwd, wkv6,
   its backward wkv6_bwd),
   compiled in parallel from the checkout into ``build/repro_torch``, with
   each kernel's registers and spills; then the count of tensor-core
   instructions in the SASS of the block_matmul and flash_attention
   libraries (``HGMMA``) and of the wkv6 library (``HMMA``), none of which
   may be 0; each wgmma flash_attention instantiation must have exactly
   its count (``FLASH_TC_HGMMA``), every instantiation of the split-TF32
   forward kernel (``mma::flash_kernel``: float32 at every head_dim,
   bfloat16 at 16 and 32) must have ``HMMA``, and the CUDA-core kernel it
   replaced must be gone; the forward library's registers, spills (none
   allowed) and shared memory per route and head_dim (within 227 KB);
   every split-TF32 instantiation of the backward's product kernels
   (stats, dK/dV, dQ: float32 at every head_dim, bfloat16 at 16 and 32)
   must have ``HMMA`` and every split-TF32 dQ one ``DMMA``; each wgmma
   instantiation (``tc::``, bfloat16 at 64, 96, 128, 256) exactly its
   count of ``HGMMA`` (``BWD_TC_HGMMA``); the backward's kernels must not
   spill, and each one's shared memory at every head_dim and type must fit
   227 KB; the wkv6 library likewise, with each of its
   four chunk-kernel instantiations (r, k, v and w in float32 or
   bfloat16) holding exactly its count of ``HMMA`` (``WKV_HMMA``) and no
   token-kernel instantiation at head_dim 64 left; wkv6_bwd's kernels
   (chunk summaries, the scan over chunks, per-chunk gradients) likewise,
   and each instantiation of its two product kernels must have exactly its
   count of ``HMMA`` (``WKV_BWD_HMMA``);
3. kernel vs plain: each kernel's wrapper on the card at the reference's
   test shapes and ragged ones (``block_matmul`` also at the serving path's
   shapes and, in bfloat16, at ragged tensor-core tiles and 4096^3), held
   against its plain PyTorch version; each kernel prints the route of each
   shape; wkv6 also at strong decays (|log w| up to 20, a stretch of w = 0,
   a stretch of w = 1 - 1e-4) at ragged lengths;
4. main path: ``repro_torch.launch.serve`` serving inceptionv4 + mnasnet
   through the GPU-prefix / host-suffix engine, under the SwapLess plan and
   under a forced split, with every output held against a host-only forward
   of the same weights, each kernel's launches counted and block_matmul's
   route recorded at every call;
5. where the time goes: warm requests one at a time (closed loop) under
   the SwapLess plan, and each stage's time on the card and on one host
   core;
6. model-zoo path: ``prefill_step`` of 2 prompts of 2048 positions and 32
   ``decode_step``s, bfloat16, full width, of gemma3-1b and rwkv6-7b (full
   depth), hymba-1.5b (full depth, chunked scan), phi-3-vision-4.2b (full
   depth, 256 patches + 1792 text tokens), musicgen-large (full depth,
   frame embeddings, random frames in decode), grok-1-314b (4 of 64
   layers) and llama4-maverick (2 of 48 layers), one model at a time; each
   kernel's launches counted, the shapes it was called at recorded, device
   time by kernel and the MoE and chunked-scan ranges' share; then one
   grok-1 MoE layer (``moe_ffn`` at full width, bf16) captured in a
   ``torch.cuda.CUDAGraph`` at 1 x 4096 tokens and at the decode batch
   (capture fails on a host sync), replayed on its tokens and on new ones
   against the eager call (``MOE_GRAPH_TOL``), with both times; then each
   kernel against its plain version at those shapes (flash_attention with
   its route per shape, bf16 hd 96 on the tensor cores; wkv6 at mild and strong
   decays);
7. model-zoo correctness: float32, full width, full depth for gemma3-1b and
   rwkv6-7b and reduced depth for the others: the full forward (kernels on
   every layer) against ``prefill_step`` of 16 positions (after the
   patches) plus teacher-forced ``decode_step``s (which launch no hand
   kernel), MoE layers at a capacity with no drops; then hymba's SSM heads
   at full width on 256 tokens, the sequential scan against the
   ``selective_scan`` kernel (prefill's) and the closed form (the train
   step's), also at strong decays; then the kernel at (1, 1024 and 4096,
   3200, 16) in bfloat16 against the sequential scan, timed beside the
   closed form, its plain version, the sequential scan and its byte bound
   (the kernel is built at its first call); and the kernel at phase 6's
   shapes against the sequential scan, at mild and strong decays, timed
   beside its plain version and its byte bound (the kernels line's row);
7a. flash_attention's backward kernel against ``causal_attention_bwd_plain``
   on the card (each shape prints its route, ``bwd_route``: bfloat16 at hd
   64, 96, 128 and 256 on wgmma, the rest on split TF32): the shapes of
   phase 3 plus GQA 8, float32 and bfloat16, and
   the train paths' float32 shapes (qwen1.5-0.5b (2, 2048, 16, 16, 64);
   gemma3-1b (2, 2048, 4, 1, 256), window 512 and global); every dq, dk, dv
   row within ``GRAD_ROW_TOL``, a second call bitwise equal to the first,
   and a planted one-tile fault in dk past the limit; at the train shapes
   also the kernel's and the float32 plain version's row errors against
   the plain version in float64, and the same for the forward kernel; then
   wkv6's float32 forward at rwkv6-7b's train shape (2, 2048, 64, 64) per
   row of out and of the final state (``GRAD_ROW_TOL``, floored as below,
   with a planted one-chunk fault past the limit), beside both its and the
   float32 plain version's row errors against float64; then
   wkv6's backward kernels against ``wkv6_bwd_plain`` at the wkv6 test and
   ragged shapes and at rwkv6-7b's train shape (2, 2048, 64, 64), float32
   and bfloat16, at mild and strong decays, from a zero state and from a
   random one with a final-state gradient: every dr, dk, dv, dw row (du
   and d(state) likewise) within ``GRAD_ROW_TOL``, all finite, a second
   call bitwise equal, a planted one-chunk fault in dk past the limit; at
   the train shape in float32 also against float64, and the device time of
   each of its kernels from the train step's profile;
7b. train path: ``make_train_step`` of qwen1.5-0.5b and gemma3-1b at full
   width and depth and of rwkv6-7b at 8 of 32 layers, float32, 4
   microbatches of 2 x 2048 (cut from ``train_4k``), one warm and 3 timed
   steps on ``SyntheticTokens``, one model at a time: every parameter gets
   a finite, non-zero gradient, the forward kernel (flash_attention or
   wkv6) launches twice a layer and microbatch (remat) and its backward
   kernel once; step ms, tokens/s, peak memory, the device's busy share and
   the backward kernel's share of it under ``torch.profiler``;
7c. train correctness at full width and 2 layers, float32: the gradient of
   ``forward_loss`` through the kernels against the same model with the
   plain versions (every leaf within 1e-4 of its norm; 2 x 2048 positions,
   rwkv6-7b 2 x 256), 4 microbatches against 1, and qwen's loss falling by
   0.5 over 30 steps;
7d. the reference's production train step in bfloat16
   (``launch/steps.py``): first flash_attention and its backward at the
   path's bf16 shapes (qwen1.5-0.5b (1, 4096, 16, 16, 64); gemma3-1b
   (1, 4096, 4, 1, 256), window 512 and global) against their plain
   versions per row (the backward also against float64); then for
   qwen1.5-0.5b and gemma3-1b at full width and depth, on a one-device
   mesh (``make_host_mesh``, a one-rank NCCL group), ``build_train`` of
   ``train_4k`` with the global batch cut from 256 to 8 (8 microbatches
   of 1 x 4096, bf16 parameters, float32 moments, remat with the arch's
   policy; the bundle donates its parameters and moments), the roofline counter's FLOPs (one microbatch's bundle under
   ``FakeTensorMode``, times the microbatches) beside ``model_flops``,
   ``materialize`` (every tensor of the abstract shape and dtype), a
   finite, non-zero gradient on every leaf, one warm and 3 timed steps of
   the bundle's ``fn`` with the kernels' launches counted, and one more
   step under the profiler: step ms, tokens/s, peak memory, the device's
   busy share, the product kernels' share, flash_attention's and its
   backward's share and time a call, and the model-FLOPs utilization at
   the H100's bf16 peak beside the card's name and power limit; then the
   gradient of ``forward_loss`` in bf16 through the kernels against the
   plain versions' at full width, 1 x 4096 (qwen 2 layers, gemma3-1b 6),
   every leaf within ``PROD_GRAD_TOL`` of its norm;
7g. the same production step for hymba-1.5b (chunked scan),
   phi-3-vision-4.2b, musicgen-large, minicpm-2b, nemotron-4-15b,
   grok-1-314b (bf16 moments, as the whole model's) and rwkv6-7b: 4
   microbatches of 1 x 4096 (``train_4k`` with the global batch cut to 4),
   at the most layers whose bundle's predicted peak (``count`` on the
   card's fake tensors, in two worker processes started after phase 1)
   stays within 76 GiB, the predicted peak held within [0.98, 1.02] of the
   measured one; one warm, 2 timed and one profiled step with the
   readings of 7d (an MoE's also the share of the program's ``moe`` span
   in the profiled step); flash_attention and its backward, and wkv6 and its
   backward, per row at every new shape the steps launched (also against
   float64); the bf16 gradient at full width, 1 x 4096, 2 layers (grok-1
   1), kernels against plain versions within ``PROD_GRAD_TOL`` with an
   MoE's routing replayed from the kernel side; the kernels' times at the
   new shapes;
7e. the dry run against the card: qwen1.5-0.5b and gemma3-1b at full
   width and depth on a one-rank mesh (``make_host_mesh``), three bundles
   each: ``train_4k`` at global batch 2 (2 microbatches of 1 x 4096),
   ``prefill_32k`` at global batch 1 (32,768 tokens) and ``decode_32k`` at
   global batch 8.  For each, ``roofline.counter.count`` on the bundle's
   fake CUDA tensors (the dry run's per-rank plan; no kernel may launch),
   then the same bundle for real (``materialize``, one call of ``fn``):
   the predicted ``peak_bytes`` beside the bytes that
   ``torch.cuda.max_memory_allocated`` gained over the call and
   ``materialize`` (it fails outside [0.98, 1.02]), the counted FLOPs
   beside ``count_step`` of the same bundle on fake host tensors (they
   must be equal), and ``compute_s`` and ``memory_s`` beside the call's
   device time (CUDA events);
7f. the examples: each ``examples/torch_*.py`` (quickstart, multi-tenant
   serving, dynamic adaptation, fleet serving, training) run in this
   process on the card at its default size through its ``main``; each
   must finish without an error, the serving example must launch
   ``block_matmul`` (its GPU prefixes) and the training example
   ``flash_attention`` and ``flash_attention_bwd``, with the launch counts
   set to 0 before each and read after; they print their serving
   latencies and loss curve;
8. the device stepper's recurrence: ``lindley_ends`` on the card at 7,
   4097 and 2^20 requests (a clock past 5,000 s) against the float64
   ``_server_ends``, within 2e-6 s of delay;
9. ``simulate(backend="torch")`` against the stepper on the collab8, swap2
   and thrash16 mixes: integer observables equal, means and p99 within
   1e-4;
10. the replica engine: collab8, 2^20 requests, 32 service-jitter replicas;
    parity on two replicas against per-replica ``simulate`` (2e-4), then
    its wall time and throughput against the NumPy stepper over the
    replicas;
11. the plan evaluator: ``TorchPlanEvaluator`` against the NumPy batch on
    the three mixes under FCFS and swap_batch (5e-5) and the SLO
    objectives, ``hill_climb(evaluator=...)`` against the NumPy climb (cold,
    warm, swap_batch), and each frontier call timed beside the NumPy batch;
12. online control: ``run_adaptive`` on the Fig. 8 trace with the device
    stepper and a planner that scores on the card, against the defaults:
    identical re-plans, means within 1e-4, planner ms per re-plan;
13. times: CUDA-event times of each kernel at its path's shapes, its plain
    version and the one PyTorch call that computes the same function (where
    there is one; for the backward kernel, ``torch.autograd.grad`` through
    ``F.scaled_dot_product_attention``), beside the card's bound, launched
    eagerly and replayed from a CUDA graph (device time alone); the
    backward's bound at the float32 rate and at the split-TF32 rate
    (495 / 3 TFLOP/s), and the float32 forward kernel at the train shapes
    beside its plain version, SDPA's float32 forward and its bounds at the
    same two rates; wkv6_bwd and the float32 wkv6 forward (chunk route) at
    rwkv6-7b's train shape beside their plain versions and bounds; and
    flash_attention and its backward at the bf16 production train shapes
    beside their plain versions, SDPA's bf16 forward and backward and
    their bounds at the bf16 rate (the backward also beside its wgmma
    design's floor: eight products of the forward's size at that rate).

Phases 8-12 run torch ops, not hand kernels (the reference jits them; none
reaches a Pallas kernel): their times, launches per call and bounds go on
a ``{"torch_ops": ...}`` line, and the train paths' readings (the bf16
production steps' under ``production_train_bf16``) on a ``{"train": ...}``
line.  The line before the last is a JSON object
with one entry per kernel; the last line is ``{"ok": true, "device":
{...}}``.  Exits non-zero without a result when no CUDA device is present.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import importlib.util
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from collections import Counter
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import numpy as np  # noqa: E402

from repro_torch import tracing  # noqa: E402
from repro_torch.configs import ARCHS, INPUT_SHAPES  # noqa: E402
from repro_torch.configs.paper_models import paper_profile  # noqa: E402
from repro_torch.core import latency  # noqa: E402
from repro_torch.core.allocator import hill_climb, prop_alloc  # noqa: E402
from repro_torch.core.objective import deadline_miss, p_tail  # noqa: E402
from repro_torch.core.plan_tables import EvalTables  # noqa: E402
from repro_torch.core.planner import FCFS, DisciplineSpec, Plan, TenantSpec, validate_plan  # noqa: E402
from repro_torch.core.torch_eval import TorchPlanEvaluator  # noqa: E402
from repro_torch.hw.specs import EDGE_TPU_PLATFORM, H100_SXM  # noqa: E402
from repro_torch.data.pipeline import batches_for_arch  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa_mod  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    TENSOR_CORE_HEAD_DIMS,
    bwd_route,
    causal_attention,
    causal_attention_bwd,
    causal_attention_bwd_plain,
    causal_attention_plain,
    route,
)
from repro_torch.kernels.matmul import matmul, matmul_plain  # noqa: E402
from repro_torch.kernels.matmul import route as matmul_route  # noqa: E402
from repro_torch.kernels import selective_scan as scan_kernel  # noqa: E402
from repro_torch.kernels import wkv6 as wkv6_mod  # noqa: E402
from repro_torch.kernels.selective_scan import selective_scan_plain  # noqa: E402
from repro_torch.kernels.wkv6 import route as wkv_route  # noqa: E402
from repro_torch.kernels.wkv6 import wkv6, wkv6_bwd, wkv6_bwd_plain, wkv6_plain  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.launch.mesh import MeshView  # noqa: E402
from repro_torch.launch import steps as steps_mod  # noqa: E402
from repro_torch.launch.steps import build_step, build_train, materialize  # noqa: E402
from repro_torch.roofline.analysis import analyze_compiled  # noqa: E402
from repro_torch.models import attention, cnn, frontend, moe, rwkv, ssm  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.roofline import model_flops  # noqa: E402
from repro_torch.roofline.counter import count, count_step  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving import torch_stepper  # noqa: E402
from repro_torch.serving.controller import run_adaptive  # noqa: E402
from repro_torch.serving.simulator import _server_ends, make_backend, simulate  # noqa: E402
from repro_torch.serving.workload import RatePhase, Trace, dynamic_trace  # noqa: E402
from repro_torch.training import AdamWConfig, TrainConfig, adamw_init, make_train_step  # noqa: E402
from repro_torch.training.tree import leaves_with_paths, tree_unflatten  # noqa: E402
from repro_torch.models.cnn import (  # noqa: E402
    PAPER_CNN_SPECS,
    build_executable,
    pointwise_shapes,
)

MODELS = ("inceptionv4", "mnasnet")   # the serve default mix
RATES = "2.0,5.0"
REQUESTS = 20                         # real requests per model and plan
K_MAX = 4
FORCED_PLAN = Plan((6, 4), (2, 2))    # a second split, both sides non-empty
OUTPUT_TOL = 1e-4                     # GPU-prefix output vs host-only forward
CLOSED_LOOP = 50                      # sequential warm requests per model
DEVICE = torch.device("cuda")

# NVIDIA H100 SXM data sheet (dense): device memory rate and the peak rate
# of the units each input type runs on (float32 outside the tensor cores,
# as TF32 is disabled; bfloat16 on the tensor cores).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.float32: 67e12, torch.bfloat16: 989e12}
# float32 at full accuracy on the tensor cores: TF32's 495 TFLOP/s over the
# three products of a split operand (flash_attention_bwd's own rate).
SPLIT_TF32_OPS_PER_S = 495e12 / 3
SMEM_PER_BLOCK = 232448   # bytes of shared memory one block may use (227 KB)

# Every kernel of the port: its wrapper (whose launches the counter
# ``launches.<wrapper's name>`` of ``repro_torch.tracing`` counts), plain
# version, source, and the TPU kernel of the JAX package it replaces.
KERNELS = [
    {
        "name": "block_matmul",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/block_matmul.cu",
        "replaces": "src/repro/kernels/block_matmul.py:17",
        "wrapper": matmul,
        "plain": matmul_plain,
        "library": torch.matmul,
    },
    {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:26",
        "wrapper": causal_attention,
    },
    {
        "name": "wkv6",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/wkv6.cu",
        "replaces": "src/repro/kernels/wkv6.py:30",
        "wrapper": wkv6,
    },
    {
        # The gradient of flash_attention's function, which the JAX package
        # leaves to XLA's autodiff of models/layers.py:103 attention_chunked.
        "name": "flash_attention_bwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:26",
        "wrapper": causal_attention_bwd,
    },
    {
        # The gradient of wkv6's function, which the JAX package leaves to
        # XLA's autodiff of models/rwkv.py:88 wkv_scan.
        "name": "wkv6_bwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/wkv6_bwd.cu",
        "replaces": "src/repro/kernels/wkv6.py:30",
        "wrapper": wkv6_bwd,
    },
    {
        # hymba's selective scan, which the JAX package runs as jnp code
        # (models/ssm.py::selective_scan_chunked), in no TPU kernel.
        "name": "selective_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/selective_scan.cu",
        "replaces": "none",
        "wrapper": scan_kernel.selective_scan,
    },
]

# (M, K, N): tests/test_kernels.py::TestMatmul's aligned shapes, and ragged ones.
TEST_SHAPES = [(128, 128, 128), (256, 128, 64), (64, 256, 128), (512, 64, 256)]
RAGGED_SHAPES = [(1, 1, 1), (37, 200, 13), (129, 65, 31), (1000, 3, 70)]
# bfloat16 only: ragged tiles with 16-byte rows on the tensor-core route.
TENSOR_CORE_SHAPES = [(200, 64, 264), (1000, 1032, 520)]
TOL = {torch.float32: 1e-3, torch.bfloat16: 2e-2}   # TestMatmul's tolerances
LARGE_SHAPE = (4096, 4096, 4096)                     # checked and timed in bfloat16 only


def main_path_shapes() -> list[tuple[int, int, int]]:
    """The pointwise products of one forward of each served model, in order."""
    return [s for name in MODELS for s in pointwise_shapes(PAPER_CNN_SPECS[name])]


def operands(shape, dtype, seed):
    m, k, n = shape
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((m, k), generator=g).to(dtype).to(DEVICE)
    y = torch.randn((k, n), generator=g).to(dtype).to(DEVICE)
    return x, y


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return smi.stdout.strip()


def phase_device() -> str:
    print(card_line())
    kind = torch.cuda.get_device_name(0)
    print(f"torch device: {kind} (count {torch.cuda.device_count()}); torch {torch.__version__}, CUDA {torch.version.cuda}")
    return kind


def phase_build() -> None:
    names = [Path(k["source"]).stem for k in KERNELS]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(names)) as ex:
        paths = list(ex.map(build.build, names))
    print(f"build: {len(paths)} CUDA source(s) in {time.perf_counter() - t0:.2f} s")
    for path in paths:
        print(f"  {path.relative_to(ROOT)}")
        for line in path.with_name(path.name + ".log").read_text().splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                print(f"    {line.strip()}")


def find_cuobjdump() -> str | None:
    """``cuobjdump`` from PATH, the CUDA toolkit, or Triton's own copy."""
    found = shutil.which("cuobjdump")
    if found:
        return found
    dirs = [Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin"]
    spec = importlib.util.find_spec("triton")
    if spec and spec.submodule_search_locations:
        dirs.append(Path(spec.submodule_search_locations[0]) / "backends" / "nvidia" / "bin")
    for d in dirs:
        if (d / "cuobjdump").exists():
            return str(d / "cuobjdump")
    return None


def phase_tensor_cores(name: str, opcode: str, expected: dict[str, int] | None = None,
                       every: dict[str, int] | None = None, pinned: dict[str, int] | None = None) -> int:
    """Count the tensor-core instructions (``opcode``: HGMMA for Hopper's
    wgmma, HMMA for mma.sync) in each kernel of library ``name``'s SASS;
    fails when there are none, when the kernels whose mangled names match a
    pattern of ``expected`` are not exactly one with that pattern's count,
    when the kernels matching a pattern of ``every`` are not that many or
    one of them has none, when a pattern of ``pinned`` matches no kernel or
    one whose count is not the pattern's, or when no ``cuobjdump`` is
    found."""
    tool = find_cuobjdump()
    if tool is None:
        raise RuntimeError("cuobjdump is not available: the tensor-core route cannot be shown")
    lib = build.library_path(name)
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True, check=True, timeout=300).stdout
    counts, fn = Counter(), None
    for line in sass.splitlines():
        header = re.match(r"\s*Function : (\S+)", line)
        if header:
            fn = header.group(1)
            counts[fn] += 0
        elif fn and re.search(rf"\b{opcode}\b", line):
            counts[fn] += 1
    print(f"SASS of {lib.relative_to(ROOT)} ({tool}): {opcode} instructions per kernel")
    for fn_name, n in counts.items():
        print(f"  {n:5d}  {fn_name}")
    total = sum(counts.values())
    if total == 0:
        raise AssertionError(f"no {opcode} instruction in the {name} library: the tensor-core route is missing")
    for pattern, want in (expected or {}).items():
        found = [n for fn_name, n in counts.items() if re.search(pattern, fn_name)]
        if found != [want]:
            raise AssertionError(f"{name} kernels matching {pattern!r} have {found} {opcode}, expected [{want}]")
    for pattern, n_kernels in (every or {}).items():
        found = [n for fn_name, n in counts.items() if re.search(pattern, fn_name)]
        if len(found) != n_kernels or min(found, default=0) == 0:
            raise AssertionError(f"{name} kernels matching {pattern!r} have {found} {opcode}, "
                                 f"expected {n_kernels} kernels with some each")
    for pattern, want in (pinned or {}).items():
        found = [n for fn_name, n in counts.items() if re.search(pattern, fn_name)]
        if not found or any(n != want for n in found):
            raise AssertionError(f"{name} kernels matching {pattern!r} have {found} {opcode}, expected {want} each")
    return total


def ptxas_resources(name: str) -> dict[str, tuple[int, int]]:
    """Registers and spill bytes (stores + loads) of each kernel of library
    ``name``, from the ``-Xptxas -v`` report kept beside it."""
    path = build.library_path(name)
    out, fn = {}, None
    for line in path.with_name(path.name + ".log").read_text().splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            fn = entry.group(1)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if fn and spill:
            out[fn] = (out.get(fn, (0, 0))[0], int(spill.group(1)) + int(spill.group(2)))
        regs = re.search(r"Used (\d+) registers", line)
        if fn and regs:
            out[fn] = (int(regs.group(1)), out.get(fn, (0, 0))[1])
    return out


def printed_resources(name: str) -> tuple[dict[str, tuple[int, int]], list[str]]:
    """ptxas_resources of library ``name``, printed, and the kernels that
    spill."""
    res = ptxas_resources(name)
    print(f"{name}: registers / spill bytes per kernel (ptxas)")
    for fn_name, (regs, spill) in sorted(res.items()):
        print(f"  {regs:4d} / {spill:4d}  {fn_name}")
    return res, [fn_name for fn_name, (_, spill) in res.items() if spill]


def phase_bwd_resources() -> dict:
    """The backward library's kernels: registers and spills from ptxas (no
    spills anywhere) and each kernel's dynamic shared memory at every
    head_dim and type, from the library itself (within the 227 KB a block
    may take)."""
    res, spilled = printed_resources("flash_attention_bwd")
    # Four kernels (stats, dK/dV, reduction, dQ) for each (type, head_dim),
    # on the route bwd_route names.
    if len(res) != 4 * 2 * len(fa_mod.HEAD_DIMS) or spilled:
        raise AssertionError(f"flash_attention_bwd: {len(res)} kernels in the ptxas report, spills in {spilled}")
    fn = build.load("flash_attention_bwd").flash_attention_bwd_smem
    fn.argtypes, fn.restype = [ctypes.c_int] * 3, ctypes.c_int
    smem = {f"{str(dt)[6:]} hd {hd} {bwd_route(dt, hd)}": [fn(hd, int(dt == torch.bfloat16), kern) for kern in range(3)]
            for dt in (torch.float32, torch.bfloat16) for hd in fa_mod.HEAD_DIMS}
    print("  dynamic shared memory (bytes: stats, dK/dV, dQ): " + "; ".join(f"{k} {v}" for k, v in smem.items()))
    if max(max(v) for v in smem.values()) > SMEM_PER_BLOCK or min(min(v) for v in smem.values()) <= 0:
        raise AssertionError(f"flash_attention_bwd's shared memory outside (0, {SMEM_PER_BLOCK}]: {smem}")
    short = {}
    for mangled, (regs, _) in res.items():
        m = re.search(rf"(2tc)?\d+({'|'.join(BWD_KERNEL_NAMES[::-1])})I(f|13__nv_bfloat16)?Li(\d+)E", mangled)
        if m:
            dt = {"f": "float,", "13__nv_bfloat16": "bfloat16,", None: ""}[m.group(3)]
            mangled = f"{'tc::' if m.group(1) else ''}{m.group(2)}<{dt}{m.group(4)}>"
        short[mangled] = regs
    return {"registers": short, "smem_bytes": smem}


# The split-TF32 forward kernel's instantiations, as the SASS and ptxas name
# them (mma::flash_kernel<T, hd>), and the CUDA-core kernel it replaced
# (flash_kernel<T, hd> directly in the file's anonymous namespace).
FWD_MMA_KERNEL = r"3mma12flash_kernelI"
FWD_DELETED_KERNEL = r"(?<!3mma)(?<!2tc)12flash_kernelI"


def phase_fwd_resources() -> dict:
    """The forward library's kernels: registers and spills from ptxas (no
    spills anywhere; one split-TF32 instantiation per route case, and none
    of the deleted CUDA-core kernel) and the dynamic shared memory of the
    kernel each (type, head_dim) takes, from the library itself (within
    the 227 KB a block may take)."""
    res, spilled = printed_resources("flash_attention")
    mma = [fn_name for fn_name in res if re.search(FWD_MMA_KERNEL, fn_name)]
    deleted = [fn_name for fn_name in res if re.search(FWD_DELETED_KERNEL, fn_name)]
    cases = [(dt, hd) for dt in (torch.float32, torch.bfloat16) for hd in fa_mod.HEAD_DIMS
             if route(dt, hd) == "tf32-mma"]
    if spilled or deleted or len(mma) != len(cases):
        raise AssertionError(f"flash_attention: spills in {spilled}, deleted kernel {deleted}, "
                             f"{len(mma)} split-TF32 kernels for {len(cases)} route cases")
    fn = build.load("flash_attention").flash_attention_smem
    fn.argtypes, fn.restype = [ctypes.c_int] * 2, ctypes.c_int
    smem = {f"{str(dt)[6:]} hd {hd} {route(dt, hd)}": fn(hd, int(dt == torch.bfloat16))
            for dt in (torch.float32, torch.bfloat16) for hd in fa_mod.HEAD_DIMS}
    print("  dynamic shared memory (bytes): " + "; ".join(f"{k} {v}" for k, v in smem.items()))
    if max(smem.values()) > SMEM_PER_BLOCK or min(smem.values()) <= 0:
        raise AssertionError(f"flash_attention's shared memory outside (0, {SMEM_PER_BLOCK}]: {smem}")
    short = {}
    for mangled, (regs, _) in res.items():
        m = re.search(r"(3mma|2tc)12flash_kernelI(f|13__nv_bfloat16)?Li(\d+)E", mangled)
        name = {"3mma": "mma", "2tc": "tc"}[m.group(1)] if m else None
        dt = {"f": "float,", "13__nv_bfloat16": "bfloat16,", None: ""}[m.group(2)] if m else ""
        short[f"{name}::flash_kernel<{dt}{m.group(3)}>" if m else mangled] = regs
    return {"registers": short, "smem_bytes": smem}


# The wkv6 library's kernels as the SASS and ptxas name them: the chunk
# kernel (tc::chunk_kernel<TR, TW>) and the token kernel
# (wkv6_kernel<TR, TW, hd>).  HMMA instructions in each chunk-kernel
# instantiation, by r, k, v's type (w's type does not change them): the
# float32 one splits v in A v and (K^ F)^T v, a third product each.
WKV_CHUNK_KERNEL = r"2tc12chunk_kernelI"
WKV_TOKEN_KERNEL = r"11wkv6_kernelI"
WKV_HMMA = {"float": 120, "bfloat16": 104}


def wkv_hmma_pins() -> dict[str, int]:
    """WKV_HMMA as patterns of the mangled names, each matching the two
    instantiations of one r, k, v type, for phase_tensor_cores."""
    return {rf"{WKV_CHUNK_KERNEL}{'f' if dt == 'float' else '13__nv_bfloat16'}": n for dt, n in WKV_HMMA.items()}


def phase_wkv6_resources() -> dict:
    """The wkv6 library's kernels: registers and spills from ptxas (no
    spills; the chunk kernel for each of the four type pairs, the token
    kernel at head_dims 8, 16 and 32 alone) and the chunk kernel's dynamic
    shared memory for each type pair, from the library itself (within the
    227 KB a block may take)."""
    res, spilled = printed_resources("wkv6")
    chunk = [fn_name for fn_name in res if re.search(WKV_CHUNK_KERNEL, fn_name)]
    token = [fn_name for fn_name in res if re.search(WKV_TOKEN_KERNEL, fn_name)]
    token_dims = sorted({int(re.search(r"Li(\d+)E", fn_name).group(1)) for fn_name in token})
    small = [hd for hd in wkv6_mod.HEAD_DIMS if wkv_route(torch.float32, hd) == "token"]
    if spilled or len(chunk) != 4 or len(token) != 4 * len(small) or token_dims != small:
        raise AssertionError(f"wkv6: spills in {spilled}, {len(chunk)} chunk kernels (want 4), token kernels at "
                             f"head_dims {token_dims} (want {small}, four type pairs each)")
    fn = build.load("wkv6").wkv6_smem
    fn.argtypes, fn.restype = [ctypes.c_int] * 2, ctypes.c_int
    types = ("float32", "bfloat16")
    smem = {f"r,k,v {rkv} w {w}": fn(int(rkv == "bfloat16"), int(w == "bfloat16")) for rkv in types for w in types}
    print(f"  chunk kernel's dynamic shared memory (bytes): {smem}")
    if max(smem.values()) > SMEM_PER_BLOCK or min(smem.values()) <= 0:
        raise AssertionError(f"wkv6's shared memory outside (0, {SMEM_PER_BLOCK}]: {smem}")
    short = {}
    for mangled, (regs, _) in res.items():
        m = re.search(rf"({WKV_CHUNK_KERNEL}|{WKV_TOKEN_KERNEL})(f|13__nv_bfloat16)(f|13__nv_bfloat16|S\d*_)(Li(\d+)E)?",
                      mangled)
        if not m:
            short[mangled] = regs
            continue
        tr = "float" if m.group(2) == "f" else "bfloat16"
        tw = {"f": "float", "13__nv_bfloat16": "bfloat16"}.get(m.group(3), tr)
        name = "tc::chunk_kernel" if m.group(1) == WKV_CHUNK_KERNEL else "wkv6_kernel"
        short[f"{name}<{tr},{tw}{',' + m.group(5) if m.group(5) else ''}>"] = regs
    return {"registers": short, "smem_bytes": smem}


def phase_kernel_vs_plain(kernel: dict) -> dict:
    """Hold the kernel against its plain version; returns what the kernels
    line reports: the largest error on the main path's (float32) shapes,
    every shape checked and how many took each route.  Both routes must
    occur."""
    fn, plain = kernel["wrapper"], kernel["plain"]
    main = main_path_shapes()
    shapes = list(dict.fromkeys(main + TEST_SHAPES + RAGGED_SHAPES))
    checked, main_err, routes = [], 0.0, Counter()
    for dtype, extra in ((torch.float32, []), (torch.bfloat16, TENSOR_CORE_SHAPES + [LARGE_SHAPE])):
        for i, shape in enumerate(shapes + extra):
            x, y = operands(shape, dtype, seed=i)
            got = fn(x, y)
            torch.cuda.synchronize()
            want = plain(x, y)
            err = float((got.float() - want.float()).abs().max())
            tol = TOL[dtype]
            ok = torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)
            r = matmul_route(dtype, shape[0], shape[2], shape[1])
            routes[r] += 1
            print(f"  {kernel['name']} {str(dtype)[6:]} {shape} {r}: max_abs_err={err:.3e} tol={tol} {'ok' if ok else 'MISMATCH'}")
            if not ok:
                raise AssertionError(f"{kernel['name']} disagrees with its plain version at {shape} {dtype}")
            if dtype == torch.float32 and shape in main:
                main_err = max(main_err, err)
            checked.append([*shape, str(dtype)[6:]])
    if set(routes) != {"cuda-core", "tensor-core"}:
        raise AssertionError(f"block_matmul's checks did not take both routes: {dict(routes)}")
    return {"max_abs_err": main_err, "shapes_checked": checked, "routes": dict(routes)}


@contextlib.contextmanager
def recording_matmul_routes(routes: Counter):
    """Count the route of every call the CNN stages make to the matmul
    wrapper on the card (host suffixes compute the plain version).  The
    wrapper itself, and its launch count, are unchanged."""
    wrapped = cnn.matmul

    def rec(x, y, out_dtype=None):
        if x.device.type == "cuda":
            routes[matmul_route(x.dtype, x.shape[0], y.shape[1], x.shape[1])] += 1
        return wrapped(x, y, out_dtype)

    cnn.matmul = rec
    try:
        yield
    finally:
        cnn.matmul = wrapped


def phase_main_path() -> tuple[Plan, dict[str, int], dict[str, int]]:
    """Serve the mix on the card; returns the SwapLess plan, each kernel's
    launches on the path and block_matmul's routes there."""
    routes = Counter()
    zero_launches()
    t0 = time.perf_counter()
    with recording_matmul_routes(routes):
        plan, done = serve.main([
            "--models", ",".join(MODELS), "--rates", RATES,
            "--requests", str(REQUESTS), "--k-max", str(K_MAX), "--device", DEVICE.type,
        ])
        models = [build_executable(PAPER_CNN_SPECS[n], seed=i, device=DEVICE) for i, n in enumerate(MODELS)]
        print(f"forced split {FORCED_PLAN.partition} cores {FORCED_PLAN.cores}:")
        done_forced = serve.run_requests(models, FORCED_PLAN, K_MAX, REQUESTS, DEVICE)
        serve.report_latencies(MODELS, done_forced)
    launches = launch_counts()
    print(f"main path: {time.perf_counter() - t0:.2f} s, launches {launches}, block_matmul routes {dict(routes)}")

    # Every request completed, with finite outputs equal to a host-only
    # forward of the same weights (serve builds model i from seed i).
    host = [build_executable(PAPER_CNN_SPECS[n], seed=i, device="cpu") for i, n in enumerate(MODELS)]
    for run_plan, records in ((plan, done), (FORCED_PLAN, done_forced)):
        assert len(records) == len(MODELS) * REQUESTS, len(records)
        for c in records:
            if not c.ok:
                raise RuntimeError(f"request of {MODELS[c.model_idx]} failed") from c.error
        for i, m in enumerate(host):
            mine = sorted((c for c in records if c.model_idx == i), key=lambda c: c.submit_time)
            for s, c in enumerate(mine):
                assert c.output.device.type == "cpu" and bool(torch.isfinite(c.output).all())
                want = m.make_input(s)
                for seg in m.segments:
                    want = seg(want)
                torch.testing.assert_close(c.output, want, rtol=OUTPUT_TOL, atol=OUTPUT_TOL)
        print(f"outputs of plan {run_plan.partition} match the host-only forward to {OUTPUT_TOL}")

    # One pointwise product per prefix stage, each on the card; the CNNs
    # have no attention or recurrence.
    expected = REQUESTS * (sum(plan.partition) + sum(FORCED_PLAN.partition))
    assert launches == {"block_matmul": expected, "flash_attention": 0, "wkv6": 0, "flash_attention_bwd": 0,
                        "wkv6_bwd": 0, "selective_scan": 0}, (launches, expected)
    # Every product of the path is float32 and takes the CUDA-core route.
    assert routes == {"cuda-core": expected}, (dict(routes), expected)
    return plan, launches, dict(routes)


def phase_breakdown(plan: Plan) -> None:
    """Warm latency without queueing, and each stage's share of it."""
    models = [build_executable(PAPER_CNN_SPECS[n], seed=i, device=DEVICE) for i, n in enumerate(MODELS)]
    lat = {n: [] for n in MODELS}
    eng = ServingEngine(models, plan, k_max=K_MAX, device=DEVICE)
    try:
        for i, m in enumerate(models):       # warm every path once
            eng.submit(i, m.make_input(0))
        assert all(c.ok for c in eng.drain(timeout=120.0))
        for s in range(CLOSED_LOOP):
            for i, m in enumerate(models):
                eng.submit(i, m.make_input(s))
                (c,) = eng.drain(timeout=120.0)
                assert c.ok
                lat[MODELS[i]].append(c.latency * 1e3)
    finally:
        eng.shutdown()
    print(f"closed loop, plan {plan.partition} cores {plan.cores}, {CLOSED_LOOP} warm requests per model, one at a time:")
    for name, ls in lat.items():
        q = torch.tensor(ls, dtype=torch.float64).quantile(torch.tensor([0.5, 0.8], dtype=torch.float64))
        print(f"  {name:<14} median={float(q[0]):.3f}ms p80={float(q[1]):.3f}ms max={max(ls):.3f}ms")

    # Each stage alone: on the card (CUDA events over back-to-back calls,
    # host launch overhead included) and on one host core (as a pool
    # worker runs it).
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for m, p in zip(models, plan.partition):
            print(f"  stages of {m.name} (prefix {p}), ms per call: card / one host core")
            x_dev = m.make_input(0).to(DEVICE)
            x_host = m.make_input(0)
            for j, seg in enumerate(m.segments):
                dev_ms = time_ms(lambda: seg(x_dev), 50)
                t0 = time.perf_counter()
                for _ in range(20):
                    y_host = seg(x_host)
                host_ms = (time.perf_counter() - t0) / 20 * 1e3
                side = "card" if j < p else "host"
                print(f"    stage {j} {tuple(x_host.shape[1:])}: {dev_ms:.4f} / {host_ms:.4f}  (runs on the {side})")
                x_dev, x_host = seg(x_dev), y_host
    finally:
        torch.set_num_threads(threads)


def time_ms(fn, iters: int, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_graph_ms(fn, calls: int = 20, replays: int = 20) -> float:
    """Device time per call with the host's launch overhead taken out:
    ``calls`` calls captured in one CUDA graph, replayed ``replays`` times."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return time_ms(graph.replay, replays, warmup=2) / calls


def bound(shape, dtype) -> tuple[float, str]:
    """Least time (ms) for (M,K)@(K,N) -> (M,N) in ``dtype``: each input read
    once and the output written once at the memory rate, or 2MNK operations
    at the peak rate of the type, whichever is longer."""
    m, k, n = shape
    size = torch.empty((), dtype=dtype).element_size()
    t_bytes = (m * k + k * n + m * n) * size / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * m * n * k / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_times(kernel: dict) -> dict:
    """Per-shape times; the totals over the main path's products are the
    kernels line's numbers."""
    fn, plain, lib = kernel["wrapper"], kernel["plain"], kernel["library"]
    rows = [(s, torch.float32) for s in dict.fromkeys(main_path_shapes())]
    rows.append((LARGE_SHAPE, torch.bfloat16))
    per_shape = {}
    print(f"times of {kernel['name']} (ms per call, CUDA events):")
    for shape, dtype in rows:
        x, y = operands(shape, dtype, seed=0)
        r = matmul_route(dtype, shape[0], shape[2], shape[1])
        iters = 20 if shape == LARGE_SHAPE else 200
        t = {
            "ms": time_ms(lambda: fn(x, y), iters),
            "plain_ms": time_ms(lambda: plain(x, y), iters),
            "library_ms": time_ms(lambda: lib(x, y), iters),
            "graph_ms": time_graph_ms(lambda: fn(x, y), calls=5 if shape == LARGE_SHAPE else 20),
            "plain_graph_ms": time_graph_ms(lambda: plain(x, y), calls=5 if shape == LARGE_SHAPE else 20),
            "library_graph_ms": time_graph_ms(lambda: lib(x, y), calls=5 if shape == LARGE_SHAPE else 20),
        }
        t["bound_ms"], t["bound_by"] = bound(shape, dtype)
        per_shape[(shape, dtype)] = t
        print(
            f"  {str(dtype)[6:]} M={shape[0]} K={shape[1]} N={shape[2]} {r}: "
            f"kernel={t['ms']:.6f} plain={t['plain_ms']:.6f} torch.matmul={t['library_ms']:.6f} "
            f"bound={t['bound_ms']:.6f} ({t['bound_by']}) share={t['bound_ms'] / t['ms']:.4%}; "
            f"from a CUDA graph: kernel={t['graph_ms']:.6f} plain={t['plain_graph_ms']:.6f} "
            f"torch.matmul={t['library_graph_ms']:.6f} share={t['bound_ms'] / t['graph_ms']:.4%}"
        )
    main = [per_shape[(s, torch.float32)] for s in main_path_shapes()]
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "graph_ms", "plain_graph_ms", "library_graph_ms")
    totals = {key: sum(r[key] for r in main) for key in keys}
    by_bytes = sum(r["bound_ms"] for r in main if r["bound_by"] == "bytes")
    totals["bound_by"] = "bytes" if by_bytes >= totals["bound_ms"] / 2 else "operations"
    print(
        f"  main path ({len(main)} products, one forward of each of {', '.join(MODELS)}): "
        f"kernel={totals['ms']:.6f} plain={totals['plain_ms']:.6f} "
        f"torch.matmul={totals['library_ms']:.6f} bound={totals['bound_ms']:.6f} ({totals['bound_by']}); "
        f"from a CUDA graph: kernel={totals['graph_ms']:.6f} plain={totals['plain_graph_ms']:.6f} "
        f"torch.matmul={totals['library_graph_ms']:.6f}"
    )
    return totals


# --------------------------------------------------------------------------
# Model zoo: prefill and decode of every family at full width: gemma3-1b
# and rwkv6-7b (the wkv6 kernel), hymba-1.5b (parallel SSM heads, window
# 1024), phi-3-vision-4.2b (vision frontend, head_dim 96), musicgen-large
# (audio frontend), grok-1-314b and llama4-maverick (mixture of experts)
# --------------------------------------------------------------------------
ZOO = {
    "gemma3-1b": ARCHS["gemma3-1b"],
    "rwkv6-7b": ARCHS["rwkv6-7b"],
    # The reference's §Perf setting, as launch/dryrun.py serves hymba.
    "hymba-1.5b": dataclasses.replace(ARCHS["hymba-1.5b"], use_chunked_scan=True),
    "phi-3-vision-4.2b": ARCHS["phi-3-vision-4.2b"],
    "musicgen-large": ARCHS["musicgen-large"],
    # Depth cut to fit one 80 GB card in bfloat16: 4 of 64 layers (about
    # 40 GB), and 2 of 48 (one dense, one MoE layer of 128 experts; 37 GB).
    "grok-1-314b": dataclasses.replace(ARCHS["grok-1-314b"], n_layers=4),
    "llama4-maverick-400b-a17b": dataclasses.replace(ARCHS["llama4-maverick-400b-a17b"], n_layers=2),
}
# Cut from INPUT_SHAPES["prefill_32k"] (32 prompts of 32768 tokens) to stay
# within the smoke run's time; 2048 is the reference's CHUNKED_SEQ_THRESHOLD
# and four of gemma3-1b's 512-token windows.  phi-3-vision's 2048 positions
# are its 256 patches and 1792 text tokens.
ZOO_BATCH, ZOO_PROMPT, ZOO_DECODE = 2, 2048, 32
ZOO_PROFILE_DECODE = 4   # decode steps under the profiler (its post-processing grows with events)
# float32 check: (config, positions).  gemma3-1b: 2 windows; rwkv6-7b: 8
# wkv chunks; hymba: past its 1024-token window, 34 scan chunks; the
# others at reduced depth so that float32 weights fit the card (llama4's
# MoE layer alone is 64 GB).  MoE layers take a capacity factor with which
# no group can drop a token (8.0, as tests/test_prefill_decode.py, and
# E / k = 128 for llama4): prefill's groups would otherwise drop tokens
# that one-token decode never drops, and the invariant holds only without
# drops.
ZOO_CHECK = {
    "gemma3-1b": (ARCHS["gemma3-1b"], 1024),
    "rwkv6-7b": (ARCHS["rwkv6-7b"], 256),
    "hymba-1.5b": (dataclasses.replace(ZOO["hymba-1.5b"], n_layers=4), 1088),
    "phi-3-vision-4.2b": (dataclasses.replace(ARCHS["phi-3-vision-4.2b"], n_layers=2), 384),
    "musicgen-large": (dataclasses.replace(ARCHS["musicgen-large"], n_layers=2), 256),
    "grok-1-314b": (dataclasses.replace(ARCHS["grok-1-314b"], n_layers=1, capacity_factor=8.0), 128),
    "llama4-maverick-400b-a17b": (
        dataclasses.replace(ARCHS["llama4-maverick-400b-a17b"], n_layers=2, capacity_factor=128.0), 128,
    ),
}
ZOO_CHECK_PREFILL = 16   # text tokens or frames; the vision frontend's patches come first
ZOO_CHECK_TOL = 2e-3   # tests/test_prefill_decode.py's prefill tolerance
SCAN_LEN, SCAN_TOL = 256, 1e-3   # hymba's sequential scan against the chunked one
SCAN_TIME_LENS = (1024, 4096)    # the benchmark's shortest and longest hymba prompts
FLASH_TOL = {torch.float32: 5e-4, torch.bfloat16: 3e-2}   # TestFlashAttention
# FLASH_TOL is absolute and late rows of a long causal row are small (about
# 0.04 at S = 2048), so each output row (one query of one head) is also held
# to its error's norm over the plain row's norm: the limits lie between the
# sound kernels' largest reading and that of a planted one-tile fault
# (tile_fault_err), which every long shape checks (PERF.md, PR 19).
FLASH_ROW_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# HGMMA per tensor-core flash_attention instantiation: hd / 16 steps of
# q k^T, and kv_tile / 16 steps of P v times the hd / 64 (hd 96: 3) panels.
FLASH_TC_HGMMA = {64: 4 + 4, 96: 6 + 4 * 3, 128: 8 + 4 * 2, 256: 16 + 2 * 4}
# HGMMA per wgmma instantiation of the backward (tc::, bfloat16): hd / 16
# steps of each score product (stats: q k^T; dK/dV: k q^T and v do^T; dQ:
# q k^T and do v^T) and, per 16 rows of the reduction, one wgmma a panel of
# hd (64 columns; 32 at hd 96) for each row-contracting product (dK/dV: p^T
# do and ds^T q over 64 queries; dQ: ds k over 64 keys, 32 at hd 256).
BWD_TC_HGMMA = {
    "stats_kernel": {hd: hd // 16 for hd in TENSOR_CORE_HEAD_DIMS},
    "dkdv_kernel": {hd: 2 * hd // 16 + 2 * 4 * (hd // (32 if hd == 96 else 64)) for hd in TENSOR_CORE_HEAD_DIMS},
    "dq_kernel": {hd: 2 * hd // 16 + (2 if hd == 256 else 4) * (hd // (32 if hd == 96 else 64))
                  for hd in TENSOR_CORE_HEAD_DIMS},
}
WKV_TOL = 2e-3                                             # TestWKV6
# (B, S, H, KV, hd, window): TestFlashAttention's shapes, a property-sweep
# sample, the first-token case, gemma3's GQA at hd 256, phi-3-vision's path
# shape at hd 96, and ragged lengths (hd 96: one token, 37 and 2047
# positions, GQA 4, windows of 17 and 512).
FLASH_TEST_SHAPES = [
    (2, 128, 4, 2, 32, 0), (2, 128, 4, 2, 32, 64), (2, 128, 4, 2, 32, 17),
    (1, 256, 4, 2, 64, 100), (1, 32, 1, 1, 16, 16), (1, 64, 2, 2, 16, 0),
    (1, 64, 4, 1, 256, 16), (2, 2048, 32, 32, 96, 0),
]
FLASH_RAGGED_SHAPES = [
    (1, 1, 2, 2, 16, 0), (1, 37, 4, 2, 32, 0), (2, 37, 2, 1, 64, 5),
    (1, 100, 2, 1, 128, 0), (2, 600, 4, 1, 256, 512), (1, 1000, 16, 16, 64, 0),
    (1, 33, 4, 1, 256, 0), (2, 2047, 4, 1, 256, 512),
    (1, 1, 4, 1, 96, 0), (2, 37, 8, 2, 96, 0), (1, 37, 4, 4, 96, 17),
    (1, 300, 4, 1, 96, 17), (2, 2047, 8, 2, 96, 512),
]
# (B, T, H, hd): TestWKV6's shapes and property-sweep sample, and ragged ones.
# hd 64 (the chunk route) also at one whole chunk and at a ragged one.
WKV_TEST_SHAPES = [(1, 64, 2, 16), (2, 32, 2, 8), (1, 16, 1, 8), (1, 128, 4, 32), (1, 64, 2, 64)]
WKV_RAGGED_SHAPES = [(1, 1, 2, 64), (1, 37, 3, 32), (3, 100, 4, 64), (2, 33, 64, 64), (1, 37, 3, 64)]


def flash_operands(shape, dtype, seed):
    b, s, h, kv, hd, _ = shape
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((b, s, h, hd), generator=g).to(dtype).to(DEVICE)
    k = torch.randn((b, s, kv, hd), generator=g).to(dtype).to(DEVICE)
    v = torch.randn((b, s, kv, hd), generator=g).to(dtype).to(DEVICE)
    return q, k, v


def wkv_operands(shape, dtype, seed, with_state, decays="mild"):
    """r, k, v in ``dtype``; float32 u and initial state; float32 decays,
    ``mild``: exp(-exp(-2 + noise)) as the model's initialisation gives them
    (|log w| about 0.14); ``strong``: exp(-exp(x)) with |log w| from 0.0025
    up to 20, a stretch of 20 tokens of w = 0 and one of 70 tokens of
    w = 1 - 1e-4."""
    b, t, h, hd = shape
    g = torch.Generator().manual_seed(seed)
    r, k, v = (torch.randn((b, t, h, hd), generator=g).to(dtype).to(DEVICE) for _ in range(3))
    if decays == "mild":
        w = torch.exp(-torch.exp(-2.0 + 0.5 * torch.randn((b, t, h, hd), generator=g)))
    else:
        x = torch.rand((b, t, h, hd), generator=g) * (math.log(20.0) + 6.0) - 6.0
        w = torch.exp(-torch.exp(x))
        w[:, t // 4:t // 4 + 20] = 0.0
        w[:, t // 2:t // 2 + 70] = 1.0 - 1e-4
    w = w.to(DEVICE)
    u = (0.1 * torch.randn((h, hd), generator=g)).to(DEVICE)
    state = torch.randn((b, h, hd, hd), generator=g).to(DEVICE) if with_state else None
    return r, k, v, w, u, state


def row_rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest error of one output row (a query of one head), its norm
    over the norm of that row of ``want``."""
    diff = (got.float() - want.float()).norm(dim=-1)
    return float((diff / want.float().norm(dim=-1).clamp_min(1e-30)).max())


def tile_fault_err(q, k, v, scale, window, want) -> float | None:
    """row_rel_err of a planted fault: the last 64 queries' P v skips the
    64-key tile before theirs (l still counts it), what a kernel that drops
    one KV tile for late rows would give.  None where the shape is too short
    or its window too narrow for that tile to count for every late row."""
    s_len = q.shape[1]
    if s_len < 512 or 0 < window < 128:
        return None
    last = (s_len - 1) // 64 * 64
    v_cut = v.clone()
    v_cut[:, last - 64:last] = 0
    fault = want.clone()
    fault[:, last:] = causal_attention_plain(q, k, v_cut, scale=scale, window=window)[:, last:]
    return row_rel_err(fault, want)


def check_flash(shapes, dtypes, against_f64: bool = False) -> float:
    """Kernel vs plain version, elementwise (FLASH_TOL) and per row
    (FLASH_ROW_TOL, which must also catch a planted one-tile fault on long
    shapes); returns the largest absolute error.  With ``against_f64``,
    also prints the kernel's and the plain version's row errors against
    the plain version in float64 (a reading, not a check)."""
    worst = 0.0
    for dtype in dtypes:
        for i, shape in enumerate(shapes):
            q, k, v = flash_operands(shape, dtype, seed=i)
            scale, window = shape[4] ** -0.5, shape[5]
            got = causal_attention(q, k, v, scale=scale, window=window)
            torch.cuda.synchronize()
            want = causal_attention_plain(q, k, v, scale=scale, window=window)
            err = float((got.float() - want.float()).abs().max())
            tol, row_tol = FLASH_TOL[dtype], FLASH_ROW_TOL[dtype]
            row_err = row_rel_err(got, want)
            fault_err = tile_fault_err(q, k, v, scale, window, want)
            ok = torch.allclose(got.float(), want.float(), rtol=tol, atol=tol) and row_err <= row_tol
            fault = "" if fault_err is None else f" one-tile fault={fault_err:.3e}"
            print(
                f"  flash_attention {str(dtype)[6:]} (B,S,H,KV,hd,window)={shape} {route(dtype, shape[4])}: "
                f"max_abs_err={err:.3e} tol={tol} row_rel_err={row_err:.3e} tol={row_tol}{fault} "
                f"{'ok' if ok else 'MISMATCH'}"
            )
            if not ok:
                raise AssertionError(f"flash_attention disagrees with its plain version at {shape} {dtype}")
            if fault_err is not None and fault_err <= row_tol:
                raise AssertionError(f"FLASH_ROW_TOL cannot see a one-tile fault at {shape} {dtype}: {fault_err:.3e}")
            if against_f64:
                exact = causal_attention_plain(q.double(), k.double(), v.double(), scale=scale, window=window)
                print(f"    against float64: kernel row_rel_err={row_rel_err(got, exact):.3e}; "
                      f"{str(dtype)[6:]} plain row_rel_err={row_rel_err(want, exact):.3e}")
                del exact
            worst = max(worst, err)
    return worst


def check_wkv6(shapes, dtypes, decays="mild") -> float:
    """Kernel vs plain version, from a zero and from a random state, output
    and final state, both finite; returns the largest absolute error."""
    worst = 0.0
    for dtype in dtypes:
        for i, shape in enumerate(shapes):
            for with_state in (False, True):
                args = wkv_operands(shape, dtype, seed=i, with_state=with_state, decays=decays)
                out, state = wkv6(*args)
                torch.cuda.synchronize()
                want_out, want_state = wkv6_plain(*args)
                err = max(float((out - want_out).abs().max()), float((state - want_state).abs().max()))
                finite = bool(torch.isfinite(out).all() and torch.isfinite(state).all())
                ok = finite and torch.allclose(out, want_out, rtol=WKV_TOL, atol=WKV_TOL) and torch.allclose(
                    state, want_state, rtol=WKV_TOL, atol=WKV_TOL
                )
                print(
                    f"  wkv6 r,k,v {str(dtype)[6:]} (B,T,H,hd)={shape} {wkv_route(dtype, shape[3])} {decays} decays, "
                    f"{'random' if with_state else 'zero'} state: max_abs_err={err:.3e} "
                    f"(|out| up to {float(want_out.abs().max()):.1f}) finite={finite} tol={WKV_TOL} {'ok' if ok else 'MISMATCH'}"
                )
                if not ok:
                    raise AssertionError(f"wkv6 disagrees with its plain version at {shape} {dtype} ({decays} decays)")
                worst = max(worst, err)
    return worst


@contextlib.contextmanager
def recording_kernel_calls(calls: Counter):
    """Count each (kernel, shape, dtype) the model path calls its wrappers
    with.  The wrappers themselves, and their launch counts, are unchanged."""
    flash, recur, scan = attention.causal_attention, rwkv.wkv6, scan_kernel.selective_scan

    def flash_rec(q, k, v, *, scale, window=0):
        calls["flash_attention", (*q.shape[:3], k.shape[2], q.shape[3], window), q.dtype] += 1
        return flash(q, k, v, scale=scale, window=window)

    def wkv_rec(r, k, v, w, u, state=None):
        calls["wkv6", tuple(r.shape), r.dtype] += 1
        return recur(r, k, v, w, u, state)

    def scan_rec(u, B_t, C_t, dt, A, h0):
        calls["selective_scan", (*u.shape, B_t.shape[-1]), u.dtype] += 1
        return scan(u, B_t, C_t, dt, A, h0)

    attention.causal_attention, rwkv.wkv6, scan_kernel.selective_scan = flash_rec, wkv_rec, scan_rec
    try:
        yield
    finally:
        attention.causal_attention, rwkv.wkv6, scan_kernel.selective_scan = flash, recur, scan


# Each kernel's launch count at the last zero_launches().
_LAUNCH_ZERO: dict[str, int] = {}


def _launches_now() -> dict[str, int]:
    return {k["name"]: tracing.counter(f"launches.{k['wrapper'].__name__}") for k in KERNELS}


def zero_launches() -> None:
    """Count each kernel's launches from here (``launch_counts``)."""
    _LAUNCH_ZERO.update(_launches_now())


def launch_counts() -> dict[str, int]:
    """Each kernel's launches since the last ``zero_launches``."""
    return {name: n - _LAUNCH_ZERO.get(name, 0) for name, n in _launches_now().items()}


def serve_prompts(cfg, params, batch, timed: bool):
    """prefill_step on ``batch``, then ZOO_DECODE decode_steps: greedy
    tokens, or for the audio frontend seeded random frame embeddings, as
    ``make_decode_token`` draws them (drawn before the clock starts).
    Returns (launches after prefill, launches after decode, all logits
    finite, prefill ms, decode ms per step); the times are CUDA events when
    ``timed``."""
    max_len = ZOO_PROMPT + ZOO_DECODE
    frames = [
        frontend.make_decode_token(cfg, ZOO_BATCH, seed=1000 + i, device=DEVICE)
        for i in range(ZOO_DECODE)
    ] if cfg.frontend == "audio" else None
    start, mid, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    torch.cuda.synchronize()
    start.record()
    logits, caches = tf.prefill_step(cfg, params, batch, max_len)
    mid.record()
    after_prefill = launch_counts()
    finite = torch.isfinite(logits).all()
    for i in range(ZOO_DECODE):
        nxt = frames[i] if frames else logits[:, -1].argmax(dim=-1, keepdim=True)
        logits, caches = tf.decode_step(cfg, params, caches, nxt, ZOO_PROMPT + i)
        finite &= torch.isfinite(logits).all()
    end.record()
    end.synchronize()
    prefill_ms = start.elapsed_time(mid) if timed else float("nan")
    decode_ms = mid.elapsed_time(end) / ZOO_DECODE if timed else float("nan")
    return after_prefill, launch_counts(), bool(finite), prefill_ms, decode_ms


# The program's spans (``repro_torch.tracing``) whose device time a
# profile reports: the MoE layer and the SSM scan.
RANGES = ("moe", "ssm.scan")


def span_device_ms(prof, spans) -> dict[str, tuple[int, float]]:
    """For each span name of RANGES among ``spans``: how many there were,
    and the device ms of the kernels launched while one was open on the
    host (a kernel's launch is the CUDA runtime call that the profiler
    gives its correlation id, recorded with or without the host's ops)."""
    import bisect

    from torch.autograd import DeviceType

    launched, kernels = {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                kernels.append((e.correlation_id(), e.duration_ns()))
        elif e.name().startswith("cu"):
            launched[e.correlation_id()] = e.start_ns()
    out = {}
    for name in RANGES:
        mine = sorted((s.start_ns, s.end_ns) for s in spans if s.name == name)
        merged: list[list[int]] = []
        for a, b in mine:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        starts = [a for a, _ in merged]
        total = 0
        for corr, ns in kernels:
            t = launched.get(corr)
            i = bisect.bisect_right(starts, t) - 1 if t is not None else -1
            if i >= 0 and t <= merged[i][1]:
                total += ns
        if mine:
            out[name] = (len(mine), total / 1e6)
    return out


def device_breakdown(label: str, fn, host_ops: bool = True) -> tuple[float, float, list, dict] | None:
    """Device time by kernel over one call of ``fn`` (torch.profiler), the
    share of the wall time in which the device was busy, and the device
    time of the kernels launched inside each of the program's spans that
    RANGES names (``span_device_ms``; the spans' own device-side
    annotations are not kernels).  The profiler's own host overhead
    lengthens the wall time, so that share is a lower bound.  With
    ``host_ops`` False the profiler records the device alone (and the
    runtime calls that launch it, so the spans still resolve): on a bf16
    production train step (some 10^5 host ops) that halves the profiler's
    cost, about 35 s a step.
    Returns (busy ms, wall ms, [(ms, count, kernel name)], {range: ms of
    the kernels inside it}), or None when the profiler saw no device
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host_ops else [ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    since = time.time_ns()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kernels = sorted(
        (
            (e.self_device_time_total / 1e3, e.count, e.key)
            for e in events
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation
        ),
        reverse=True,
    )
    busy = sum(t for t, _, _ in kernels)
    if busy <= 0:
        print(f"  {label}: the profiler saw no device time (busy share not measured)")
        return None
    print(
        f"  {label}: device busy {busy:.3f} ms of {wall_ms:.3f} ms wall under the profiler "
        f"({busy / wall_ms:.2%}); device time by kernel:"
    )
    for t, n, key in kernels[:8]:
        print(f"    {t:10.3f} ms {t / busy:8.2%}  x{n:<6} {key[:100]}")
    ranges = {}
    for name, (n, t) in span_device_ms(prof, [s for s in tracing.spans() if s.start_ns >= since]).items():
        ranges[name] = t
        print(f"    range {name} x{n}: kernels inside it {t:.3f} ms, {t / busy:.2%} of the device time")
    return busy, wall_ms, kernels, ranges


def phase_zoo_path(name: str, calls: Counter) -> dict[str, int]:
    """Serve ZOO_BATCH prompts of ZOO_PROMPT positions of ``name`` in
    bfloat16 at full width (at the depth ZOO gives); returns each kernel's
    launches in one prefill and decode."""
    cfg = ZOO[name]
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = tf.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(0), device=DEVICE)
    # Token ids; for the vision frontend its patch embeddings and the text
    # after them; for the audio frontend frame embeddings.
    batch = frontend.make_train_batch(cfg, ZOO_BATCH, ZOO_PROMPT, seed=1, device=DEVICE)
    del batch["labels"]
    depth = ARCHS[name].n_layers
    print(
        f"{name}: {tf.count_params(cfg) / 1e9:.3f} B parameters "
        + (f"({tf.count_params(cfg, active_only=True) / 1e9:.3f} B active a token) " if cfg.is_moe else "")
        + f"in bfloat16, {cfg.n_layers} layers"
        + (f" (cut from {depth})" if cfg.n_layers != depth else "")
        + f", init {time.perf_counter() - t0:.2f} s; prompt inputs "
        + ", ".join(f"{k} {tuple(v.shape)}" for k, v in batch.items())
    )
    zero_launches()
    with recording_kernel_calls(calls):
        after_prefill, after_decode, finite, _, _ = serve_prompts(cfg, params, batch, timed=False)
    want = {
        "block_matmul": 0,
        "flash_attention": cfg.n_layers if cfg.block in ("transformer", "hymba") else 0,
        "wkv6": cfg.n_layers if cfg.block == "rwkv6" else 0,
        "flash_attention_bwd": 0,
        "wkv6_bwd": 0,
        # prefill's chunked scan, one a layer; decode's sequential one launches nothing
        "selective_scan": cfg.n_layers if cfg.block == "hymba" else 0,
    }
    print(f"  launches: after prefill {after_prefill}, after {ZOO_DECODE} decode steps {after_decode}")
    assert after_prefill == after_decode == want, (after_prefill, after_decode, want)
    assert finite, f"{name}: non-finite logits"
    _, _, finite, prefill_ms, decode_ms = serve_prompts(cfg, params, batch, timed=True)
    assert finite, f"{name}: non-finite logits"
    peak = torch.cuda.max_memory_allocated() / 2**30
    max_len = ZOO_PROMPT + ZOO_DECODE
    device_breakdown("one prefill", lambda: tf.prefill_step(cfg, params, batch, max_len))
    logits, caches = tf.prefill_step(cfg, params, batch, max_len)
    nxt = (
        frontend.make_decode_token(cfg, ZOO_BATCH, seed=1000, device=DEVICE)
        if cfg.frontend == "audio" else logits[:, -1].argmax(dim=-1, keepdim=True)
    )

    def decode_steps():
        for i in range(ZOO_PROFILE_DECODE):
            tf.decode_step(cfg, params, caches, nxt, ZOO_PROMPT + i)

    device_breakdown(f"{ZOO_PROFILE_DECODE} decode steps", decode_steps)
    del logits, caches
    full = INPUT_SHAPES["prefill_32k"]
    print(
        f"  warm: prefill of {ZOO_BATCH} x {ZOO_PROMPT} positions {prefill_ms:.3f} ms, "
        f"decode {decode_ms:.3f} ms per step of {ZOO_BATCH} positions, all logits finite, "
        f"peak memory {peak:.2f} GiB (batch and length cut from {full.name}'s "
        f"{full.global_batch} x {full.seq_len}); {time.perf_counter() - t0:.2f} s"
    )
    del params, batch
    torch.cuda.empty_cache()
    return {k: v for k, v in after_decode.items() if v}


# One grok-1 MoE layer captured in a CUDA graph: a train microbatch's
# tokens and a decode step's, held against the eager call (bfloat16).
MOE_GRAPH_TOKENS = ((1, 4096), (ZOO_BATCH, 1))
MOE_GRAPH_TOL = 1e-2


def phase_moe_graph() -> dict:
    """grok-1-314b's ``moe_ffn`` at full width in bfloat16 (8 experts,
    top-2, its capacity factor), under ``no_grad`` as serving runs it,
    captured in a ``torch.cuda.CUDAGraph`` at each of MOE_GRAPH_TOKENS.
    Capture refuses a host sync, so a replay shows that the dispatch waits
    on nothing the host reads back.  The graph is replayed on the tokens it
    was captured with and on new ones copied into its input (other
    routing), each output and aux loss held against the eager call on the
    same tokens within MOE_GRAPH_TOL of its norm; returns, per size, the
    errors and the eager and replay times (CUDA events)."""
    cfg = ZOO["grok-1-314b"]
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    p = moe.moe_init(gen, cfg.d_model, cfg.d_ff, cfg.n_experts, torch.bfloat16, DEVICE)
    out = {}
    with torch.no_grad():
        for b, s in MOE_GRAPH_TOKENS:
            def tokens():
                return torch.randn((b, s, cfg.d_model), generator=gen, device=DEVICE).to(torch.bfloat16)

            x = tokens()

            def call():
                return moe.moe_ffn(x, p, k=cfg.experts_per_token, capacity_factor=cfg.capacity_factor,
                                   weight_gather=cfg.moe_weight_gather)

            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for _ in range(2):
                    call()
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                static = call()
            errs = []
            for i in range(2):
                if i:
                    x.copy_(tokens())
                graph.replay()
                want = call()
                errs.append(max(_rel(static.y, want.y), _rel(static.aux_loss, want.aux_loss)))
            eager_ms = time_ms(call, 10, 2)
            graph_ms = time_ms(graph.replay, 10, 2)
            key = f"{b} x {s}"
            out[key] = {"rel_err": errs, "eager_ms": eager_ms, "graph_ms": graph_ms}
            print(f"  moe_ffn {key} tokens, d_model {cfg.d_model}, {cfg.n_experts} experts, top-{cfg.experts_per_token}: "
                  f"CUDA graph captured; replay against eager, relative error {errs[0]:.3e} on the captured "
                  f"tokens, {errs[1]:.3e} on new ones (limit {MOE_GRAPH_TOL}); eager {eager_ms:.3f} ms, "
                  f"graph replay {graph_ms:.3f} ms a call; {card_line()}")
            if max(errs) > MOE_GRAPH_TOL:
                raise AssertionError(f"moe_ffn {key}: the CUDA graph's output disagrees with the eager call")
            del graph, static, want, x
    del p
    torch.cuda.empty_cache()
    return out


def phase_zoo_check(name: str) -> None:
    """float32 at full width (at ZOO_CHECK's depth): the full forward of T
    positions (kernels on every layer) against prefill_step of the patches
    and the first ZOO_CHECK_PREFILL tokens or frames plus teacher-forced
    decode_steps, which launch no hand kernel; logits within ZOO_CHECK_TOL
    and the same argmax at every position."""
    cfg, t_len = ZOO_CHECK[name]
    t0 = time.perf_counter()
    params = tf.init_params(
        cfg, torch.Generator(device=DEVICE).manual_seed(2), device=DEVICE, dtype=torch.float32
    )
    batch = frontend.make_train_batch(cfg, 1, t_len, seed=3, device=DEVICE)
    del batch["labels"]
    key = "frame_embeds" if cfg.frontend == "audio" else "tokens"
    seq = batch.pop(key)                               # the inputs decode takes one at a time
    n_patches = t_len - seq.shape[1]
    h, _ = tf.embed_inputs(cfg, params, {**batch, key: seq})
    full = tf.unembed(cfg, params, tf.backbone(cfg, params, h, remat=False)[0])[0]
    del h
    errs = torch.zeros(t_len, device=DEVICE)
    excess = torch.zeros(t_len, device=DEVICE)       # max(|a - b| - tol * |b|) per position
    agree = torch.zeros(t_len, dtype=torch.bool, device=DEVICE)
    gap = torch.zeros(t_len, device=DEVICE)          # top-2 gap of the full forward's logits

    def compare(t, logits):
        want = full[t]
        d = (logits - want).abs()
        errs[t] = d.max()
        excess[t] = (d - ZOO_CHECK_TOL * want.abs()).max()
        agree[t] = logits.argmax() == want.argmax()
        top2 = want.topk(2).values
        gap[t] = top2[0] - top2[1]

    first = ZOO_CHECK_PREFILL
    p = n_patches + first
    logits, caches = tf.prefill_step(cfg, params, {**batch, key: seq[:, :first]}, max_len=t_len)
    compare(p - 1, logits[0, 0])
    for j in range(first, seq.shape[1]):
        logits, caches = tf.decode_step(cfg, params, caches, seq[:, j : j + 1], n_patches + j)
        compare(n_patches + j, logits[0, 0])
    span = slice(p - 1, t_len)
    worst, worst_excess = float(errs[span].max()), float(excess[span].max())
    n_agree, n = int(agree[span].sum()), t_len - p + 1
    depth = ARCHS[name].n_layers
    notes = [f"{cfg.n_layers} of {depth} layers" if cfg.n_layers != depth else "full depth"]
    if n_patches:
        notes.append(f"{n_patches} patches first")
    if cfg.is_moe:
        notes.append(f"capacity factor {cfg.capacity_factor}: no group drops a token")
    if cfg.block == "hymba":
        notes.append(f"chunked scan {cfg.use_chunked_scan} in the forward and prefill, sequential in decode")
    print(
        f"{name} float32 ({'; '.join(notes)}), {t_len} positions: full forward vs prefill of {p} + "
        f"{t_len - p} decode steps: max_abs_err={worst:.3e} (|logit| up to {float(full.abs().max()):.2f}), "
        f"tol {ZOO_CHECK_TOL} abs + rel, argmax agrees at {n_agree}/{n} positions "
        f"(smallest top-2 gap {float(gap[span].min()):.3e}); {time.perf_counter() - t0:.2f} s"
    )
    if worst_excess > ZOO_CHECK_TOL or n_agree != n:
        raise AssertionError(f"{name}: prefill + decode disagrees with the full forward")
    del params, full, caches
    torch.cuda.empty_cache()


def scan_bound(b, s, d, n, dtype) -> float:
    """Least time (ms) of a selective scan: u and dt (``dtype``) and B_t and
    C_t read, y (float32) written, A and h0 read and the final state
    written, once each at the memory rate.  Its 4N + 8 float32 operations
    per (token, channel) take less at 67 TFLOP/s, so the bytes bound it."""
    size = torch.empty((), dtype=dtype).element_size()
    n_bytes = b * s * d * (2 * size + 4) + 2 * b * s * n * size + d * 4 + 2 * b * d * n * 4
    return n_bytes / HBM_BYTES_PER_S * 1e3


def phase_ssm_scans(calls: Counter) -> dict:
    """hymba-1.5b's SSM heads at full width on SCAN_LEN tokens, float32:
    ``ssm_forward`` with the sequential scan (decode's) against the chunked
    one (prefill's, which takes the ``selective_scan`` kernel); then the
    sequential scan alone against the kernel and the closed form (the
    train step's) from a random state at mild decays (softplus(dt) about
    0.05, so that the state lasts the whole run) and at strong ones (about
    6, far past the reference's chunked form's float32 limit), where both
    must stay finite.  Then, at (1, S, 3200, 16) for S in SCAN_TIME_LENS
    with bfloat16 inputs (the prefill path's), the kernel against the
    sequential scan and each one's time (CUDA events; the kernel also from
    a CUDA graph) beside the closed form's, the plain version's and the
    byte bound.  Last, at each shape and type the model-zoo path called the
    kernel with (``calls``), the kernel against the sequential scan from a
    random state at mild and strong decays, and its times at mild decays:
    the totals over one prefill (each shape times its calls) and the worst
    error there are the kernels line's numbers."""
    cfg = ARCHS["hymba-1.5b"]
    g = torch.Generator(device=DEVICE).manual_seed(4)
    p = ssm.ssm_init(g, cfg.d_model, cfg.ssm_inner, cfg.ssm_state, torch.float32, DEVICE)
    x = torch.randn((ZOO_BATCH, SCAN_LEN, cfg.d_model), generator=g, device=DEVICE)
    worst = 0.0

    def agree(label, seq, other) -> float:
        nonlocal worst
        pair = 0.0
        for a, b, what in zip(seq, other, ("y", "final state")):
            err = float((a - b).abs().max())
            finite = bool(torch.isfinite(b).all())
            ok = finite and torch.allclose(b, a, rtol=SCAN_TOL, atol=SCAN_TOL)
            print(f"  {label}, {what}: max_abs_err={err:.3e} (|seq| up to {float(a.abs().max()):.2f}) "
                  f"finite={finite} tol={SCAN_TOL} {'ok' if ok else 'MISMATCH'}")
            if not ok:
                raise AssertionError(f"hymba's scans disagree ({label})")
            pair = max(pair, err)
        worst = max(worst, pair)
        return pair

    agree(f"ssm_forward (B, S, D)={tuple(x.shape)}, kernel", ssm.ssm_forward(x, p), ssm.ssm_forward(x, p, chunked=True))
    a = torch.exp(p["A_log"])

    def scan_inputs(b, s, shift, dtype):
        u = torch.randn((b, s, cfg.ssm_inner), generator=g, device=DEVICE)
        bt, ct = (0.5 * torch.randn((b, s, cfg.ssm_state), generator=g, device=DEVICE) for _ in range(2))
        dt = shift + 0.5 * torch.randn((b, s, cfg.ssm_inner), generator=g, device=DEVICE)
        h0 = 0.5 * torch.randn((b, cfg.ssm_inner, cfg.ssm_state), generator=g, device=DEVICE)
        return tuple(t.to(dtype) for t in (u, bt, ct, dt)) + (a, h0)

    for shift in (-3.0, 6.0):
        args = scan_inputs(ZOO_BATCH, SCAN_LEN, shift, torch.float32)
        per_chunk = (F.softplus(args[3]) * a).reshape(ZOO_BATCH, -1, 32, cfg.ssm_inner).sum(2)
        label = (f"from a random state, a 32-token chunk summing {float(per_chunk.min()):.1f} to "
                 f"{float(per_chunk.max()):.1f} of -log a")
        seq = ssm.selective_scan(*args)
        agree(f"sequential vs kernel {label}", seq, scan_kernel.selective_scan(*args))
        agree(f"sequential vs closed form {label}", seq, ssm._closed_form(*args, 32))
    times = {}
    for s in SCAN_TIME_LENS:
        args = scan_inputs(1, s, -3.0, torch.bfloat16)
        agree(f"sequential vs kernel at (1, {s}, {cfg.ssm_inner}, {cfg.ssm_state}) bf16", ssm.selective_scan(*args),
              scan_kernel.selective_scan(*args))
        row = {
            "kernel_ms": time_ms(lambda: scan_kernel.selective_scan(*args), 50, warmup=5),
            "kernel_graph_ms": time_graph_ms(lambda: scan_kernel.selective_scan(*args)),
            "closed_form_ms": time_ms(lambda: ssm._closed_form(*args, 32), 5, warmup=1),
            "plain_ms": time_ms(lambda: selective_scan_plain(*args), 3, warmup=1),
            "sequential_ms": time_ms(lambda: ssm.selective_scan(*args), 1, warmup=1),
            "bound_ms": scan_bound(1, s, cfg.ssm_inner, cfg.ssm_state, torch.bfloat16),
            "segment_len": scan_kernel.segment_len(1, s, cfg.ssm_inner,
                                                   torch.cuda.get_device_properties(DEVICE).multi_processor_count),
        }
        print(f"  times at (B, S, d_inner, N)=(1, {s}, {cfg.ssm_inner}, {cfg.ssm_state}) bf16, ms a call "
              f"(CUDA events): kernel {row['kernel_ms']:.4f} eager / {row['kernel_graph_ms']:.4f} graph "
              f"(segments of {row['segment_len']}), bound {row['bound_ms']:.4f} (bytes; "
              f"{100 * row['bound_ms'] / row['kernel_graph_ms']:.1f}% graph), closed form "
              f"{row['closed_form_ms']:.3f}, plain {row['plain_ms']:.3f}, sequential {row['sequential_ms']:.3f}")
        times[s] = row
    path = Counter()
    path_worst = 0.0
    print("selective_scan at its model-zoo path's shapes (ms per call, CUDA events):")
    for (kname, key, dtype), n in calls.items():
        if kname != "selective_scan":
            continue
        b, s, d, n_state = key
        for shift in (6.0, -3.0):     # the times below at mild decays
            args = scan_inputs(b, s, shift, dtype)
            path_worst = max(path_worst, agree(
                f"sequential vs kernel at (B, S, d_inner, N)={key} {str(dtype)[6:]}, dt shift {shift}",
                ssm.selective_scan(*args), scan_kernel.selective_scan(*args)))
        t = {
            "ms": time_ms(lambda: scan_kernel.selective_scan(*args), 50, warmup=5),
            "graph_ms": time_graph_ms(lambda: scan_kernel.selective_scan(*args)),
            "plain_ms": time_ms(lambda: selective_scan_plain(*args), 3, warmup=1),
            "bound_ms": scan_bound(b, s, d, n_state, dtype),
        }
        print(f"  {str(dtype)[6:]} (B, S, d_inner, N)={key}, {n} calls per prefill: kernel={t['ms']:.6f} "
              f"graph={t['graph_ms']:.6f} plain={t['plain_ms']:.6f} library=none bound={t['bound_ms']:.6f} "
              f"(bytes) share={t['bound_ms'] / t['ms']:.4%} graph share={t['bound_ms'] / t['graph_ms']:.4%}")
        for k2, v in t.items():
            path[k2] += n * v
    assert path, "the model-zoo path called no selective_scan"
    prefill = {"ms": path["ms"], "plain_ms": path["plain_ms"], "bound_ms": path["bound_ms"], "bound_by": "bytes",
               "library_ms": None, "graph_ms": path["graph_ms"], "library_graph_ms": None}
    print("  one prefill: " + ", ".join(
        f"{k2}={v:.6f}" if isinstance(v, float) else f"{k2}={v}" for k2, v in prefill.items()))
    return {"max_abs_err": worst, "times": times, "path_max_abs_err": path_worst, "path_prefill": prefill}


def flash_bound(key, dtype, ops_per_s=None) -> tuple[float, str]:
    """Least time (ms): q, k, v read and out written once at the memory
    rate, or 4 * hd operations per unmasked (query, key) pair and head (the
    two products) at ``ops_per_s`` (by default the peak rate of the type),
    whichever is longer."""
    b, s, h, kv, hd, window = key
    size = torch.empty((), dtype=dtype).element_size()
    t_bytes = (2 * b * s * h * hd + 2 * b * s * kv * hd) * size / HBM_BYTES_PER_S * 1e3
    w = window if window > 0 else s
    pairs = sum(min(i + 1, w) for i in range(s))
    t_ops = 4.0 * hd * pairs * b * h / (ops_per_s or PEAK_OPS_PER_S[dtype]) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def wkv_bound(key, dtype) -> tuple[float, str]:
    """Least time (ms): r, k, v (``dtype``), w, u, the initial state read
    and out and the final state (float32) written once at the memory rate,
    or 5 * hd^2 operations per token and head (r^T S, k v^T, diag(w) S + kv)
    at the peak rate of r, k, v's type, whichever is longer."""
    b, t, h, hd = key
    size = torch.empty((), dtype=dtype).element_size()
    n = b * t * h * hd
    t_bytes = (3 * n * size + n * 4 + h * hd * 4 + 2 * b * h * hd * hd * 4 + n * 4) / HBM_BYTES_PER_S * 1e3
    t_ops = 5.0 * hd * hd * b * t * h / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sdpa_call(q, k, v, scale, window):
    """The library yardstick: one F.scaled_dot_product_attention call on the
    same inputs (heads-first views, GQA by enable_gqa; the causal flag for
    global layers, a boolean mask, made once, for windowed ones)."""
    qh, kh, vh = (a.transpose(1, 2) for a in (q, k, v))
    if window <= 0:
        return lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=True, scale=scale, enable_gqa=True)
    pos = torch.arange(q.shape[1], device=q.device)
    mask = (pos[None, :] <= pos[:, None]) & (pos[:, None] - pos[None, :] < window)
    return lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask, scale=scale, enable_gqa=True)


def phase_zoo_times(calls: Counter) -> dict[str, dict]:
    """Times of flash_attention and wkv6 at each shape their path called
    them with; the totals over one prefill (each shape times its calls) are
    the kernels line's numbers."""
    totals = {}
    for name in ("flash_attention", "wkv6"):
        rows = [(key, dtype, n) for (kname, key, dtype), n in calls.items() if kname == name]
        tot = Counter()
        by_bytes = 0.0
        print(f"times of {name} (ms per call, CUDA events) at its model-zoo path's shapes:")
        for key, dtype, n in rows:
            if name == "flash_attention":
                q, k, v = flash_operands(key, dtype, seed=0)
                scale, window = key[4] ** -0.5, key[5]
                fn = lambda: causal_attention(q, k, v, scale=scale, window=window)  # noqa: E731
                plain = lambda: causal_attention_plain(q, k, v, scale=scale, window=window)  # noqa: E731
                lib = sdpa_call(q, k, v, scale, window)
                lib_err = float((lib().transpose(1, 2).float() - fn().float()).abs().max())
                bound_ms, bound_by = flash_bound(key, dtype)
                label = f"(B,S,H,KV,hd,window)={key}"
            else:
                args = wkv_operands(key, dtype, seed=0, with_state=False)
                fn = lambda: wkv6(*args)  # noqa: E731
                plain = lambda: wkv6_plain(*args)  # noqa: E731
                lib = None
                bound_ms, bound_by = wkv_bound(key, dtype)
                label = f"(B,T,H,hd)={key} {wkv_route(dtype, key[3])}"
            t = {
                "ms": time_ms(fn, 20),
                "graph_ms": time_graph_ms(fn, calls=10, replays=5),
                "plain_ms": time_ms(plain, 2, warmup=1),
                "library_ms": time_ms(lib, 20) if lib else None,
                "library_graph_ms": time_graph_ms(lib, calls=10, replays=5) if lib else None,
                "bound_ms": bound_ms,
            }
            print(
                f"  {str(dtype)[6:]} {label}, {n} calls per prefill: kernel={t['ms']:.6f} "
                f"graph={t['graph_ms']:.6f} plain={t['plain_ms']:.6f} "
                + (f"sdpa={t['library_ms']:.6f} sdpa_graph={t['library_graph_ms']:.6f} "
                   f"(max |sdpa - kernel| {lib_err:.3e}) " if lib else "library=none ")
                + f"bound={bound_ms:.6f} ({bound_by}) share={bound_ms / t['ms']:.4%} "
                f"graph share={bound_ms / t['graph_ms']:.4%}"
            )
            for key2, val in t.items():
                if val is not None:
                    tot[key2] += n * val
            if bound_by == "bytes":
                by_bytes += n * bound_ms
        out = {
            "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": "bytes" if by_bytes >= tot["bound_ms"] / 2 else "operations",
            "library_ms": tot["library_ms"] if name == "flash_attention" else None,
            "graph_ms": tot["graph_ms"],
            "library_graph_ms": tot["library_graph_ms"] if name == "flash_attention" else None,
        }
        print(f"  one prefill ({sum(n for _, _, n in rows)} calls): " + ", ".join(
            f"{k2}={v2:.6f}" if isinstance(v2, float) else f"{k2}={v2}" for k2, v2 in out.items()
        ))
        totals[name] = out
    return totals


# --------------------------------------------------------------------------
# Training on the card: flash_attention's backward kernel, then microbatched
# float32 train steps of qwen1.5-0.5b and gemma3-1b at full width and depth
# --------------------------------------------------------------------------
# rwkv6-7b at RWKV_TRAIN_LAYERS of its 32 layers: its float32 training
# state is 16 bytes a parameter, and the step holds about seven float32
# copies of the parameters at the optimizer update (parameters, two
# moments, the accumulated and the new gradient, new parameters and
# moments), so 8 layers (2.29 B parameters) take about 60 GiB of 80.
RWKV_TRAIN_LAYERS = 8
TRAIN = {"qwen1.5-0.5b": ARCHS["qwen1.5-0.5b"], "gemma3-1b": ARCHS["gemma3-1b"],
         "rwkv6-7b": dataclasses.replace(ARCHS["rwkv6-7b"], n_layers=RWKV_TRAIN_LAYERS)}
# Cut from INPUT_SHAPES["train_4k"] (a global batch of 256 x 4096): 8 x 2048
# positions a step, in 4 microbatches of 2 x 2048; one warm step, then
# TRAIN_TIMED timed ones and one under the profiler.
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO, TRAIN_TIMED = 8, 2048, 4, 3
TRAIN_LR = 3e-4
# The backward kernel against its plain version, per row (one position of
# one head of dq, dk or dv): the row's error norm over the plain row's norm,
# that norm floored at GRAD_ROW_FLOOR times the RMS row norm of the three
# plain gradients together.  A row whose attention is peaked has
# ds = p (dp - delta) with dp ~ delta, two float32 sums of the same
# products taken in different orders: its dq is near 0 (exactly 0 for the
# first query, and all of dq and dk at S = 1) while its rounding is not
# (2.4e-4 of a floor of 1e-2 of dq's own RMS at (2, 2048, 32, 32, 96) on
# the card).  The limits are FLASH_ROW_TOL's, and a planted fault (one key
# tile's dk missing one query tile, dk_tile_fault) must exceed them.
GRAD_ROW_TOL = FLASH_ROW_TOL
GRAD_ROW_FLOOR = 0.1
# GQA 8 beside FLASH_TEST_SHAPES' and FLASH_RAGGED_SHAPES' groups of 1, 2
# and 4 (hd 16, 32, 128; windows 0, 16 and S - 1).
BWD_GROUP8_SHAPES = [(1, 100, 8, 1, 128, 0), (2, 77, 8, 1, 32, 16), (1, 300, 8, 1, 16, 299)]
# The train path's calls (B, S, H, KV, hd, window), float32.
TRAIN_BWD_SHAPES = [(2, 2048, 16, 16, 64, 0), (2, 2048, 4, 1, 256, 512), (2, 2048, 4, 1, 256, 0)]
# Train correctness at full width and 2 layers: kernels vs plain versions
# (every gradient leaf within TRAIN_GRAD_TOL of its norm; batch 2 x 2048),
# 4 microbatches vs 1 (tests/test_training.py's tolerances; batch 8 x 512,
# so that one microbatch's float32 logits stay near 2.5 GB), and the loss
# falling by LOSS_FALL over LOSS_STEPS steps (test_loss_decreases_qwen_reduced).
TRAIN_CHECK_LAYERS, TRAIN_GRAD_TOL = 2, 1e-4
# rwkv6-7b's plain reference is a Python loop over positions (9 s a call
# at 2 x 2048 eagerly, PERF.md), differentiated by autograd: 2 x 256.
TRAIN_CHECK_SEQ = {"rwkv6-7b": 256}
MICRO_CHECK_BATCH, MICRO_CHECK_SEQ = 8, 512
# AdamW's first step moves each parameter by lr * g / (|g| + eps), about
# lr * sign(g): where |g| is within rounding of 0 the two accumulation
# orders may give it opposite signs and a move of 2 lr, past atol.  A
# parameter may leave the test's tolerance only there: where the
# 1-microbatch gradient is below MICRO_SIGN_TOL of its leaf's RMS (the two
# orders differ by about 1e-6 of it), and at most MICRO_SIGN_SHARE of all.
MICRO_SIGN_TOL, MICRO_SIGN_SHARE = 1e-4, 1e-5
LOSS_STEPS, LOSS_BATCH, LOSS_SEQ, LOSS_LR, LOSS_FALL = 30, 8, 128, 3e-3, 0.5
BWD_PRODUCT_KERNELS = ("stats_kernel", "dkdv_kernel", "dq_kernel")   # flash_attention_bwd.cu
BWD_KERNEL_NAMES = BWD_PRODUCT_KERNELS + ("dkdv_reduce_kernel",)
WKV_BWD_PRODUCT_KERNELS = ("sums_kernel", "grads_kernel")   # wkv6_bwd.cu
WKV_BWD_KERNEL_NAMES = WKV_BWD_PRODUCT_KERNELS + ("scan_kernel",)
# Each train path's forward and backward kernels, as the profiler names
# them (demangled), by the block its layers run.
TRAIN_KERNELS = {
    "transformer": ("flash_attention", r"flash_kernel", "flash_attention_bwd", "|".join(BWD_KERNEL_NAMES)),
    "hymba": ("flash_attention", r"flash_kernel", "flash_attention_bwd", "|".join(BWD_KERNEL_NAMES)),
    "rwkv6": ("wkv6", r"\b(wkv6|chunk)_kernel\b", "wkv6_bwd", r"\b(sums|scan|grads)_kernel\b"),
}


def grad_row_floor(want) -> float:
    """GRAD_ROW_FLOOR times the RMS row norm of the gradients ``want``."""
    sq = [g.float().norm(dim=-1).square() for g in want]
    return float(GRAD_ROW_FLOOR * (sum(x.sum() for x in sq) / sum(x.numel() for x in sq)).sqrt())


def grad_row_err(got: torch.Tensor, want: torch.Tensor, floor: float) -> float:
    """The largest error of one gradient row over that row's norm in
    ``want``, floored at ``floor``."""
    diff = (got.float() - want.float()).norm(dim=-1)
    return float((diff / want.float().norm(dim=-1).clamp_min(max(floor, 1e-30))).max())


def dk_tile_fault(q, k, v, o, do, scale, window, want_dk, floor) -> float | None:
    """grad_row_err of a planted fault: the first 64 keys' dk misses the
    queries 64..127, what a kernel that skips one query tile of a key tile
    would give.  None where the shape is too short."""
    if q.shape[1] < 512:
        return None
    do_cut = do.clone()
    do_cut[:, 64:128] = 0
    _, dk_cut, _ = causal_attention_bwd_plain(q, k, v, o, do_cut, scale=scale, window=window)
    fault = want_dk.clone()
    fault[:, :64] = dk_cut[:, :64]
    return grad_row_err(fault, want_dk, floor)


def check_flash_bwd(shapes, dtypes, against_f64: bool = False) -> float:
    """The backward kernel against causal_attention_bwd_plain on the same
    q, k, v, forward output and output gradient: every dq, dk and dv row
    within GRAD_ROW_TOL, all finite, a second call bitwise equal to the
    first, and a planted one-tile fault in dk past the limit on long
    shapes; returns the largest absolute error.  With ``against_f64``, also
    prints the kernel's and the plain version's row errors against the
    plain version in float64 (a reading, not a check)."""
    worst = 0.0
    for dtype in dtypes:
        for i, shape in enumerate(shapes):
            q, k, v = flash_operands(shape, dtype, seed=i)
            do = torch.randn(q.shape, generator=torch.Generator().manual_seed(100 + i)).to(dtype).to(DEVICE)
            scale, window = shape[4] ** -0.5, shape[5]
            o = causal_attention(q, k, v, scale=scale, window=window)
            got = causal_attention_bwd(q, k, v, o, do, scale=scale, window=window)
            again = causal_attention_bwd(q, k, v, o, do, scale=scale, window=window)
            torch.cuda.synchronize()
            bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
            want = causal_attention_bwd_plain(q, k, v, o, do, scale=scale, window=window)
            floor = grad_row_floor(want)
            errs = [grad_row_err(a, b, floor) for a, b in zip(got, want)]
            abs_err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, want))
            finite = all(bool(torch.isfinite(a).all()) for a in got)
            fault_err = dk_tile_fault(q, k, v, o, do, scale, window, want[1], floor)
            tol = GRAD_ROW_TOL[dtype]
            ok = finite and bitwise and max(errs) <= tol
            fault = "" if fault_err is None else f" one-tile fault in dk={fault_err:.3e}"
            print(
                f"  flash_attention_bwd {str(dtype)[6:]} (B,S,H,KV,hd,window)={shape} {bwd_route(dtype, shape[4])}: "
                f"row_rel_err "
                f"dq={errs[0]:.3e} dk={errs[1]:.3e} dv={errs[2]:.3e} tol={tol} max_abs_err={abs_err:.3e} "
                f"finite={finite} bitwise_repeat={bitwise}{fault} {'ok' if ok else 'MISMATCH'}"
            )
            if not ok:
                raise AssertionError(f"flash_attention_bwd disagrees with its plain version at {shape} {dtype}")
            if fault_err is not None and fault_err <= tol:
                raise AssertionError(f"GRAD_ROW_TOL cannot see a one-tile fault at {shape} {dtype}: {fault_err:.3e}")
            if against_f64:
                exact = causal_attention_bwd_plain(*(a.double() for a in (q, k, v, o, do)), scale=scale, window=window)
                floor64 = grad_row_floor(exact)
                kern = [grad_row_err(a, b, floor64) for a, b in zip(got, exact)]
                plain = [grad_row_err(a, b, floor64) for a, b in zip(want, exact)]
                print(f"    against float64: kernel dq={kern[0]:.3e} dk={kern[1]:.3e} dv={kern[2]:.3e}; "
                      f"float32 plain dq={plain[0]:.3e} dk={plain[1]:.3e} dv={plain[2]:.3e}")
                del exact
            worst = max(worst, abs_err)
            del got, again, want
    return worst


# wkv6's backward kernels against wkv6_bwd_plain: rwkv6-7b's train shape
# (B, T, H, hd), float32 on its path and bfloat16 beside it.
WKV_TRAIN_SHAPE = (2, TRAIN_SEQ, 64, 64)


def wkv_grad_operands(shape, dtype, seed, with_state, decays):
    """wkv_operands plus a float32 output gradient and, with a state, a
    final-state gradient."""
    r, k, v, w, u, state = wkv_operands(shape, dtype, seed, with_state, decays)
    g = torch.Generator().manual_seed(100 + seed)
    dout = torch.randn(shape, generator=g).to(DEVICE)
    dfinal = torch.randn(state.shape, generator=g).to(DEVICE) if with_state else None
    return r, k, v, w, u, state, dout, dfinal


def wkv_chunk_fault(args, want_dk, floor) -> float | None:
    """grad_row_err of a planted fault: the first chunk's dk misses the
    state gradient that the second chunk's tokens put in (BWD_CHUNK tokens
    each), what a scan that skips one chunk's summary of r dout^T would
    give.  None where T is too short."""
    n = wkv6_mod.BWD_CHUNK
    if args[0].shape[1] < 2 * n:
        return None
    dout_cut = args[6].clone()
    dout_cut[:, n:2 * n] = 0
    dk_cut = wkv6_bwd_plain(*args[:6], dout_cut, args[7])[1]
    fault = want_dk.clone()
    fault[:, :n] = dk_cut[:, :n]
    return grad_row_err(fault, want_dk, floor)


def check_wkv6_bwd(shapes, dtypes, decays="mild", against_f64: bool = False) -> float:
    """The backward kernels against wkv6_bwd_plain on the same inputs, from
    a zero state and from a random one with a final-state gradient: every
    dr, dk, dv and dw row within GRAD_ROW_TOL (floored at GRAD_ROW_FLOOR of
    their RMS row norm), du and d(state) per row likewise, all finite, a
    second call bitwise equal to the first, and a planted one-chunk fault in
    dk past the limit on long shapes; returns the largest absolute error.
    With ``against_f64``, also prints the kernels' and the plain version's
    row errors against the plain version in float64 (a reading)."""
    worst = 0.0
    names = ("dr", "dk", "dv", "dw", "du", "dstate")
    for dtype in dtypes:
        for i, shape in enumerate(shapes):
            for with_state in (False, True):
                args = wkv_grad_operands(shape, dtype, i, with_state, decays)
                got = wkv6_bwd(*args)
                again = wkv6_bwd(*args)
                torch.cuda.synchronize()
                bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
                want = wkv6_bwd_plain(*args)
                floor = grad_row_floor(want[:4])
                errs = [grad_row_err(a, b, floor) for a, b in zip(got[:4], want[:4])]
                errs += [grad_row_err(a, b, grad_row_floor([b])) for a, b in zip(got[4:], want[4:])]
                abs_err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, want))
                finite = all(bool(torch.isfinite(a).all()) for a in got)
                fault_err = wkv_chunk_fault(args, want[1], floor)
                tol = GRAD_ROW_TOL[dtype]
                ok = finite and bitwise and max(errs) <= tol
                fault = "" if fault_err is None else f" one-chunk fault in dk={fault_err:.3e}"
                print(
                    f"  wkv6_bwd r,k,v {str(dtype)[6:]} (B,T,H,hd)={shape} {decays} decays, "
                    f"{'random state, dfinal' if with_state else 'zero state'}: row_rel_err "
                    + " ".join(f"{n}={e:.3e}" for n, e in zip(names, errs))
                    + f" tol={tol} max_abs_err={abs_err:.3e} finite={finite} bitwise_repeat={bitwise}{fault} "
                    f"{'ok' if ok else 'MISMATCH'}"
                )
                if not ok:
                    raise AssertionError(f"wkv6_bwd disagrees with its plain version at {shape} {dtype} ({decays})")
                if fault_err is not None and fault_err <= tol:
                    raise AssertionError(f"GRAD_ROW_TOL cannot see a one-chunk fault at {shape} {dtype}: {fault_err:.3e}")
                if against_f64:
                    exact = wkv6_bwd_plain(*(None if a is None else a.double() for a in args))
                    floor64 = grad_row_floor(exact[:4])
                    kern = [grad_row_err(a, b, floor64) for a, b in zip(got[:4], exact[:4])]
                    plain = [grad_row_err(a, b, floor64) for a, b in zip(want[:4], exact[:4])]
                    print("    against float64: kernel " + " ".join(f"{n}={e:.3e}" for n, e in zip(names, kern))
                          + f"; {str(dtype)[6:]} plain " + " ".join(f"{n}={e:.3e}" for n, e in zip(names, plain)))
                    del exact
                worst = max(worst, abs_err)
                del got, again, want
    return worst


WKV_FWD_CHUNK = 64   # tokens a chunk of wkv6's chunk route (CL in wkv6.cu)


def check_wkv6_rows(shape, decays, dtype=torch.float32) -> float:
    """The forward with r, k, v in ``dtype`` at ``shape`` against its
    plain version per row of out and of the final state, from a zero and
    from a random state: each row's error over its norm, floored at
    GRAD_ROW_FLOOR of the RMS row norm, within GRAD_ROW_TOL, all finite; a
    planted one-chunk fault (the third chunk's outputs and the final state
    as if the second and the last chunk's k v^T never reached the state)
    must exceed that limit.  Also prints the kernel's and the plain
    version's (float32 arithmetic) row errors against the plain version in
    float64 (a reading).  Returns the largest absolute error."""
    n, tol, worst = WKV_FWD_CHUNK, GRAD_ROW_TOL[dtype], 0.0
    if shape[1] < 4 * n:
        raise ValueError(f"the one-chunk fault needs T >= {4 * n}, got {shape}")
    for i, with_state in enumerate((False, True)):
        args = wkv_operands(shape, dtype, seed=i, with_state=with_state, decays=decays)
        got = wkv6(*args)
        torch.cuda.synchronize()
        want = wkv6_plain(*args)
        floors = [grad_row_floor([x]) for x in want]
        errs = [grad_row_err(a, b, f) for a, b, f in zip(got, want, floors)]
        abs_err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        finite = all(bool(torch.isfinite(a).all()) for a in got)
        v_cut = args[2].clone()
        v_cut[:, n:2 * n] = 0
        v_cut[:, -n:] = 0
        cut_out, cut_state = wkv6_plain(*args[:2], v_cut, *args[3:])
        fault_out = want[0].clone()
        fault_out[:, 2 * n:3 * n] = cut_out[:, 2 * n:3 * n]
        fault = [grad_row_err(fault_out, want[0], floors[0]), grad_row_err(cut_state, want[1], floors[1])]
        exact = wkv6_plain(*(None if a is None else a.double() for a in args))
        floors64 = [grad_row_floor([x]) for x in exact]
        kern = [grad_row_err(a, b, f) for a, b, f in zip(got, exact, floors64)]
        plain = [grad_row_err(a, b, f) for a, b, f in zip(want, exact, floors64)]
        ok = finite and max(errs) <= tol
        print(
            f"  wkv6 r,k,v {str(dtype)[6:]} (B,T,H,hd)={shape} {wkv_route(dtype, shape[3])} {decays} decays, "
            f"{'random' if with_state else 'zero'} state: row_rel_err out={errs[0]:.3e} state={errs[1]:.3e} "
            f"tol={tol} max_abs_err={abs_err:.3e} finite={finite} one-chunk fault out={fault[0]:.3e} "
            f"state={fault[1]:.3e} {'ok' if ok else 'MISMATCH'}\n"
            f"    against float64: kernel out={kern[0]:.3e} state={kern[1]:.3e}; "
            f"float32 plain out={plain[0]:.3e} state={plain[1]:.3e}"
        )
        if not ok:
            raise AssertionError(f"wkv6 rows disagree with its plain version at {shape} ({decays} decays)")
        if min(fault) <= tol:
            raise AssertionError(f"GRAD_ROW_TOL cannot see a one-chunk wkv6 fault at {shape}: {fault}")
        worst = max(worst, abs_err)
        del got, want, exact, cut_out, cut_state, fault_out
    return worst


def phase_wkv6_bwd_resources() -> dict:
    """The wkv6 backward library's kernels: registers and spills from ptxas
    (no spills; each product kernel for each type pair and head_dim, and
    the scan) and the product kernels' dynamic shared memory at every
    head_dim, from the library itself (within the 227 KB a block may
    take)."""
    res, spilled = printed_resources("wkv6_bwd")
    want = len(WKV_BWD_PRODUCT_KERNELS) * 4 * len(wkv6_mod.HEAD_DIMS) + 1
    if len(res) != want or spilled:
        raise AssertionError(f"wkv6_bwd: {len(res)} kernels in the ptxas report (want {want}), spills in {spilled}")
    fn = build.load("wkv6_bwd").wkv6_bwd_smem
    fn.argtypes, fn.restype = [ctypes.c_int] * 2, ctypes.c_int
    smem = {f"{name} hd {hd}": fn(hd, i) for i, name in enumerate(WKV_BWD_PRODUCT_KERNELS)
            for hd in wkv6_mod.HEAD_DIMS}
    print(f"  dynamic shared memory (bytes): {smem}")
    if max(smem.values()) > SMEM_PER_BLOCK or min(smem.values()) <= 0:
        raise AssertionError(f"wkv6_bwd's shared memory outside (0, {SMEM_PER_BLOCK}]: {smem}")
    short = {}
    for mangled, (regs, _) in res.items():
        m = re.search(rf"\d+({'|'.join(WKV_BWD_KERNEL_NAMES)})I(f|13__nv_bfloat16)(f|13__nv_bfloat16|S\d*_)Li(\d+)E",
                      mangled)
        if m:
            tr = "float" if m.group(2) == "f" else "bfloat16"
            tw = {"f": "float", "13__nv_bfloat16": "bfloat16"}.get(m.group(3), tr)
            short[f"{m.group(1)}<{tr},{tw},{m.group(4)}>"] = regs
        else:
            short[re.sub(r".*\d(scan_kernel).*", r"\1", mangled)] = regs
    return {"registers": short, "smem_bytes": smem}


# HMMA instructions in each instantiation of wkv6_bwd's product kernels, by
# kernel, r, k, v's type and head_dim (w's type does not change them).
WKV_BWD_HMMA = {
    "sums_kernel": {"float": {8: 24, 16: 24, 32: 24, 64: 24}, "bfloat16": {8: 20, 16: 20, 32: 20, 64: 20}},
    "grads_kernel": {"float": {8: 114, 16: 138, 32: 150, 64: 150}, "bfloat16": {8: 111, 16: 132, 32: 142, 64: 142}},
}


def wkv_bwd_hmma_pins() -> dict[str, int]:
    """WKV_BWD_HMMA as patterns of the mangled names, each matching the two
    instantiations of one (kernel, type, head_dim), for phase_tensor_cores."""
    tr = {"float": "f(f|13__nv_bfloat16)", "bfloat16": "13__nv_bfloat16(f|S1_)"}
    return {rf"{len(name)}{name}I{tr[dt]}Li{hd}E": n
            for name, by_type in WKV_BWD_HMMA.items() for dt, by_hd in by_type.items() for hd, n in by_hd.items()}


@contextlib.contextmanager
def recording_bwd_calls(calls: Counter):
    """Count each (kernel, shape, dtype) the backward pass calls the
    backward wrappers with (``_FlashAttention.backward`` and
    ``_WKV6.backward`` look them up in their modules at every call).  The
    wrappers, and their launch counts, are unchanged."""
    flash, recur = fa_mod.causal_attention_bwd, wkv6_mod.wkv6_bwd

    def flash_rec(q, k, v, o, do, *, scale, window=0):
        calls["flash_attention_bwd", (*q.shape[:3], k.shape[2], q.shape[3], window), q.dtype] += 1
        return flash(q, k, v, o, do, scale=scale, window=window)

    def wkv_rec(r, k, v, w, u, state, dout, dfinal=None):
        calls["wkv6_bwd", tuple(r.shape), r.dtype] += 1
        return recur(r, k, v, w, u, state, dout, dfinal)

    fa_mod.causal_attention_bwd, wkv6_mod.wkv6_bwd = flash_rec, wkv_rec
    try:
        yield
    finally:
        fa_mod.causal_attention_bwd, wkv6_mod.wkv6_bwd = flash, recur


@contextlib.contextmanager
def plain_kernels():
    """The model's attention and time mix through causal_attention_plain and
    wkv6_plain, which autograd differentiates: the check's own reference,
    off the port's path."""
    flash, recur = attention.causal_attention, rwkv.wkv6
    attention.causal_attention, rwkv.wkv6 = causal_attention_plain, wkv6_plain
    try:
        yield
    finally:
        attention.causal_attention, rwkv.wkv6 = flash, recur


# Leaves that no loss reads: the audio frontend embeds frames and never
# reads the token table (tests/test_torch_forward_loss.py excepts it too).
UNREAD_LEAVES = {"musicgen-large": ("['embed']",)}


def param_grads(cfg, params, batch) -> tuple[float, list[tuple[str, torch.Tensor]]]:
    """forward_loss and the gradient of every parameter leaf that the loss
    reads; raises if any other leaf (UNREAD_LEAVES) gets none, or one of
    those gets one."""
    flat = leaves_with_paths(params)
    live = [p.detach().requires_grad_(True) for _, p in flat]
    loss, _ = tf.forward_loss(cfg, tree_unflatten(params, live), batch)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    unread = [path for (path, _), g in zip(flat, grads) if g is None]
    if unread != list(UNREAD_LEAVES.get(cfg.name, ())):
        raise AssertionError(f"{cfg.name}: leaves without a gradient {unread}, "
                             f"expected {list(UNREAD_LEAVES.get(cfg.name, ()))}")
    return float(loss.detach()), [(path, g) for (path, _), g in zip(flat, grads) if g is not None]


def phase_train_path(name: str, calls: Counter) -> dict:
    """Microbatched float32 train steps of ``name`` at full width and depth
    on SyntheticTokens; returns the path's launches and the step's
    readings."""
    cfg = TRAIN[name]
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = tf.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(0), device=DEVICE, dtype=torch.float32)
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=TRAIN_LR), n_microbatches=TRAIN_MICRO)
    opt = adamw_init(params, tcfg.optimizer)
    step = make_train_step(cfg, tcfg)
    data = batches_for_arch(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0, device=DEVICE)
    batches = [next(data) for _ in range(TRAIN_TIMED + 2)]
    full = INPUT_SHAPES["train_4k"]
    depth = ARCHS[name].n_layers
    print(
        f"{name}: {tf.count_params(cfg) / 1e9:.3f} B parameters in float32, "
        f"{cfg.n_layers} layers ({'full depth' if cfg.n_layers == depth else f'cut from {depth}'}), "
        f"init {time.perf_counter() - t0:.2f} s; {TRAIN_MICRO} microbatches of {TRAIN_BATCH // TRAIN_MICRO} x "
        f"{TRAIN_SEQ} a step (cut from {full.name}'s {full.global_batch} x {full.seq_len})"
    )
    micro = {k: a[: TRAIN_BATCH // TRAIN_MICRO] for k, a in batches[0].items()}
    loss, grads = param_grads(cfg, params, micro)
    bad = [path for path, g in grads if not (bool(torch.isfinite(g).all()) and bool(g.abs().max() > 0))]
    print(f"  gradient of forward_loss on one microbatch: loss {loss:.4f}, {len(grads)} leaves, "
          f"{len(grads) - len(bad)} finite and non-zero")
    if bad or not math.isfinite(loss):
        raise AssertionError(f"{name}: leaves without a finite, non-zero gradient: {bad[:8]}")
    del grads

    zero_launches()
    step_ms = []
    with recording_kernel_calls(calls), recording_bwd_calls(calls):
        for i, batch in enumerate(batches[: TRAIN_TIMED + 1]):
            torch.cuda.synchronize()
            t = time.perf_counter()
            params, opt, metrics = step(params, opt, batch, 1.0)
            loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
            if i:
                step_ms.append((time.perf_counter() - t) * 1e3)
            print(f"  step {i}{' (warm)' if i == 0 else ''}: loss {loss:.4f} grad_norm {gnorm:.4f}")
            if not (math.isfinite(loss) and math.isfinite(gnorm)):
                raise AssertionError(f"{name}: non-finite loss or grad_norm at step {i}")
    launches = launch_counts()
    steps = TRAIN_TIMED + 1
    fwd_name, fwd_re, bwd_name, bwd_re = TRAIN_KERNELS[cfg.block]
    want = {k["name"]: 0 for k in KERNELS}
    want[fwd_name] = 2 * cfg.n_layers * TRAIN_MICRO * steps
    want[bwd_name] = cfg.n_layers * TRAIN_MICRO * steps
    print(f"  launches over {steps} steps: {launches} (want {want}: two forwards a layer and microbatch under remat)")
    assert launches == want, (launches, want)
    peak = torch.cuda.max_memory_allocated() / 2**30
    med = float(np.median(step_ms))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    reading = device_breakdown("one train step", lambda: step(params, opt, batches[-1], 1.0))
    bwd_share, bwd_kernel_ms = None, {}
    if reading is not None:
        busy, wall, kernels, _ = reading
        bwd = sum(t for t, _, key in kernels if re.search(bwd_re, key))
        fwd = sum(t for t, _, key in kernels if re.search(fwd_re, key))
        bwd_share = bwd / busy
        print(f"    {bwd_name} kernels {bwd:.3f} ms ({bwd_share:.2%} of the step's device time); "
              f"{fwd_name} forward {fwd:.3f} ms ({fwd / busy:.2%})")
        for t, n, key in kernels:
            if re.search(bwd_re, key):
                print(f"      {t:10.3f} ms x{n:<5} {key[:90]}")
                short = re.search(r"\w+_kernel(<[^>]*>)?", key)
                bwd_kernel_ms[short.group(0) if short else key[:60]] = t / n
    print(
        f"  warm: train step {med:.3f} ms (median of {TRAIN_TIMED}; {', '.join(f'{t:.3f}' for t in step_ms)}), "
        f"{tokens / med * 1e3:.1f} tokens/s, peak memory {peak:.2f} GiB; {time.perf_counter() - t0:.2f} s"
    )
    del params, opt, batches
    torch.cuda.empty_cache()
    return {"launches": launches, "step_ms": med, "tokens_per_s": tokens / med * 1e3, "peak_gib": peak,
            "device_busy_share": None if reading is None else reading[0] / reading[1],
            "bwd_share_of_device_time": bwd_share, "bwd_kernel_ms_per_call": bwd_kernel_ms}


def phase_train_check() -> None:
    """Full width, TRAIN_CHECK_LAYERS layers, float32: the kernels' gradient
    against the plain versions' for both models; 4 microbatches against 1;
    the loss falls on SyntheticTokens."""
    for name, base in TRAIN.items():
        cfg = dataclasses.replace(base, n_layers=TRAIN_CHECK_LAYERS)
        seq = TRAIN_CHECK_SEQ.get(name, TRAIN_SEQ)
        params = tf.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(3), device=DEVICE, dtype=torch.float32)
        batch = next(batches_for_arch(cfg, 2, seq, seed=4, device=DEVICE))
        zero_launches()
        loss, got = param_grads(cfg, params, batch)
        kernel_launches = launch_counts()
        with plain_kernels():
            plain_loss, want = param_grads(cfg, params, batch)
        assert launch_counts() == kernel_launches, "the plain check launched a kernel"
        assert kernel_launches[TRAIN_KERNELS[cfg.block][2]] == cfg.n_layers, kernel_launches
        errs = {path: float((g - w).norm() / w.norm().clamp_min(1e-30)) for (path, g), (_, w) in zip(got, want)}
        worst = max(errs, key=errs.get)
        windows = sorted(set(tf.layer_window_values(cfg)))
        print(f"  {name}, {cfg.n_layers} layers (windows {windows}), 2 x {seq}: loss {loss:.6f} vs plain "
              f"{plain_loss:.6f}; gradient of {len(errs)} leaves, largest error over norm {errs[worst]:.3e} "
              f"({worst}), tol {TRAIN_GRAD_TOL}")
        if errs[worst] > TRAIN_GRAD_TOL or abs(loss - plain_loss) > TRAIN_GRAD_TOL * abs(plain_loss):
            raise AssertionError(f"{name}: the kernels' gradient disagrees with the plain versions'")
        del params, got, want

    cfg = dataclasses.replace(TRAIN["qwen1.5-0.5b"], n_layers=TRAIN_CHECK_LAYERS)
    params = tf.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(1), device=DEVICE, dtype=torch.float32)
    batch = next(batches_for_arch(cfg, MICRO_CHECK_BATCH, MICRO_CHECK_SEQ, seed=5, device=DEVICE))
    outs = {}
    for n in (1, 4):
        tcfg = TrainConfig(optimizer=AdamWConfig(lr=1e-3), n_microbatches=n)
        new, _, m = make_train_step(cfg, tcfg)(params, adamw_init(params, tcfg.optimizer), batch)
        outs[n] = (leaves_with_paths(new), float(m["loss"]))
    rel = abs(outs[4][1] - outs[1][1]) / abs(outs[1][1])
    _, g_full = param_grads(cfg, params, batch)     # the 1-microbatch step's gradient
    n_all = n_out = 0
    unexplained, where = [], Counter()
    for (path, a), (_, b), (_, g) in zip(outs[1][0], outs[4][0], g_full):
        out = ~torch.isclose(a, b, rtol=2e-3, atol=2e-4)
        n_all, n_out = n_all + a.numel(), n_out + int(out.sum())
        if out.any():
            where[path] = int(out.sum())
            if bool((out & (g.abs() > MICRO_SIGN_TOL * g.square().mean().sqrt())).any()):
                unexplained.append(path)
    print(f"  qwen1.5-0.5b, {cfg.n_layers} layers, {MICRO_CHECK_BATCH} x {MICRO_CHECK_SEQ}: 4 microbatches vs 1: "
          f"loss {outs[4][1]:.6f} vs {outs[1][1]:.6f} (rel {rel:.2e}, tol 1e-4); {n_out} of {n_all} parameters "
          f"outside rtol 2e-3 / atol 2e-4 ({dict(where)}), each where |g| < {MICRO_SIGN_TOL} of its leaf's RMS "
          f"(AdamW's first step is sign(g) there); leaves with other misses: {unexplained}")
    if rel > 1e-4 or unexplained or n_out > MICRO_SIGN_SHARE * n_all:
        raise AssertionError("4 microbatches disagree with 1")
    del params, outs, g_full

    params = tf.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(0), device=DEVICE, dtype=torch.float32)
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=LOSS_LR))
    opt, step, losses = adamw_init(params, tcfg.optimizer), make_train_step(cfg, tcfg), []
    for _, batch in zip(range(LOSS_STEPS), batches_for_arch(cfg, LOSS_BATCH, LOSS_SEQ, device=DEVICE)):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    print(f"  qwen1.5-0.5b, {cfg.n_layers} layers, {LOSS_STEPS} steps of {LOSS_BATCH} x {LOSS_SEQ} at lr {LOSS_LR}: "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f} (must fall by {LOSS_FALL})")
    if not losses[-1] < losses[0] - LOSS_FALL:
        raise AssertionError(f"the loss did not fall: {losses}")
    del params, opt
    torch.cuda.empty_cache()


def bwd_bound(key, dtype, ops_per_s=None) -> tuple[float, str]:
    """Least time (ms) of the backward: q, k, v, out and its gradient read
    and dq, dk, dv written once at the memory rate, or 2.5 times the
    forward's operations (five products of its size over the unmasked
    pairs) at ``ops_per_s`` (by default the peak rate of the type),
    whichever is longer."""
    b, s, h, kv, hd, window = key
    size = torch.empty((), dtype=dtype).element_size()
    t_bytes = (4 * b * s * h * hd + 4 * b * s * kv * hd) * size / HBM_BYTES_PER_S * 1e3
    w = window if window > 0 else s
    pairs = sum(min(i + 1, w) for i in range(s))
    t_ops = 2.5 * 4.0 * hd * pairs * b * h / (ops_per_s or PEAK_OPS_PER_S[dtype]) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bwd_floor(key, dtype) -> float:
    """The wgmma route's own floor (ms): the eight products of the
    forward's size that its kernels run (stats q k^T; dK/dV k q^T, v do^T,
    p^T do, ds^T q; dQ q k^T, do v^T, ds k) over the unmasked pairs, at the
    peak rate of ``dtype``."""
    b, s, h, kv, hd, window = key
    w = window if window > 0 else s
    pairs = sum(min(i + 1, w) for i in range(s))
    return 8 * 2.0 * hd * pairs * b * h / PEAK_OPS_PER_S[dtype] * 1e3


def sdpa_bwd_call(q, k, v, do, scale, window):
    """The library yardstick: the backward of one
    F.scaled_dot_product_attention call on the same inputs (heads-first,
    enable_gqa; a boolean mask for windowed layers), through
    torch.autograd.grad of a forward made once."""
    qh, kh, vh = (a.transpose(1, 2).detach().requires_grad_(True) for a in (q, k, v))
    if window > 0:
        pos = torch.arange(q.shape[1], device=q.device)
        mask = (pos[None, :] <= pos[:, None]) & (pos[:, None] - pos[None, :] < window)
        out = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask, scale=scale, enable_gqa=True)
    else:
        out = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True, scale=scale, enable_gqa=True)
    doh = do.transpose(1, 2)
    return lambda: torch.autograd.grad(out, (qh, kh, vh), doh, retain_graph=True)


def phase_train_times(calls: Counter) -> tuple[dict, list[dict]]:
    """Times of the backward kernel at each shape the train paths called it
    with, its bound at the float32 rate and at the split-TF32 rate; the
    totals over one train step of each model (each shape times its calls a
    step) are the kernels line's numbers.  Also the float32 forward kernel
    at the same shapes beside its plain version, SDPA's float32 forward and
    its bound, returned per shape."""
    rows = [(key, dtype, n // (TRAIN_TIMED + 1)) for (kname, key, dtype), n in calls.items()
            if kname == "flash_attention_bwd"]
    tot, by_bytes, forward = Counter(), 0.0, []
    print("times of flash_attention_bwd (ms per call, CUDA events) at the train paths' shapes:")
    for key, dtype, n in rows:
        q, k, v = flash_operands(key, dtype, seed=0)
        do = torch.randn(q.shape, generator=torch.Generator().manual_seed(1)).to(dtype).to(DEVICE)
        scale, window = key[4] ** -0.5, key[5]
        o = causal_attention(q, k, v, scale=scale, window=window)
        fn = lambda: causal_attention_bwd(q, k, v, o, do, scale=scale, window=window)  # noqa: E731
        plain = lambda: causal_attention_bwd_plain(q, k, v, o, do, scale=scale, window=window)  # noqa: E731
        lib = sdpa_bwd_call(q, k, v, do, scale, window)
        bound_ms, bound_by = bwd_bound(key, dtype)
        t = {
            "ms": time_ms(fn, 10, warmup=2),
            "graph_ms": time_graph_ms(fn, calls=5, replays=3),
            "plain_ms": time_ms(plain, 3, warmup=1),
            "library_ms": time_ms(lib, 10, warmup=2),
            "bound_ms": bound_ms,
            "bound_split_tf32_ms": bwd_bound(key, dtype, SPLIT_TF32_OPS_PER_S)[0],
        }
        print(
            f"  {str(dtype)[6:]} (B,S,H,KV,hd,window)={key}, {n} calls a step: kernel={t['ms']:.6f} "
            f"graph={t['graph_ms']:.6f} plain={t['plain_ms']:.6f} sdpa_backward={t['library_ms']:.6f} "
            f"bound={bound_ms:.6f} ({bound_by}, f32 FMA) share={bound_ms / t['ms']:.4%} graph share="
            f"{bound_ms / t['graph_ms']:.4%}; split-TF32 bound={t['bound_split_tf32_ms']:.6f} graph share="
            f"{t['bound_split_tf32_ms'] / t['graph_ms']:.4%}; kernel / sdpa_backward={t['ms'] / t['library_ms']:.3f} "
            f"graph / plain={t['graph_ms'] / t['plain_ms']:.3f}"
        )
        for key2, val in t.items():
            tot[key2] += n * val
        if bound_by == "bytes":
            by_bytes += n * bound_ms
        fwd = lambda: causal_attention(q, k, v, scale=scale, window=window)  # noqa: E731
        fwd_bound, fwd_by = flash_bound(key, dtype)
        f = {
            "shape": list(key), "dtype": str(dtype)[6:], "calls_a_step": 2 * n,
            "ms": time_ms(fwd, 10, warmup=2), "graph_ms": time_graph_ms(fwd, calls=5, replays=3),
            "plain_ms": time_ms(lambda: causal_attention_plain(q, k, v, scale=scale, window=window), 3, warmup=1),
            "library_ms": time_ms(sdpa_call(q, k, v, scale, window), 10, warmup=2),
            "bound_ms": fwd_bound, "bound_by": fwd_by,
            "bound_split_tf32_ms": flash_bound(key, dtype, SPLIT_TF32_OPS_PER_S)[0],
        }
        print(
            f"    forward at that shape ({2 * n} calls a step under remat), {route(dtype, key[4])}: "
            f"kernel={f['ms']:.6f} graph={f['graph_ms']:.6f} plain={f['plain_ms']:.6f} sdpa={f['library_ms']:.6f} "
            f"bound={fwd_bound:.6f} ({fwd_by}, f32 FMA) graph share={fwd_bound / f['graph_ms']:.4%}; "
            f"split-TF32 bound={f['bound_split_tf32_ms']:.6f} graph share="
            f"{f['bound_split_tf32_ms'] / f['graph_ms']:.4%}; kernel / sdpa={f['ms'] / f['library_ms']:.3f} "
            f"graph / sdpa={f['graph_ms'] / f['library_ms']:.3f}"
        )
        forward.append(f)
        del q, k, v, o, do
    out = {"ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
           "bound_by": "bytes" if by_bytes >= tot["bound_ms"] / 2 else "operations",
           "library_ms": tot["library_ms"], "graph_ms": tot["graph_ms"],
           "bound_split_tf32_ms": tot["bound_split_tf32_ms"]}
    print(f"  one train step of each model ({sum(n for _, _, n in rows)} calls): " + ", ".join(
        f"{k2}={v2:.6f}" if isinstance(v2, float) else f"{k2}={v2}" for k2, v2 in out.items()))
    return out, forward


def wkv_bwd_bound(key, dtype) -> tuple[float, str]:
    """Least time (ms) of wkv6's gradient: r, k, v (``dtype``), w, dout, u,
    the initial state and the final state's gradient read and dr, dk, dv,
    dw, du and d(state) written once at the memory rate, or 14 * hd^2
    operations per token and head (S dout, G v, G^T k and rowsum(G * S), 2
    hd^2 each; G's update and S rebuilt forward, 3 hd^2 each) at the peak
    rate of r, k, v's type, whichever is longer."""
    b, t, h, hd = key
    size = torch.empty((), dtype=dtype).element_size()
    n, state = b * t * h * hd, b * h * hd * hd
    t_bytes = (2 * 3 * n * size + 2 * n * 4 + n * 4 + 2 * h * hd * 4 + 4 * state * 4) / HBM_BYTES_PER_S * 1e3
    t_ops = 14.0 * hd * hd * b * t * h / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_wkv_train_times(calls: Counter, step_kernel_ms: dict[str, float]) -> tuple[dict, list[dict]]:
    """Times of wkv6's backward kernels at each shape the train path called
    them with, beside their plain version and bound (no single PyTorch call
    computes the function), and each of its kernels' device time a call
    from the train step's profile (``step_kernel_ms``); the totals over one
    train step (each shape times its calls a step) are the kernels line's
    numbers.  Also the forward kernel at the same shapes, float32 (the
    route ``wkv_route`` names: the chunk kernel at head_dim 64), beside its
    plain version and bound, returned per shape."""
    rows = [(key, dtype, n // (TRAIN_TIMED + 1)) for (kname, key, dtype), n in calls.items() if kname == "wkv6_bwd"]
    tot, by_bytes, forward = Counter(), 0.0, []
    print("times of wkv6_bwd (ms per call, CUDA events) at the train path's shapes:")
    for key, dtype, n in rows:
        args = wkv_grad_operands(key, dtype, 0, False, "mild")
        fn = lambda: wkv6_bwd(*args)  # noqa: E731
        plain = lambda: wkv6_bwd_plain(*args)  # noqa: E731
        bound_ms, bound_by = wkv_bwd_bound(key, dtype)
        t = {"ms": time_ms(fn, 10, warmup=2), "graph_ms": time_graph_ms(fn, calls=5, replays=3),
             "plain_ms": time_ms(plain, 2, warmup=1), "bound_ms": bound_ms}
        print(
            f"  {str(dtype)[6:]} (B,T,H,hd)={key}, {n} calls a step: kernel={t['ms']:.6f} graph={t['graph_ms']:.6f} "
            f"plain={t['plain_ms']:.6f} library=none bound={bound_ms:.6f} ({bound_by}) "
            f"share={bound_ms / t['ms']:.4%} graph share={bound_ms / t['graph_ms']:.4%}"
        )
        for key2, val in t.items():
            tot[key2] += n * val
        if bound_by == "bytes":
            by_bytes += n * bound_ms
        fwd = lambda: wkv6(*args[:6])  # noqa: E731
        fwd_bound, fwd_by = wkv_bound(key, dtype)
        f = {
            "shape": list(key), "dtype": str(dtype)[6:], "route": wkv_route(dtype, key[3]), "calls_a_step": 2 * n,
            "ms": time_ms(fwd, 10, warmup=2), "graph_ms": time_graph_ms(fwd, calls=5, replays=3),
            "plain_ms": time_ms(lambda: wkv6_plain(*args[:6]), 1, warmup=0),
            "bound_ms": fwd_bound, "bound_by": fwd_by,
        }
        print(
            f"    forward at that shape ({2 * n} calls a step under remat), {f['route']} route: "
            f"kernel={f['ms']:.6f} graph={f['graph_ms']:.6f} plain={f['plain_ms']:.6f} "
            f"bound={fwd_bound:.6f} ({fwd_by}) graph share={fwd_bound / f['graph_ms']:.4%}"
        )
        forward.append(f)
        del args
    print("  by kernel, device ms a call from the train step's profile: "
          + ", ".join(f"{name} {ms:.6f}" for name, ms in step_kernel_ms.items()))
    out = {"ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
           "bound_by": "bytes" if by_bytes >= tot["bound_ms"] / 2 else "operations",
           "library_ms": None, "graph_ms": tot["graph_ms"], "ms_by_kernel": step_kernel_ms}
    print(f"  one train step ({sum(n for _, _, n in rows)} calls): " + ", ".join(
        f"{k2}={v2:.6f}" if isinstance(v2, float) else f"{k2}={v2}" for k2, v2 in out.items()))
    return out, forward


# --------------------------------------------------------------------------
# The reference's production train step (launch/steps.py::build_train) in
# bfloat16 on one card: qwen1.5-0.5b and gemma3-1b at full width and depth
# --------------------------------------------------------------------------
PROD_ARCHS = ("qwen1.5-0.5b", "gemma3-1b")
# INPUT_SHAPES["train_4k"] (256 x 4096) with the global batch cut to 8.  On
# one device train_config_for makes one microbatch per sequence: 8
# microbatches of 1 x 4096 a step, each the work of train_4k's microbatch
# on one batch shard; only the number accumulated is smaller.
PROD_SHAPE = dataclasses.replace(INPUT_SHAPES["train_4k"], global_batch=8)
PROD_TIMED = 3
# The path's attention calls (B, S, H, KV, hd, window), bfloat16: qwen's,
# and gemma3-1b's windowed and global layers.
PROD_FLASH_SHAPES = [(1, 4096, 16, 16, 64, 0), (1, 4096, 4, 1, 256, 512), (1, 4096, 4, 1, 256, 0)]
# Gradient of forward_loss through the kernels against the plain versions,
# bfloat16 parameters and activations, full width, 1 x 4096: qwen at 2
# layers, gemma3-1b at 6 (five windowed layers and its first global one).
PROD_CHECK_LAYERS = {"qwen1.5-0.5b": 2, "gemma3-1b": 6}
# Each leaf's error norm over its norm.  bfloat16 keeps 8 significant bits
# (eps = 2^-8).  Both sides round every activation, probability and
# gradient to bfloat16, but at different points (the kernels round P and
# their outputs once, after float32 sums; the plain versions after each
# product), so an element of either carries rounding of a few eps that the
# other does not, with independent signs; a leaf's norm of such errors is a
# few eps of its norm.  The limit is 8 eps; a lost tile of a key block, the
# fault the per-row checks plant, moves the rows it touches by order 1.
PROD_GRAD_TOL = 8 * 2.0**-8
# cuBLAS / CUTLASS product kernels as the profiler names them.
PRODUCT_KERNELS = re.compile(r"gemm|cutlass|xmma|nvjet|cublas", re.IGNORECASE)


@contextlib.contextmanager
def full_depth_moments(full):
    """``steps.train_config_for`` giving every bundle built inside the
    moments' type that it gives ``full``, the uncut model: the reference
    keeps bfloat16 moments above BIG_MODEL_PARAMS parameters, which a
    depth-cut config would fall below.  ``build_train`` looks the function
    up in its module at every call."""
    orig = steps_mod.train_config_for

    def for_full(cfg, shape, mesh):
        tcfg = orig(cfg, shape, mesh)
        moments = orig(full, shape, mesh).optimizer.moments_dtype
        return dataclasses.replace(tcfg, optimizer=dataclasses.replace(tcfg.optimizer, moments_dtype=moments))

    steps_mod.train_config_for = for_full
    try:
        yield
    finally:
        steps_mod.train_config_for = orig


def dtypes(tree) -> str:
    """The types of ``tree``'s leaves, by the number of elements they hold."""
    n = Counter()
    for _, t in leaves_with_paths(tree):
        n[str(t.dtype)[6:]] += t.numel()
    return ", ".join(f"{k} {v / 1e9:.3f} B" for k, v in n.most_common())


def phase_prod_train(name: str, mesh, calls: Counter, cfg=None, shape=PROD_SHAPE, timed: int = PROD_TIMED,
                     plan=None) -> dict:
    """The reference's production train step of ``name`` through the
    port's bundle: ``build_train`` on a one-device mesh (of ``cfg``, by
    default the whole model; a depth-cut one keeps the whole model's
    moments, ``full_depth_moments``), ``materialize``, then the bundle's
    ``fn``: one warm and ``timed`` timed steps and one under the profiler;
    returns the path's launches and the step's readings.  ``plan`` is the
    bundle's count (``plan_depth``): its FLOPs are the step's, and its
    predicted peak is printed beside the measured one; without it the
    counter runs on one microbatch's bundle."""
    full = ARCHS[name]
    cfg = cfg or full
    t0 = time.perf_counter()
    with full_depth_moments(full):
        bundle = build_train(cfg, shape, mesh)
    tcfg = bundle.train_config
    got = (tcfg.n_microbatches, tcfg.optimizer.moments_dtype, tcfg.remat, tcfg.remat_policy)
    want = (shape.global_batch, steps_mod.train_config_for(full, shape, mesh).optimizer.moments_dtype, True,
            cfg.remat_policy)
    full_shape = INPUT_SHAPES["train_4k"]
    depth = "full depth" if cfg.n_layers == full.n_layers else f"{cfg.n_layers} of {full.n_layers} layers"
    print(f"{name}: {bundle.description}; n_microbatches, moments, remat, policy = {got}; {depth}; "
          f"reduced: global batch {full_shape.global_batch} -> {shape.global_batch}, "
          f"{shape.global_batch} microbatches of 1 x {shape.seq_len}")
    assert got == want, (got, want)

    if plan is None:
        # The counter on one microbatch's bundle (global batch 1): the
        # step's products are its microbatches' (the accumulation and AdamW
        # have none).
        t = time.perf_counter()
        one = count_step(build_train(cfg, dataclasses.replace(shape, global_batch=1), mesh))
        counted = one.flops * tcfg.n_microbatches
        print(f"  counter (FakeTensorMode, host, {time.perf_counter() - t:.2f} s): {one.flops:.6e} FLOPs and "
              f"{one.bytes_accessed:.6e} bytes a microbatch; {counted:.6e} FLOPs a step")
    else:
        counted = plan[0].flops
    mf = model_flops(cfg, shape)
    print(f"  {counted:.6e} FLOPs a step counted; model_flops {mf:.6e} (useful ratio {mf / counted:.4f})")

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    params, opt, batch = materialize(bundle, torch.Generator(device=DEVICE).manual_seed(0), DEVICE)
    n_leaves = len(leaves_with_paths((params, opt, batch)))
    print(f"  materialize: {n_leaves} tensors of the bundle's abstract shapes and dtypes "
          f"(parameters {dtypes(params)}, moments {dtypes(opt['m'])}); "
          f"{tf.count_params(cfg) / 1e9:.3f} B parameters, {cfg.n_layers} layers; {time.perf_counter() - t0:.2f} s")
    micro = {k: a[:1] for k, a in batch.items()}
    loss, grads = param_grads(cfg, params, micro)
    bad = [path for path, g in grads if not (bool(torch.isfinite(g).all()) and bool(g.abs().max() > 0))]
    unread = UNREAD_LEAVES.get(name, ())
    print(f"  gradient of forward_loss on one microbatch (bf16): loss {loss:.4f}, {len(grads)} leaves read"
          f"{f' (unread: {list(unread)})' if unread else ''}, {len(grads) - len(bad)} finite and non-zero")
    if bad or not math.isfinite(loss):
        raise AssertionError(f"{name}: leaves without a finite, non-zero gradient: {bad[:8]}")
    del grads

    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    step_ms = []
    with recording_kernel_calls(calls), recording_bwd_calls(calls):
        for i in range(timed + 1):
            torch.cuda.synchronize()
            t = time.perf_counter()
            params, opt, metrics = bundle.fn(params, opt, batch)
            loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
            if i:
                step_ms.append((time.perf_counter() - t) * 1e3)
            print(f"  step {i}{' (warm)' if i == 0 else ''}: loss {loss:.4f} grad_norm {gnorm:.4f}")
            if not (math.isfinite(loss) and math.isfinite(gnorm)):
                raise AssertionError(f"{name}: non-finite loss or grad_norm at step {i}")
    launches = launch_counts()
    steps = timed + 1
    fwd_name, fwd_re, bwd_name, bwd_re = TRAIN_KERNELS[cfg.block]
    want = {k["name"]: 0 for k in KERNELS}
    want[fwd_name] = 2 * cfg.n_layers * tcfg.n_microbatches * steps
    want[bwd_name] = cfg.n_layers * tcfg.n_microbatches * steps
    print(f"  launches over {steps} steps: {launches} (want {want}: two forwards a layer and microbatch under remat)")
    assert launches == want, (launches, want)
    measured = torch.cuda.max_memory_allocated() - base
    peak = torch.cuda.max_memory_allocated() / 2**30
    plan_line = {}
    if plan is not None:
        predicted = plan[1]["peak_bytes"]
        plan_line = {"predicted_peak_gib": predicted / 2**30, "measured_peak_gib": measured / 2**30,
                     "peak_ratio": predicted / measured}
        print(f"  peak: predicted {predicted / 2**30:.3f} GiB (the bundle's count), measured {measured / 2**30:.3f} "
              f"GiB (max_memory_allocated over materialize and the steps), ratio {predicted / measured:.4f}")
        if not DRYRUN_PEAK_RATIO[0] <= predicted / measured <= DRYRUN_PEAK_RATIO[1]:
            raise AssertionError(f"{name}: predicted peak outside {DRYRUN_PEAK_RATIO} of the measured one")
    med = float(np.median(step_ms))
    tokens = shape.global_batch * shape.seq_len
    # An MoE's step (one layer here, few host ops) is profiled with its host
    # ops, for the program's moe span: the forward and remat's recompute
    # (the backward's kernels run outside the span).
    reading = device_breakdown("one train step", lambda: bundle.fn(params, opt, batch), host_ops=cfg.is_moe)
    shares = {}
    if reading is not None:
        busy, wall, kernels, ranges = reading
        products = sum(t for t, _, key in kernels if PRODUCT_KERNELS.search(key))
        fwd = [(t, n) for t, n, key in kernels if re.search(fwd_re, key)]
        bwd = [(t, n) for t, n, key in kernels if re.search(bwd_re, key)]
        fwd_ms, fwd_n = sum(t for t, _ in fwd), sum(n for _, n in fwd)
        bwd_ms = sum(t for t, _ in bwd)
        n_bwd = cfg.n_layers * tcfg.n_microbatches
        shares = {
            "device_busy_share": busy / wall,
            "device_busy_share_of_step": busy / med,
            "product_share": products / busy,
            f"{fwd_name}_share": fwd_ms / busy,
            f"{fwd_name}_ms_per_call": fwd_ms / max(fwd_n, 1),
            f"{bwd_name}_share": bwd_ms / busy,
            f"{bwd_name}_ms_per_call": bwd_ms / n_bwd,
            **({"moe_forward_share": ranges["moe"] / busy} if "moe" in ranges else {}),
        }
        print(f"    device busy {busy:.3f} ms a step is {busy / med:.2%} of the unprofiled step's {med:.3f} ms")
        print(f"    product kernels {products:.3f} ms ({products / busy:.2%}); {fwd_name} {fwd_ms:.3f} ms "
              f"({fwd_ms / busy:.2%}, {fwd_n} kernels, {fwd_ms / max(fwd_n, 1):.4f} ms each); "
              f"{bwd_name} {bwd_ms:.3f} ms ({bwd_ms / busy:.2%}, {bwd_ms / n_bwd:.4f} ms a call); {card_line()}")
    mfu = mf / (med / 1e3) / H100_SXM.peak_flops_bf16
    print(
        f"  warm: train step {med:.3f} ms (median of {timed}; {', '.join(f'{t:.3f}' for t in step_ms)}), "
        f"{tokens / med * 1e3:.1f} tokens/s, peak memory {peak:.2f} GiB; model-FLOPs utilization {mfu:.4%} "
        f"of {H100_SXM.peak_flops_bf16 / 1e12:.1f} TFLOP/s bf16 on {card_line()}; {time.perf_counter() - t0:.2f} s"
    )
    del params, opt, batch, bundle
    torch.cuda.empty_cache()
    return {"launches": launches, "layers": cfg.n_layers, "moments": str(got[1])[6:], "step_ms": med,
            "tokens_per_s": tokens / med * 1e3, "peak_gib": peak, **plan_line,
            "model_flops": mf, "counted_flops": counted, "mfu_bf16": mfu, "card": card_line(),
            "reduced": f"global batch {full_shape.global_batch} -> {shape.global_batch}"
                       + ("" if cfg.n_layers == full.n_layers else f", {cfg.n_layers} of {full.n_layers} layers"),
            **shares}


# --------------------------------------------------------------------------
# Phase 7g: the reference's production train step in bfloat16 for the
# families that had only served on the card, and rwkv6-7b in bfloat16
# --------------------------------------------------------------------------
PROD_FAMILIES = ("hymba-1.5b", "phi-3-vision-4.2b", "musicgen-large", "minicpm-2b", "nemotron-4-15b",
                 "grok-1-314b", "rwkv6-7b")
# hymba-1.5b with the reference's --opt scan (launch/dryrun.py's
# OPT_OVERRIDES), as the zoo phase serves it.
PROD_FAMILY_CFG = {"hymba-1.5b": ZOO["hymba-1.5b"]}
# train_4k's microbatch of 1 x 4096 with the global batch cut from 256 to
# 4: 4 microbatches a step on one device; one warm step, PROD_FAMILY_TIMED
# timed ones and one under the profiler.
PROD_FAMILY_SHAPE = dataclasses.replace(INPUT_SHAPES["train_4k"], global_batch=4)
PROD_FAMILY_TIMED = 2
# Depth: the most layers whose bundle's predicted peak (the port's own
# count on the card's fake tensors) stays within this, of the card's 80 GB.
PROD_PEAK_LIMIT = 76 * 2**30
# The gradient check's depth: 2 layers (hymba's first is global, its
# second windowed), grok-1 at 1 (one layer is 6.5 B parameters).
PROD_FAMILY_CHECK_LAYERS = {name: 2 for name in PROD_FAMILIES} | {"grok-1-314b": 1}


def plan_depth(name: str, full, shape, mesh) -> tuple[int, dict, float | None]:
    """The most layers of ``full`` (at most all of them) whose train bundle
    at ``shape`` has a predicted peak (``count`` on the card's fake
    tensors, no launch) within PROD_PEAK_LIMIT; 0 when one layer's is past
    it.  Counts at 1 and 2 layers, then at the depth that a straight line
    through the two farthest counted depths from 2 up gives, until the
    next depth is counted past the limit or that line puts it there.
    Returns (layers, {layers: (costs, memory)} of every depth counted, the
    line's peak in bytes for one more layer, or None)."""
    plans = {}

    def peak(n):
        if n not in plans:
            t = time.perf_counter()
            with full_depth_moments(ARCHS[name]):
                bundle = build_train(dataclasses.replace(full, n_layers=n), shape, mesh)
            assert leaves_with_paths(bundle.args)[0][1].device.type == "cuda"
            before = launch_counts()
            plans[n] = count(bundle)
            assert launch_counts() == before, f"{name}: a kernel launched during the fake run"
            memory = plans[n][1]
            print(f"  plan at {n} layers: predicted peak {memory['peak_bytes'] / 2**30:.3f} GiB (arguments "
                  f"{memory['argument_bytes'] / 2**30:.3f}, outputs {memory['output_bytes'] / 2**30:.3f}), "
                  f"moments {bundle.train_config.optimizer.moments_dtype}; fake run {time.perf_counter() - t:.2f} s")
        return plans[n][1]["peak_bytes"]

    def line(n):
        pts = sorted(m for m in plans if m >= 2) or [1]
        a, b = (pts[0], pts[-1]) if len(pts) > 1 else (1, 2)
        return peak(b) + (peak(b) - peak(a)) / (b - a) * (n - b)

    total = full.n_layers
    if peak(1) > PROD_PEAK_LIMIT:
        return 0, plans, None
    fits, over = 1, total + 1
    if total > 1:
        fits, over = (2, over) if peak(2) <= PROD_PEAK_LIMIT else (1, 2)
    while over - fits > 1 and line(fits + 1) <= PROD_PEAK_LIMIT:
        step = (line(fits + 1) - line(fits)) or 1.0
        n = max(fits + 1, min(over - 1, fits + int((PROD_PEAK_LIMIT - peak(fits)) / step)))
        fits, over = (n, over) if peak(n) <= PROD_PEAK_LIMIT else (fits, n)
    return fits, plans, (line(fits + 1) if over > fits + 1 else None)


def plan_family(name: str) -> dict:
    """``plan_depth`` of one of PROD_FAMILIES at PROD_FAMILY_SHAPE, in a
    worker process (``start_plans``): a one-rank fake process group and a
    mesh on the card, whose bundles' fake tensors are on the card (no
    memory is taken and nothing launches).  Returns the depth, the counts,
    the line's next layer, the lines it printed and its seconds."""
    import io

    from repro_torch.launch.dryrun import dryrun_mesh, start_fake_group

    t = time.perf_counter()
    started = start_fake_group(1)
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            layers, plans, next_line = plan_depth(name, PROD_FAMILY_CFG.get(name, ARCHS[name]), PROD_FAMILY_SHAPE,
                                                  dryrun_mesh((1, 1), ("data", "model")))
    finally:
        if started:
            torch.distributed.destroy_process_group()
    return {"layers": layers, "plans": plans, "next_line": next_line, "printed": out.getvalue(),
            "seconds": time.perf_counter() - t}


def start_plans() -> tuple[ProcessPoolExecutor, dict]:
    """Phase 7g's memory plans (``plan_family``), started in two worker
    processes at the beginning of the run: counting a full-depth bundle is
    minutes of host work (hymba-1.5b's 32 layers about 80 s), which the
    workers do while the earlier phases run.  Returns the pool and each
    family's future."""
    import multiprocessing

    pool = ProcessPoolExecutor(max_workers=2, mp_context=multiprocessing.get_context("spawn"))
    return pool, {name: pool.submit(plan_family, name) for name in PROD_FAMILIES}


def phase_prod_family(name: str, mesh, calls: Counter, planned: dict) -> dict:
    """Phase 7g for one family: its depth from the port's memory plan
    (``planned``, from ``plan_family``), then ``phase_prod_train`` of that
    depth at PROD_FAMILY_SHAPE with the plan's predicted peak beside the
    measured one.  A family whose one-layer plan is past PROD_PEAK_LIMIT
    does not run; the record says why."""
    full = PROD_FAMILY_CFG.get(name, ARCHS[name])
    t = time.perf_counter()
    layers, plans, next_line = planned["layers"], planned["plans"], planned["next_line"]
    print(planned["printed"], end="")
    counted = {n: plans[n][1]["peak_bytes"] / 2**30 for n in sorted(plans)}
    nxt = "" if next_line is None else f"; one more layer, on the line through the counts: {next_line / 2**30:.3f} GiB"
    print(f"{name}: {layers} of {full.n_layers} layers fit within {PROD_PEAK_LIMIT / 2**30:.0f} GiB "
          f"(predicted peaks by layers counted, GiB: {', '.join(f'{n}: {g:.3f}' for n, g in counted.items())}{nxt}); "
          f"plan {planned['seconds']:.2f} s in a worker process")
    if layers == 0:
        print(f"{name}: NOT RUN: one layer's train bundle is predicted to peak at {counted[1]:.3f} GiB, past "
              f"{PROD_PEAK_LIMIT / 2**30:.0f} GiB of the card; it waits for a multi-card path")
        return {"run": False, "predicted_peak_gib_by_layers": counted, "plan_s": planned["seconds"],
                "card": card_line()}
    rec = phase_prod_train(name, mesh, calls, dataclasses.replace(full, n_layers=layers), PROD_FAMILY_SHAPE,
                           PROD_FAMILY_TIMED, plans[layers])
    return {"run": True, "predicted_peak_gib_by_layers": counted, "plan_s": planned["seconds"],
            "seconds": time.perf_counter() - t, **rec}


def phase_7g(phase, planner: ProcessPoolExecutor, plans: dict) -> tuple[dict, Counter, dict, dict]:
    """Phase 7g: each of PROD_FAMILIES through ``phase_prod_family`` with
    its plan (``start_plans``' pool and futures; the pool is shut down
    once every plan is in), then the kernels against their plain versions
    per row at every new shape the steps launched, the bf16 gradient check
    at PROD_FAMILY_CHECK_LAYERS and the kernels' times at the new shapes;
    ``phase`` runs and times each part.  Returns (each family's record, the
    kernel calls of all their steps, the gradient checks, the times)."""
    t0 = time.perf_counter()
    planned = {name: plans[name].result() for name in PROD_FAMILIES}
    planner.shutdown()
    print(f"7g: plans in {time.perf_counter() - t0:.2f} s more")
    calls = Counter()
    families = {}
    mesh = make_host_mesh(1, 1)
    try:
        for name in PROD_FAMILIES:
            families[name] = phase(f"7g: production train path (bf16): {name}", phase_prod_family, name, mesh, calls,
                                   planned[name])
    finally:
        torch.distributed.destroy_process_group()
    not_run = [name for name, rec in families.items() if not rec["run"]]
    print("7g kernel calls per step: " + "; ".join(
        f"{k} {key} {str(dt)[6:]} x{n // (PROD_FAMILY_TIMED + 1)}" for (k, key, dt), n in calls.items()
    ) + f"; not run (plan past {PROD_PEAK_LIMIT / 2**30:.0f} GiB at one layer): {not_run or 'none'}")
    flash = [key for key in dict.fromkeys(key for (k, key, _dt) in calls if k == "flash_attention")
             if key not in PROD_FLASH_SHAPES]
    recur = list(dict.fromkeys(key for (k, key, _dt) in calls if k == "wkv6"))
    bf16 = (torch.bfloat16,)
    phase("7g: kernel vs plain: flash_attention at the further families' shapes, and against float64", check_flash,
          flash, bf16, True)
    phase("7g: kernel vs plain: flash_attention_bwd at the further families' shapes, and against float64",
          check_flash_bwd, flash, bf16, True)
    phase("7g: kernel vs plain: wkv6 at rwkv6-7b's bf16 train shape", check_wkv6, recur, bf16)
    for shape in recur:
        phase("7g: kernel vs plain: wkv6 per row at rwkv6-7b's bf16 train shape, and against float64",
              check_wkv6_rows, shape, "mild", torch.bfloat16)
    phase("7g: kernel vs plain: wkv6_bwd at rwkv6-7b's bf16 train shape, and against float64", check_wkv6_bwd,
          recur, bf16, "mild", True)
    checks = phase("7g: production train correctness: bf16 gradient, kernels against plain versions",
                   phase_prod_check, PROD_FAMILIES, PROD_FAMILY_CHECK_LAYERS)
    times = phase("7g: times: flash_attention and flash_attention_bwd at the further families' shapes",
                  phase_prod_times, calls, flash, PROD_FAMILY_TIMED + 1)
    times |= phase("7g: times: wkv6 and wkv6_bwd at rwkv6-7b's bf16 train shape", phase_prod_wkv_times,
                   calls, PROD_FAMILY_TIMED + 1)
    plan_s = sum(rec["plan_s"] for rec in families.values())
    print(f"== phase 7g: {time.perf_counter() - t0:.2f} s, and {plan_s:.2f} s of plans in the worker processes "
          f"beside the earlier phases; {card_line()}")
    return families, calls, checks, times


# Phase 7e: the bundles whose per-rank plan the dry run predicts, checked
# against what the caching allocator holds when they run.
DRYRUN_ARCHS = ("qwen1.5-0.5b", "gemma3-1b")
DRYRUN_SHAPES = (
    dataclasses.replace(INPUT_SHAPES["train_4k"], global_batch=2),
    dataclasses.replace(INPUT_SHAPES["prefill_32k"], global_batch=1),
    dataclasses.replace(INPUT_SHAPES["decode_32k"], global_batch=8),
)
# The predicted peak over the measured one (7e and 7g): the count and the
# caching allocator's own bytes agree to the allocator's rounding once
# the plan counts the computation that runs.
DRYRUN_PEAK_RATIO = (0.98, 1.02)


def phase_dryrun_card() -> list[dict]:
    """Phase 7e: each bundle's dry-run plan (fake CUDA tensors) against the
    same bundle run on the card; returns one record per bundle."""
    records = []
    mesh = make_host_mesh(1, 1)
    try:
        for name in DRYRUN_ARCHS:
            cfg = ARCHS[name]
            for shape in DRYRUN_SHAPES:
                records.append(dryrun_card_bundle(cfg, shape, mesh))
    finally:
        torch.distributed.destroy_process_group()
    bad = [r for r in records if not DRYRUN_PEAK_RATIO[0] <= r["peak_ratio"] <= DRYRUN_PEAK_RATIO[1]]
    if bad:
        raise AssertionError(f"predicted peak outside {DRYRUN_PEAK_RATIO} of the measured one: {bad}")
    return records


EXAMPLES = {
    # example -> the kernels it must launch on the card
    "torch_quickstart": (),
    "torch_multi_tenant_serve": ("block_matmul",),
    "torch_dynamic_adaptation": (),
    "torch_fleet_serve": (),
    "torch_train_small": ("flash_attention", "flash_attention_bwd"),
}


def phase_examples() -> dict:
    """Phase 7f: each ``examples/torch_*.py`` through its ``main`` at its
    default size on the card; returns each one's seconds and launches (and
    the training example's loss every 10 steps)."""
    out = {}
    for name, kernels in EXAMPLES.items():
        spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        zero_launches()
        t0 = time.perf_counter()
        result = module.main([])
        torch.cuda.synchronize()
        record = {"seconds": round(time.perf_counter() - t0, 3),
                  "launches": {n: v for n, v in launch_counts().items() if v}}
        missing = [k for k in kernels if not record["launches"].get(k)]
        if missing:
            raise AssertionError(f"{name} launched no {missing} on the card")
        if name == "torch_train_small":
            record["loss_every_10_steps"] = [round(x, 4) for x in result[::10]] + [round(result[-1], 4)]
        if name == "torch_multi_tenant_serve":
            record["requests"] = len(result)
            if not all(c.error is None for c in result):
                raise AssertionError(f"{name}: a request failed")
        print(f"{name}: {record}")
        out[name] = record
    return out


def dryrun_card_bundle(cfg, shape, mesh) -> dict:
    label = f"{cfg.name} x {shape.name} (global batch {shape.global_batch})"
    bundle = build_step(cfg, shape, mesh)
    first = leaves_with_paths(bundle.args)[0][1]
    assert first.device.type == "cuda", f"{label}: abstract arguments on {first.device}"
    before = launch_counts()
    t = time.perf_counter()
    costs, memory = count(bundle)
    count_s = time.perf_counter() - t
    assert launch_counts() == before, f"{label}: a kernel launched during the fake run"
    host = count_step(build_step(cfg, shape, MeshView({"data": 1, "model": 1}, ("data", "model"))))
    assert costs.flops == host.flops, f"{label}: {costs.flops} FLOPs on the card's fake tensors, {host.flops} on the host's"
    roof = analyze_compiled(cfg, shape, mesh, costs)["roofline"]

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    args = materialize(bundle, torch.Generator(device=DEVICE).manual_seed(0), DEVICE)
    if shape.kind == "decode":
        args = (*args[:3], 0)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = bundle.fn(*args)
    end.record()
    torch.cuda.synchronize()
    measured = torch.cuda.max_memory_allocated() - base
    call_ms = start.elapsed_time(end)
    finite = all(bool(torch.isfinite(t.float()).all()) for _, t in leaves_with_paths(out)
                 if isinstance(t, torch.Tensor) and t.is_floating_point())
    del args, out
    torch.cuda.empty_cache()
    ratio = memory["peak_bytes"] / measured
    print(f"  {label}: predicted peak {memory['peak_bytes'] / 2**30:.3f} GiB (arguments "
          f"{memory['argument_bytes'] / 2**30:.3f}, outputs {memory['output_bytes'] / 2**30:.3f}), "
          f"max_memory_allocated over materialize and the call {measured / 2**30:.3f} GiB, ratio {ratio:.4f}; "
          f"FLOPs {costs.flops:.6e} on the card's fake tensors = {host.flops:.6e} on the host's; "
          f"compute_s {roof['compute_s'] * 1e3:.3f} ms, memory_s {roof['memory_s'] * 1e3:.3f} ms, call "
          f"{call_ms:.3f} ms on the card (CUDA events); fake run {count_s:.2f} s")
    assert finite, f"{label}: non-finite output"
    return {"arch": cfg.name, "shape": shape.name, "global_batch": shape.global_batch,
            "peak_bytes": memory["peak_bytes"], "argument_bytes": memory["argument_bytes"],
            "output_bytes": memory["output_bytes"], "measured_bytes": measured, "peak_ratio": ratio,
            "flops": costs.flops, "host_flops": host.flops, "compute_s": roof["compute_s"],
            "memory_s": roof["memory_s"], "call_ms": call_ms, "count_s": count_s, "card": card_line()}


@contextlib.contextmanager
def moe_routing(record: list | None = None, replay: list | None = None, flips: list | None = None):
    """``moe.route`` with its choices recorded or replayed.  ``record`` gets
    each call's (G, gs, E) choice of experts (1.0 where a token chose one),
    in call order.  With ``replay``, each call takes the recorded choice in
    place of its own top-k: the gates are this side's router probabilities
    at the chosen experts, renormalised as ``route`` renormalises them, and
    the slots (the cumulative count in token order) and the capacity drops
    follow from the choice; ``flips`` gets, per call, the tokens whose own
    top-k differs from the recorded one.  ``_moe_groups`` looks the
    function up in its module at every call."""
    orig = moe.route
    fixed_choices = iter(replay or ())

    def route(xg, router, k, C):
        gates, assigned, keep, slot, probs = orig(xg, router, k, C)
        if record is not None:
            record.append(assigned.detach().clone())
        if replay is None:
            return gates, assigned, keep, slot, probs
        fixed = next(fixed_choices)
        flips.append(int((assigned != fixed).any(-1).sum()))
        chosen = probs * fixed
        gates = chosen / chosen.sum(-1, keepdim=True).clamp_min(1e-9)
        slot = torch.cumsum(fixed, dim=1) - fixed
        return gates, fixed, (fixed > 0) & (slot < C), slot.long(), probs

    moe.route = route
    try:
        yield
    finally:
        moe.route = orig


def _rel(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30))


def phase_prod_check(names=PROD_ARCHS, layers=None) -> dict:
    """Full width at ``layers`` layers a model (PROD_CHECK_LAYERS by
    default), 1 x 4096, bfloat16: the gradient of forward_loss through the
    kernels against the plain versions' (every leaf the loss reads within
    PROD_GRAD_TOL of its norm, each kernel launched twice a layer forward
    under remat and once backward), and each one's distance from the
    float32 plain gradient of the same parameters.  An MoE's routing is the
    kernel side's on both plain sides (``moe_routing``): bfloat16 rounding
    of the attention flips a token's top-k, and a flipped token takes
    another expert's weights.  Returns each model's readings."""
    layers = layers or PROD_CHECK_LAYERS
    out = {}
    for name in names:
        t0 = time.perf_counter()
        cfg = dataclasses.replace(PROD_FAMILY_CFG.get(name, ARCHS[name]), n_layers=layers[name])
        seq = PROD_SHAPE.seq_len
        params = tf.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(3), device=DEVICE)
        batch = next(batches_for_arch(cfg, 1, seq, seed=4, device=DEVICE))
        zero_launches()
        choices, flips, flips32 = [], [], []
        with moe_routing(record=choices):
            loss, got = param_grads(cfg, params, batch)
        kernel_launches = launch_counts()
        with plain_kernels(), moe_routing(replay=choices, flips=flips):
            plain_loss, want = param_grads(cfg, params, batch)
        assert launch_counts() == kernel_launches, "the plain check launched a kernel"
        fwd_name, _, bwd_name, _ = TRAIN_KERNELS[cfg.block]
        expect = {k["name"]: 0 for k in KERNELS} | {fwd_name: 2 * cfg.n_layers, bwd_name: cfg.n_layers}
        assert kernel_launches == expect, (kernel_launches, expect)
        errs = {path: _rel(g, w) for (path, g), (_, w) in zip(got, want, strict=True)}
        # The float32 gradient beside both: the bf16 ones wait on the host.
        got, want = [(path, g.cpu()) for path, g in got], [(path, w.cpu()) for path, w in want]
        params32 = _upcast(params)
        del params
        with plain_kernels(), moe_routing(replay=choices, flips=flips32):
            f32_loss, exact = param_grads(cfg, params32, batch)
        del params32
        kern32 = {path: _rel(g.to(DEVICE), e) for (path, g), (_, e) in zip(got, exact, strict=True)}
        plain32 = {path: _rel(w.to(DEVICE), e) for (path, w), (_, e) in zip(want, exact, strict=True)}
        worst = max(errs, key=errs.get)
        windows = sorted(set(tf.layer_window_values(cfg)))
        routing = ""
        if choices:
            tokens = sum(int(c.shape[0] * c.shape[1]) for c in choices)
            routing = (f"; routing replayed from the kernel side ({len(choices)} router calls, {tokens} tokens): "
                       f"without the replay the bf16 plain side would flip {sum(flips)} tokens' choice "
                       f"(per call {flips}), the float32 side {sum(flips32)} ({flips32})")
        print(f"  {name}, {cfg.n_layers} layers (windows {windows}), 1 x {seq}, bf16: loss {loss:.6f} "
              f"vs plain {plain_loss:.6f} (float32 plain {f32_loss:.6f}); gradient of {len(errs)} leaves, largest "
              f"error over norm {errs[worst]:.3e} ({worst}), tol {PROD_GRAD_TOL:.3e}; against the float32 plain "
              f"gradient: kernels {max(kern32.values()):.3e}, bf16 plain {max(plain32.values()):.3e}{routing}; "
              f"launches {kernel_launches}; {time.perf_counter() - t0:.2f} s")
        if errs[worst] > PROD_GRAD_TOL or abs(loss - plain_loss) > PROD_GRAD_TOL * abs(plain_loss):
            raise AssertionError(f"{name}: the kernels' bf16 gradient disagrees with the plain versions'")
        out[name] = {"layers": cfg.n_layers, "seq": seq, "worst_leaf": worst, "worst_rel_err": errs[worst],
                     "kernels_vs_f32": max(kern32.values()), "bf16_plain_vs_f32": max(plain32.values()),
                     "routing_flips_bf16": sum(flips), "routing_flips_f32": sum(flips32)}
        del got, want, exact, choices
        torch.cuda.empty_cache()
    return out


def _upcast(params):
    return tree_unflatten(params, [p.float() for _, p in leaves_with_paths(params)])


def phase_prod_times(calls: Counter, shapes=PROD_FLASH_SHAPES, steps: int = PROD_TIMED + 1) -> dict[str, list[dict]]:
    """flash_attention and its backward at each bf16 shape of the
    production train path: kernel (eager, graph), plain version, SDPA's
    forward and backward, bounds at the bf16 rate (and the backward's
    wgmma route beside its own floor, eight products at that rate).
    ``calls`` over ``steps`` steps of each model give the calls a step (of
    every model that makes them)."""
    out = {"flash_attention": [], "flash_attention_bwd": []}
    print("times at the bf16 production train shapes (ms per call, CUDA events):")
    for key in shapes:
        dtype = torch.bfloat16
        n_fwd = calls["flash_attention", key, dtype] // steps
        n_bwd = calls["flash_attention_bwd", key, dtype] // steps
        q, k, v = flash_operands(key, dtype, seed=0)
        do = torch.randn(q.shape, generator=torch.Generator().manual_seed(1)).to(dtype).to(DEVICE)
        scale, window = key[4] ** -0.5, key[5]
        o = causal_attention(q, k, v, scale=scale, window=window)
        fwd = lambda: causal_attention(q, k, v, scale=scale, window=window)  # noqa: E731
        bwd = lambda: causal_attention_bwd(q, k, v, o, do, scale=scale, window=window)  # noqa: E731
        f_bound, f_by = flash_bound(key, dtype)
        b_bound, b_by = bwd_bound(key, dtype)
        f = {"shape": list(key), "dtype": "bfloat16", "route": route(dtype, key[4]), "calls_a_step": n_fwd,
             "ms": time_ms(fwd, 20), "graph_ms": time_graph_ms(fwd, calls=10, replays=5),
             "plain_ms": time_ms(lambda: causal_attention_plain(q, k, v, scale=scale, window=window), 3, warmup=1),
             "library_ms": time_ms(sdpa_call(q, k, v, scale, window), 20),
             "bound_ms": f_bound, "bound_by": f_by}
        b = {"shape": list(key), "dtype": "bfloat16", "route": bwd_route(dtype, key[4]), "calls_a_step": n_bwd,
             "ms": time_ms(bwd, 10, warmup=2), "graph_ms": time_graph_ms(bwd, calls=5, replays=3),
             "plain_ms": time_ms(lambda: causal_attention_bwd_plain(q, k, v, o, do, scale=scale, window=window),
                                 3, warmup=1),
             "library_ms": time_ms(sdpa_bwd_call(q, k, v, do, scale, window), 10, warmup=2),
             "bound_ms": b_bound, "bound_by": b_by, "floor_ms": bwd_floor(key, dtype)}
        print(f"  (B,S,H,KV,hd,window)={key} bf16, {f['route']}, {n_fwd} calls a step: kernel={f['ms']:.6f} "
              f"graph={f['graph_ms']:.6f} plain={f['plain_ms']:.6f} sdpa={f['library_ms']:.6f} "
              f"bound={f_bound:.6f} ({f_by}, bf16) graph share={f_bound / f['graph_ms']:.4%} "
              f"kernel / sdpa={f['ms'] / f['library_ms']:.3f}")
        print(f"    backward, {b['route']}, {n_bwd} calls a step: kernel={b['ms']:.6f} graph={b['graph_ms']:.6f} "
              f"plain={b['plain_ms']:.6f} sdpa_backward={b['library_ms']:.6f} bound={b_bound:.6f} ({b_by}, bf16) "
              f"graph share={b_bound / b['graph_ms']:.4%}; eight-product floor={b['floor_ms']:.6f} "
              f"graph share={b['floor_ms'] / b['graph_ms']:.4%}; "
              f"kernel / sdpa_backward={b['ms'] / b['library_ms']:.3f} graph / sdpa_backward="
              f"{b['graph_ms'] / b['library_ms']:.3f}")
        out["flash_attention"].append(f)
        out["flash_attention_bwd"].append(b)
        del q, k, v, o, do
    return out


def phase_prod_wkv_times(calls: Counter, steps: int) -> dict[str, list[dict]]:
    """wkv6 and its backward at each bf16 shape of the production train
    path: kernel (eager, graph), plain version, bound (no single PyTorch
    call computes the function)."""
    out = {"wkv6": [], "wkv6_bwd": []}
    print("times of wkv6 and wkv6_bwd at the bf16 production train shapes (ms per call, CUDA events):")
    for key in dict.fromkeys(key for (k, key, dt) in calls if k == "wkv6" and dt == torch.bfloat16):
        dtype = torch.bfloat16
        args = wkv_grad_operands(key, dtype, 0, False, "mild")
        fwd = lambda: wkv6(*args[:6])  # noqa: E731
        bwd = lambda: wkv6_bwd(*args)  # noqa: E731
        f_bound, f_by = wkv_bound(key, dtype)
        b_bound, b_by = wkv_bwd_bound(key, dtype)
        f = {"shape": list(key), "dtype": "bfloat16", "route": wkv_route(dtype, key[3]),
             "calls_a_step": calls["wkv6", key, dtype] // steps,
             "ms": time_ms(fwd, 10, warmup=2), "graph_ms": time_graph_ms(fwd, calls=5, replays=3),
             "plain_ms": time_ms(lambda: wkv6_plain(*args[:6]), 1, warmup=0), "library_ms": None,
             "bound_ms": f_bound, "bound_by": f_by}
        b = {"shape": list(key), "dtype": "bfloat16", "calls_a_step": calls["wkv6_bwd", key, dtype] // steps,
             "ms": time_ms(bwd, 10, warmup=2), "graph_ms": time_graph_ms(bwd, calls=5, replays=3),
             "plain_ms": time_ms(lambda: wkv6_bwd_plain(*args), 1, warmup=0), "library_ms": None,
             "bound_ms": b_bound, "bound_by": b_by}
        for name, r in (("wkv6", f), ("wkv6_bwd", b)):
            print(f"  {name} (B,T,H,hd)={key} bf16, {r['calls_a_step']} calls a step: kernel={r['ms']:.6f} "
                  f"graph={r['graph_ms']:.6f} plain={r['plain_ms']:.6f} library=none bound={r['bound_ms']:.6f} "
                  f"({r['bound_by']}) graph share={r['bound_ms'] / r['graph_ms']:.4%}; {card_line()}")
            out[name].append(r)
        del args
    return out


# --------------------------------------------------------------------------
# SwapLess simulators, plan evaluator and online controller on the card: the
# reference's jitted recurrences (ROADMAP B1-B5), ported as torch ops
# --------------------------------------------------------------------------
SIM_HW = EDGE_TPU_PLATFORM
SWAP_BATCH = DisciplineSpec(kind="swap_batch", batch_cap=64)
LINDLEY_SIZES = (7, 4097, 1 << 20)      # 2^20 is the replica engine's size
DELAY_TOL = 2e-6                        # tests/test_jax_sim.py, seconds of delay
STAT_REL = 1e-4                         # means and p99, torch vs stepper backend
BACKEND_REQUESTS = 6000
REPLICA_REQUESTS, REPLICAS = 1 << 20, 32
# benchmarks/jax_throughput.py::_RATES: collab8 at ~0.6 TPU utilization (at
# 25 req/s per tenant its 4 full-TPU squeezenets would saturate the queue).
REPLICA_RATES = [2.4] * 4 + [15.0] * 4
REPLICA_REL = 2e-4
EVAL_RTOL = 5e-5
# benchmarks/fig8_dynamic.py: mnasnet + inceptionv4, seed 5.
FIG8_MODELS = ("mnasnet", "inceptionv4")
FIG8_PHASES = [
    RatePhase(0.0, 300.0, (5.0, 1.0)),
    RatePhase(300.0, 600.0, (5.0, 3.0)),
    RatePhase(600.0, 900.0, (5.0, 5.0)),
]
FIG8_KW = dict(replan_period=30.0, window=30.0, initial_rates=(5.0, 1.0))


def sim_mixes() -> dict[str, tuple[list[TenantSpec], Plan]]:
    """benchmarks/sim_throughput.py::_mixes, without its size caps."""
    sq, mb = paper_profile("squeezenet"), paper_profile("mobilenetv2")
    eff, gpu = paper_profile("efficientnet"), paper_profile("gpunet")
    mn = paper_profile("mnasnet")
    collab_profiles = [sq] * 4 + [mb] * 4
    collab = Plan(tuple([sq.num_partition_points] * 4 + [1] * 4), tuple([0] * 4 + [1] * 4))
    thrash_profiles = [sq, mb, mn, eff] * 4
    thrash = Plan(tuple(p.num_partition_points for p in thrash_profiles), tuple(0 for _ in thrash_profiles))
    mixes = {
        "collab8": ([TenantSpec(p, 1.0) for p in collab_profiles], collab),
        "swap2": ([TenantSpec(p, 1.0) for p in (eff, gpu)], Plan((6, 5), (0, 0))),
        "thrash16": ([TenantSpec(p, 1.0) for p in thrash_profiles], thrash),
    }
    for ts, plan in mixes.values():
        validate_plan(plan, ts, SIM_HW.cpu.n_cores)
    return mixes


def poisson_columns(rates, n_req, seed) -> Trace:
    """Merged-Poisson trace with per-model rates (sorted, unit scale), as
    tests/test_jax_sim.py and benchmarks/jax_throughput.py draw it."""
    rng = np.random.default_rng(seed)
    lam = float(sum(rates))
    arr = np.cumsum(rng.exponential(1.0 / lam, n_req))
    mi = rng.choice(len(rates), size=n_req, p=np.asarray(rates) / lam).astype(np.int64)
    return Trace(mi, arr)


@contextlib.contextmanager
def capturing(module, name: str, calls: list):
    """Record the arguments of every call to ``module.name`` (a torch-op
    function of the port) while the block runs, so that the call can be
    timed alone at the shapes its path gave it."""
    fn = getattr(module, name)

    def rec(*args, **kwargs):
        calls.append((args, kwargs))
        return fn(*args, **kwargs)

    setattr(module, name, rec)
    try:
        yield fn
    finally:
        setattr(module, name, fn)


def device_activity(fn) -> dict:
    """Kernels and copies the profiler saw on the card during one call of
    ``fn`` (after a warm call); ``None`` counts where it saw nothing."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    for _ in range(2):   # the profiler now and then reports an empty cycle
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = copies = 0
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                if e.name.startswith(("Memcpy", "Memset")):
                    copies += 1
                else:
                    kernels += 1
        if kernels:
            return {"kernels": kernels, "copies": copies}
    return {"kernels": None, "copies": None}


def op_bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """Least time (ms) for float32 work: bytes at the memory rate or
    operations at the float32 peak, whichever is longer."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS_PER_S[torch.float32] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*xs) -> int:
    return sum(x.numel() * x.element_size() for x in xs if isinstance(x, torch.Tensor))


def timed_host(fn, reps: int = 1):
    """(result, best host ms over ``reps``)."""
    best, out = math.inf, None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return out, best


def op_entry(replaces: str, fn, n_bytes: float, n_ops: float, host_ms: float, iters: int, **extra) -> dict:
    """One torch_ops row: device time per call (CUDA events), launches per
    call (profiler), the bound, and the host NumPy time of the same work."""
    ms = time_ms(fn, iters, warmup=2)
    bound_ms, bound_by = op_bound(n_bytes, n_ops)
    return {
        "replaces": replaces, "ms": ms, **device_activity(fn), "bound_ms": bound_ms,
        "bound_by": bound_by, "bound_share": bound_ms / ms, "host_numpy_ms": host_ms, **extra,
    }


def phase_lindley() -> dict:
    """``lindley_ends`` on the card against the float64 ``_server_ends``;
    returns B1's row, timed at 2^20 requests."""
    row = None
    torch_stepper.lindley_ends(np.arange(4.0), np.ones(4), 0.0, device=DEVICE)   # context and allocator warm-up
    for n in LINDLEY_SIZES:
        rng = np.random.default_rng(n)
        enq = np.cumsum(rng.exponential(0.005, n))   # 200 req/s: 2^20 requests reach ~5,240 s
        svc = rng.exponential(0.004, n)               # utilization 0.8
        calls = []
        with capturing(torch_stepper, "_delays", calls):
            got, card_ms = timed_host(lambda: torch_stepper.lindley_ends(enq, svc, 0.0, device=DEVICE))
        want, host_ms = timed_host(lambda: _server_ends(enq, svc, 0.0))
        err = float(np.abs((got - enq) - (want - enq)).max())
        print(f"  lindley_ends n={n}: clock {enq[-1]:.1f} s, max |delay - float64| = {err:.3e} s "
              f"(tol {DELAY_TOL}); card {card_ms:.3f} ms with copies, _server_ends {host_ms:.3f} ms")
        if not err <= DELAY_TOL:
            raise AssertionError(f"lindley_ends at n={n} is {err:.3e} s off the float64 recurrence")
        if n == LINDLEY_SIZES[-1]:
            (args, _), = calls
            a, b, x_init, c, l = args
            row = op_entry(
                "src/repro/serving/jax_stepper.py:88", lambda: torch_stepper._delays(a, b, x_init, c, l),
                n_bytes=3 * a.numel() * 4, n_ops=2 * a.numel(), host_ms=host_ms, iters=20,
                shape=[int(a.shape[0]), c, l], max_abs_err_s=err, call_with_copies_ms=card_ms,
            )
    return row


def phase_backends() -> dict:
    """``simulate(backend="torch")`` against the stepper on the three mixes."""
    out = {}
    for name, (ts, plan) in sim_mixes().items():
        trace = poisson_columns([2.0] * len(ts), BACKEND_REQUESTS, seed=11)
        want, host_ms = timed_host(lambda: simulate(ts, plan, SIM_HW, trace, warmup_frac=0.0))
        got, card_ms = timed_host(lambda: simulate(ts, plan, SIM_HW, trace, warmup_frac=0.0, backend="torch", device=DEVICE))
        worst = 0.0
        assert got.misses == want.misses and got.tpu_requests == want.tpu_requests, name
        for m in range(len(ts)):
            assert len(got.latencies[m]) == len(want.latencies[m]), (name, m)
            assert np.array_equal(got.arrivals[m], want.arrivals[m]), (name, m)
            for stat in ("mean_latency", "p99"):
                a, b = getattr(want, stat)(m), getattr(got, stat)(m)
                worst = max(worst, abs(b - a) / abs(a))
                if not math.isclose(b, a, rel_tol=STAT_REL, abs_tol=1e-6):
                    raise AssertionError(f"{name} model {m} {stat}: torch {b} vs stepper {a}")
        print(f"  {name}: {BACKEND_REQUESTS} requests, integer observables equal, worst mean/p99 "
              f"rel diff {worst:.3e} (tol {STAT_REL}); torch backend {card_ms:.1f} ms, stepper {host_ms:.1f} ms")
        out[name] = {"worst_rel": worst, "torch_ms": card_ms, "stepper_ms": host_ms}
    return out


def phase_replicas() -> dict:
    """The Monte-Carlo replica engine at the reference benchmark's headline
    size: parity on two replicas, then throughput against the NumPy
    stepper; returns the engine's numbers and B2's and B3's rows."""
    ts, plan = sim_mixes()["collab8"]
    profs = [t.profile for t in ts]
    trace = poisson_columns(REPLICA_RATES, REPLICA_REQUESTS, seed=0)
    scales = np.random.default_rng(1).uniform(0.8, 1.25, size=(REPLICAS, len(profs)))
    mi = trace.model_idx

    stats = make_backend("torch", profs, plan, SIM_HW, device=DEVICE).run_trace_replicas(trace, scales[:2])
    worst = 0.0
    for r in range(2):
        want = simulate(ts, plan, SIM_HW, Trace(mi, trace.arrival, scales[r][mi]), warmup_frac=0.0)
        assert list(stats.misses) == want.misses
        assert math.isclose(stats.tpu_busy[r], want.tpu_busy, rel_tol=1e-4)
        for m in range(len(profs)):
            assert stats.counts[m] == len(want.latencies[m])
            a = want.mean_latency(m)
            worst = max(worst, abs(stats.mean_latency[r, m] - a) / a)
            if not math.isclose(stats.mean_latency[r, m], a, rel_tol=REPLICA_REL):
                raise AssertionError(f"replica {r} model {m}: {stats.mean_latency[r, m]} vs {a}")
    print(f"  parity on 2 replicas x {REPLICA_REQUESTS} requests: worst mean rel diff {worst:.3e} (tol {REPLICA_REL}), "
          f"counts, misses and busy equal")

    sim = make_backend("torch", profs, plan, SIM_HW, device=DEVICE)
    tpu_calls, cpu_calls = [], []
    with capturing(torch_stepper, "_tpu_replicas", tpu_calls), capturing(torch_stepper, "_cpu_replicas", cpu_calls):
        sim.run_trace_replicas(trace, scales)     # first run: allocator warm-up
    walls, events = [], []
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        sim.run_trace_replicas(trace, scales)
        end.record()
        walls.append(time.perf_counter() - t0)
        end.synchronize()
        events.append(start.elapsed_time(end) / 1e3)
    t0 = time.perf_counter()
    for r in range(REPLICAS):
        simulate(ts, plan, SIM_HW, Trace(mi, trace.arrival, scales[r][mi]), warmup_frac=0.0)
    numpy_s = time.perf_counter() - t0
    work = REPLICA_REQUESTS * REPLICAS
    engine = {
        "n_requests": REPLICA_REQUESTS, "n_replicas": REPLICAS, "card_wall_s": min(walls),
        "card_events_s": min(events), "numpy_stepper_s": numpy_s,
        "card_replica_requests_per_s": work / min(walls), "numpy_replica_requests_per_s": work / numpy_s,
        "parity_worst_rel": worst,
    }
    print(f"  run_trace_replicas on the card: {min(walls):.4f} s wall, {min(events):.4f} s between CUDA events "
          f"(best of 3) = {work / min(walls):.4g} replica-requests/s; NumPy stepper over the {REPLICAS} replicas "
          f"{numpy_s:.3f} s = {work / numpy_s:.4g} replica-requests/s ({numpy_s / min(walls):.2f}x)")

    (args, _), = tpu_calls
    base, miss_load, g, tm, sc, x_init, c, l, n_models = args
    r_, p_ = REPLICAS, base.numel()
    b2 = op_entry(
        "src/repro/serving/jax_stepper.py:161", lambda: torch_stepper._tpu_replicas(*args),
        n_bytes=nbytes(base, miss_load, g, tm, sc, x_init) + 4 * r_ * p_ + 8 * r_ * n_models + 8 * r_,
        n_ops=4 * r_ * p_, host_ms=numpy_s * 1e3, iters=5, shape=[r_, c, l],
        note="host_numpy_ms is the whole NumPy stepper over the replicas",
    )
    (args3, _) = cpu_calls[0]
    d_tpu, sel, g_host, svc, x0, c3, l3 = args3
    n_i = sel.numel()
    b3 = op_entry(
        "src/repro/serving/jax_stepper.py:184", lambda: torch_stepper._cpu_replicas(*args3),
        n_bytes=nbytes(sel, g_host, svc) + 2 * 4 * r_ * n_i + 8 * r_, n_ops=4 * r_ * n_i,
        host_ms=None, iters=10, shape=[r_, c3, l3], calls_per_run=len(cpu_calls),
    )
    for key, row in (("B2", b2), ("B3", b3)):
        print(f"  {key}: {row['ms']:.4f} ms a call on the card, {row['kernels']} kernels + {row['copies']} copies, "
              f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}, {row['bound_share']:.2%})")
    device_breakdown("B2, one call", lambda: torch_stepper._tpu_replicas(*args))
    return {"engine": engine, "B2": b2, "B3": b3}


def feasible_plans(ts, k_max, n_plans=48, seed=2):
    rng = np.random.default_rng(seed)
    p_max = np.array([t.profile.num_partition_points for t in ts])
    P = rng.integers(0, p_max + 1, size=(n_plans, len(ts)))
    K = np.zeros_like(P)
    keep = np.ones(n_plans, dtype=bool)
    for b in range(n_plans):
        try:
            K[b] = prop_alloc(ts, P[b], k_max)
        except ValueError:
            keep[b] = False
    return P[keep], K[keep]


def phase_evaluator() -> dict:
    """``TorchPlanEvaluator`` on the card against the NumPy batch, and
    ``hill_climb(evaluator=...)`` against the NumPy batched climb; returns
    B4's and B5's rows, timed per frontier call of the warm climb."""
    rows = {}
    extensions = 0
    for name, (base_ts, _) in sim_mixes().items():
        rates = np.random.default_rng(1).uniform(0.5, 4.0, len(base_ts))
        ts = [TenantSpec(t.profile, float(r), deadline=0.5) for t, r in zip(base_ts, rates)]
        k_max = max(4, len(ts))
        et = EvalTables.build(ts, SIM_HW, k_max)
        ev = TorchPlanEvaluator.from_tables(et, device=DEVICE)
        P, K = feasible_plans(ts, k_max)
        for disc in (FCFS, SWAP_BATCH):
            want = latency.objective_batch(ts, P, K, SIM_HW, tables=et, discipline=disc)
            got = ev.objective_batch(P, K, discipline=disc)
            finite = np.isfinite(want)
            err = float(np.max(np.abs(got[finite] / want[finite] - 1.0)))
            if not (np.array_equal(np.isinf(want), np.isinf(got)) and err <= EVAL_RTOL):
                raise AssertionError(f"{name} {disc.kind}: evaluator off the NumPy batch by {err:.3e}")
            print(f"  {name} {disc.kind}: {len(P)} plans, max rel diff {err:.3e} (rtol {EVAL_RTOL})")
        # A deadline-miss value is a rate-weighted sum of probabilities formed
        # as 1 - (1 - p)(1 - q): float32 leaves ~1e-7 of each, so that sum
        # (total rate ~16/s here) is held to 1e-6 absolute as well (the
        # reference's JaxPlanEvaluator is off the NumPy batch by as much).
        for obj, atol in ((p_tail(0.99), 1e-7), (deadline_miss(), 1e-6)):
            want = latency.penalized_objective_batch(ts, P, K, SIM_HW, tables=et, objective=obj)
            got = ev.penalized_objective_batch(P, K, objective=obj, deadlines=np.full(len(ts), 0.5))
            if not np.allclose(got, want, rtol=EVAL_RTOL, atol=atol):
                raise AssertionError(f"{name} {obj.kind}: evaluator off the NumPy batch")
        cold, _ = hill_climb(ts, SIM_HW, k_max, tables=et, batch=True)
        calls = []
        with capturing(ev, "penalized_objective_batch", calls):
            cold_dev, _ = hill_climb(ts, SIM_HW, k_max, evaluator=ev)
            warm_dev, _ = hill_climb(ts, SIM_HW, k_max, evaluator=ev, init_plan=cold)
        warm, _ = hill_climb(ts, SIM_HW, k_max, tables=et, batch=True, init_plan=cold)
        sb, _ = hill_climb(ts, SIM_HW, k_max, tables=et, batch=True, discipline=SWAP_BATCH)
        sb_dev, _ = hill_climb(ts, SIM_HW, k_max, evaluator=ev, discipline=SWAP_BATCH)
        if (cold_dev, warm_dev, sb_dev) != (cold, warm, sb):
            raise AssertionError(f"{name}: hill_climb on the card committed other plans")
        print(f"  {name}: hill_climb plans identical cold, warm and under swap_batch ({len(calls)} calls "
              f"in the cold + warm climbs)")
        # Per frontier call: the largest batch the climbs scored, a full
        # frontier of [4n, n] plans from the warm climb.
        (fp, fk), _ = max(calls, key=lambda call: len(call[0][0]))
        n_bytes = nbytes(ev.pstack, ev.pkstack, ev.rates, ev.svc_tab, ev.tl_tab) + 2 * fp.size * 8 + 2 * len(fp) * 4
        for disc, key in ((FCFS, "fcfs"), (SWAP_BATCH, "swap_batch")):
            _, host_ms = timed_host(lambda: latency.penalized_objective_batch(
                ts, fp, fk, SIM_HW, tables=et, discipline=disc), reps=5)
            before = ev.extensions
            _, wall_ms = timed_host(lambda: ev.penalized_objective_batch(fp, fk, discipline=disc))
            extended = ev.extensions > before
            # About 30 float32 operations per tenant per sweep: one sweep for
            # FCFS, 62 (+ 541 when extended) for swap_batch.
            sweeps = 1 if key == "fcfs" else 62 + 541 * extended
            rows[f"B4 {name} {key}"] = op_entry(
                "src/repro/core/jax_eval.py:186",
                lambda: ev.penalized_objective_batch(fp, fk, discipline=disc),
                n_bytes=n_bytes, n_ops=sweeps * fp.size * 30, host_ms=host_ms, iters=5,
                shape=list(fp.shape), call_wall_ms=wall_ms, extended=bool(extended),
            )
        obj = p_tail(0.99)
        _, host_ms = timed_host(lambda: latency.penalized_objective_batch(
            ts, fp, fk, SIM_HW, tables=et, objective=obj), reps=5)
        _, wall_ms = timed_host(lambda: ev.penalized_objective_batch(fp, fk, objective=obj), reps=5)
        rows[f"B5 {name} p_tail"] = op_entry(
            "src/repro/core/jax_eval.py:102", lambda: ev.penalized_objective_batch(fp, fk, objective=obj),
            n_bytes=n_bytes + nbytes(ev.ix_tab, ev.bnd_tab, ev.s1c_tab, ev.npoints), n_ops=fp.size * 60,
            host_ms=host_ms, iters=10, shape=list(fp.shape), call_wall_ms=wall_ms,
        )
        if name == "thrash16":
            device_breakdown("B4 thrash16 swap_batch, one frontier call",
                             lambda: ev.penalized_objective_batch(fp, fk, discipline=SWAP_BATCH))
        extensions += ev.extensions
    # A mix whose damped fixed point does not settle in 60 sweeps
    # (tests/test_torch_eval.py::test_swap_batch_extension): the masked
    # 540-sweep extension runs on the card.  Row 0 is inf in float32 (as in
    # the reference's JaxPlanEvaluator) where float64 settles; the others
    # agree with the NumPy batch.
    ts = [TenantSpec(paper_profile(n), r) for n, r in zip(
        ("mnasnet", "mobilenetv2", "efficientnet"), (33.952794612593195, 15.90244329367047, 14.879704988613526))]
    et = EvalTables.build(ts, SIM_HW, 4)
    p_max = np.array([t.profile.num_partition_points for t in ts])
    P = np.stack([p_max, p_max - 1, np.maximum(p_max - 2, 0)])
    K = np.stack([prop_alloc(ts, row, 4) for row in P])
    ev = TorchPlanEvaluator.from_tables(et, device=DEVICE)
    got = ev.objective_batch(P, K, discipline=SWAP_BATCH)
    want = latency.objective_batch(ts, P, K, SIM_HW, tables=et, discipline=SWAP_BATCH)
    if not (ev.extensions == 1 and np.isinf(got[0]) and np.allclose(got[1:], want[1:], rtol=EVAL_RTOL)):
        raise AssertionError(f"extension case: {got} on the card, NumPy {want}, extensions {ev.extensions}")
    print(f"  extension case: the 540-sweep extension ran; {got} against NumPy {want}")
    extensions += ev.extensions
    for key, row in rows.items():
        print(f"  {key} {row['shape']}: {row['ms']:.4f} ms a call on the card (CUDA events), {row['call_wall_ms']:.4f} ms "
              f"wall with copies; {row['kernels']} kernels + {row['copies']} copies; NumPy {row['host_numpy_ms']:.4f} ms; "
              f"bound {row['bound_ms']:.2e} ms ({row['bound_by']})")
    print(f"  calls that ran the 540-sweep extension: {extensions}")
    rows["extension_calls"] = extensions
    return rows


def phase_online() -> dict:
    """``run_adaptive`` on the Fig. 8 trace: the device stepper and a
    planner scoring each frontier on the card, against the defaults (host
    stepper, NumPy planner)."""
    profs = [paper_profile(n) for n in FIG8_MODELS]
    trace = dynamic_trace(FIG8_PHASES, seed=5)
    k_max = SIM_HW.cpu.n_cores

    def planner(tenants, platform, k, *, tables=None, init_plan=None):
        ev = TorchPlanEvaluator.build(tenants, platform, k, tables=tables, device=DEVICE)
        return hill_climb(tenants, platform, k, evaluator=ev, init_plan=init_plan)

    want, host_ms = timed_host(lambda: run_adaptive(profs, trace, SIM_HW, k_max, **FIG8_KW))
    got, card_ms = timed_host(lambda: run_adaptive(
        profs, trace, SIM_HW, k_max, backend="torch", device=DEVICE, planner=planner, **FIG8_KW))
    if got.replan_times != want.replan_times or got.plans != want.plans:
        raise AssertionError("run_adaptive on the card re-planned differently")
    worst = 0.0
    for m in range(len(profs)):
        a, b = want.sim.mean_latency(m), got.sim.mean_latency(m)
        worst = max(worst, abs(b - a) / a)
        if not math.isclose(b, a, rel_tol=STAT_REL):
            raise AssertionError(f"model {m}: mean {b} on the card vs {a}")
    out = {
        "replans": len(got.plans), "worst_mean_rel": worst,
        "card_max_planner_ms": max(got.plan_compute_seconds) * 1e3,
        "card_median_planner_ms": float(np.median(got.plan_compute_seconds)) * 1e3,
        "numpy_max_planner_ms": max(want.plan_compute_seconds) * 1e3,
        "numpy_median_planner_ms": float(np.median(want.plan_compute_seconds)) * 1e3,
        "card_run_ms": card_ms, "host_run_ms": host_ms,
    }
    print(f"  {len(got.plans)} re-plans, identical times and plans; worst per-model mean rel diff {worst:.3e}; "
          f"planner ms per re-plan, max / median: card evaluator {out['card_max_planner_ms']:.3f} / "
          f"{out['card_median_planner_ms']:.3f}, NumPy {out['numpy_max_planner_ms']:.3f} / "
          f"{out['numpy_median_planner_ms']:.3f}; whole run {card_ms:.1f} ms (torch backend) vs {host_ms:.1f} ms (stepper)")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    def phase(title, fn, *args):
        t0 = time.perf_counter()
        print(f"== {title}")
        result = fn(*args)
        print(f"== {title}: {time.perf_counter() - t0:.2f} s")
        return result

    kind = phase("device", phase_device)
    planner, plans = start_plans()
    try:
        return run_phases(phase, kind, planner, plans, t_start)
    finally:
        planner.shutdown(cancel_futures=True)


def run_phases(phase, kind: str, planner: ProcessPoolExecutor, plans: dict, t_start: float) -> int:
    """Every phase after the device's, in order (``main``)."""
    phase("build", phase_build)
    matmul_hgmma = phase("tensor cores: HGMMA in the block_matmul library", phase_tensor_cores, "block_matmul", "HGMMA")
    hgmma = phase("tensor cores: HGMMA in the flash_attention library", phase_tensor_cores, "flash_attention", "HGMMA",
                  {rf"tc12flash_kernelILi{hd}E": FLASH_TC_HGMMA[hd] for hd in TENSOR_CORE_HEAD_DIMS})
    # Every split-TF32 instantiation (float32 at each head_dim, bfloat16 at
    # 16 and 32) runs mma.sync.
    n_mma = sum(route(dt, hd) == "tf32-mma" for dt in (torch.float32, torch.bfloat16) for hd in fa_mod.HEAD_DIMS)
    fwd_hmma = phase("tensor cores: HMMA in the flash_attention library", phase_tensor_cores, "flash_attention",
                     "HMMA", None, {FWD_MMA_KERNEL: n_mma})
    fwd_resources = phase("flash_attention: registers, spills, shared memory", phase_fwd_resources)
    # Each chunk-kernel instantiation (r, k, v and w in float32 or bfloat16)
    # runs mma.sync, its pinned count; the token kernel has none.
    hmma = phase("tensor cores: HMMA in the wkv6 library", phase_tensor_cores, "wkv6", "HMMA",
                 None, {WKV_CHUNK_KERNEL: 4}, wkv_hmma_pins())
    wkv_resources = phase("wkv6: registers, spills, shared memory", phase_wkv6_resources)
    # Every split-TF32 instantiation (float32 at 6 head_dims, bfloat16 at 2)
    # of the backward's product kernels runs mma.sync; the reduction kernel
    # has no product; the wgmma ones (tc::) are pinned below.
    n_bwd_mma = sum(bwd_route(dt, hd) == "tf32-mma" for dt in (torch.float32, torch.bfloat16)
                    for hd in fa_mod.HEAD_DIMS)
    bwd_hmma = phase("tensor cores: HMMA in the flash_attention_bwd library", phase_tensor_cores,
                     "flash_attention_bwd", "HMMA", None,
                     {rf"(?<!2tc){len(n)}{n}I": n_bwd_mma for n in BWD_PRODUCT_KERNELS})
    # The split-TF32 dQ's do v^T runs on the FP64 tensor cores (mma.m8n8k4.f64).
    bwd_dmma = phase("tensor cores: DMMA in the flash_attention_bwd library", phase_tensor_cores,
                     "flash_attention_bwd", "DMMA", None, {r"(?<!2tc)9dq_kernelI": n_bwd_mma})
    # Each wgmma instantiation (bfloat16 at 64, 96, 128, 256) its count.
    bwd_hgmma = phase("tensor cores: HGMMA in the flash_attention_bwd library", phase_tensor_cores,
                      "flash_attention_bwd", "HGMMA",
                      {rf"2tc{len(n)}{n}ILi{hd}E": c for n, by_hd in BWD_TC_HGMMA.items() for hd, c in by_hd.items()})
    bwd_resources = phase("flash_attention_bwd: registers, spills, shared memory", phase_bwd_resources)
    # Every instantiation (4 type pairs x 4 head_dims) of the backward's two
    # product kernels runs mma.sync, each its pinned count; the scan has none.
    wkv_bwd_hmma = phase("tensor cores: HMMA in the wkv6_bwd library", phase_tensor_cores, "wkv6_bwd", "HMMA",
                         None, None, wkv_bwd_hmma_pins())
    wkv_bwd_resources = phase("wkv6_bwd: registers, spills, shared memory", phase_wkv6_bwd_resources)
    matmul_k = KERNELS[0]
    checks = {"block_matmul": phase("kernel vs plain: block_matmul", phase_kernel_vs_plain, matmul_k)}
    phase("kernel vs plain: flash_attention, test and ragged shapes", check_flash,
          FLASH_TEST_SHAPES + FLASH_RAGGED_SHAPES, (torch.float32, torch.bfloat16))
    phase("kernel vs plain: wkv6, test and ragged shapes", check_wkv6,
          WKV_TEST_SHAPES + WKV_RAGGED_SHAPES, (torch.float32, torch.bfloat16))
    phase("kernel vs plain: wkv6 at strong decays, ragged shapes", check_wkv6,
          WKV_RAGGED_SHAPES, (torch.float32, torch.bfloat16), "strong")
    plan, cnn_launches, path_routes = phase("main path: SwapLess serving of the CNN mix", phase_main_path)
    phase("where the time goes", phase_breakdown, plan)

    calls = Counter()
    launches = Counter()
    by_path = {}           # kernel -> {path: launches}: the kernels line's totals, path by path

    def on_path(label, counts):
        launches.update(counts)
        for n, v in counts.items():
            if v:
                by_path.setdefault(n, {})[label] = v

    on_path("serving the CNN mix", {"block_matmul": cnn_launches["block_matmul"]})
    zoo_launches = {}
    for name in ZOO:
        zoo_launches[name] = phase(f"model-zoo path: {name}", phase_zoo_path, name, calls)
        on_path(name, zoo_launches[name])
    print(f"model-zoo launches per path: {zoo_launches}")
    moe_graph = phase("model-zoo path: grok-1's MoE layer in a CUDA graph", phase_moe_graph)
    print("model-zoo kernel calls per prefill: " + "; ".join(
        f"{k} {key} {str(dt)[6:]} x{n}" for (k, key, dt), n in calls.items()
    ))
    for name, check in (("flash_attention", check_flash), ("wkv6", check_wkv6)):
        path_shapes = list(dict.fromkeys(key for (k, key, _), _n in calls.items() if k == name))
        path_dtypes = tuple(dict.fromkeys(dt for (k, _key, dt) in calls if k == name))
        checks[name] = {"max_abs_err": phase(
            f"kernel vs plain: {name} at the model-zoo path's shapes", check, path_shapes, path_dtypes
        )}
        phase(f"kernel vs plain: {name} at the path's shapes in float32", check, path_shapes, (torch.float32,))
        if name == "wkv6":
            phase("kernel vs plain: wkv6 at the path's shapes, strong decays", check_wkv6,
                  path_shapes, path_dtypes + (torch.float32,), "strong")
    for name in ZOO_CHECK:
        phase(f"model-zoo correctness: {name} float32", phase_zoo_check, name)
    scans = phase("model-zoo correctness: hymba's sequential scan against the kernel and the closed form",
                  phase_ssm_scans, calls)
    checks["selective_scan"] = {"max_abs_err": scans["path_max_abs_err"]}

    phase("kernel vs plain: flash_attention at the train path's shapes, and against float64", check_flash,
          TRAIN_BWD_SHAPES, (torch.float32,), True)
    phase("kernel vs plain: flash_attention_bwd, test and ragged shapes", check_flash_bwd,
          FLASH_TEST_SHAPES + FLASH_RAGGED_SHAPES + BWD_GROUP8_SHAPES, (torch.float32, torch.bfloat16))
    checks["flash_attention_bwd"] = {"max_abs_err": phase(
        "kernel vs plain: flash_attention_bwd at the train path's shapes", check_flash_bwd,
        TRAIN_BWD_SHAPES, (torch.float32,), True)}
    for decays in ("mild", "strong"):
        phase(f"kernel vs plain: wkv6 per row at the train path's shape, {decays} decays, and against float64",
              check_wkv6_rows, WKV_TRAIN_SHAPE, decays)
    for decays in ("mild", "strong"):
        phase(f"kernel vs plain: wkv6_bwd, test and ragged shapes, {decays} decays", check_wkv6_bwd,
              WKV_TEST_SHAPES + WKV_RAGGED_SHAPES, (torch.float32, torch.bfloat16), decays)
    phase("kernel vs plain: wkv6_bwd at the train path's shape in bfloat16", check_wkv6_bwd,
          [WKV_TRAIN_SHAPE], (torch.bfloat16,), "strong")
    checks["wkv6_bwd"] = {"max_abs_err": max(
        phase(f"kernel vs plain: wkv6_bwd at the train path's shape, {decays} decays, and against float64",
              check_wkv6_bwd, [WKV_TRAIN_SHAPE], (torch.float32,), decays, True)
        for decays in ("mild", "strong"))}
    train_calls = Counter()
    train = {}
    for name in TRAIN:
        train[name] = phase(f"train path: {name}", phase_train_path, name, train_calls)
        on_path(f"train {name}", train[name]["launches"])
    print("train path kernel calls per step: " + "; ".join(
        f"{k} {key} {str(dt)[6:]} x{n // (TRAIN_TIMED + 1)}" for (k, key, dt), n in train_calls.items()
    ))
    phase("train correctness: gradients, microbatches, loss", phase_train_check)

    phase("kernel vs plain: flash_attention at the bf16 production train shapes", check_flash,
          PROD_FLASH_SHAPES, (torch.bfloat16,))
    phase("kernel vs plain: flash_attention_bwd at the bf16 production train shapes, and against float64",
          check_flash_bwd, PROD_FLASH_SHAPES, (torch.bfloat16,), True)
    mesh = make_host_mesh(1, 1)
    prod_calls = Counter()
    prod = {}
    try:
        for name in PROD_ARCHS:
            prod[name] = phase(f"production train path (bf16): {name}", phase_prod_train, name, mesh, prod_calls)
            on_path(f"production train bf16 {name}", prod[name]["launches"])
    finally:
        torch.distributed.destroy_process_group()
    print("production train path kernel calls per step: " + "; ".join(
        f"{k} {key} {str(dt)[6:]} x{n // (PROD_TIMED + 1)}" for (k, key, dt), n in prod_calls.items()
    ))
    phase("production train correctness: bf16 gradient, kernels against plain versions", phase_prod_check)

    families, fam_calls, fam_check, fam_times = phase_7g(phase, planner, plans)
    for name, rec in families.items():
        if rec["run"]:
            on_path(f"production train bf16 {name}", rec["launches"])
    dryrun = phase("dry run against the card: predicted per-rank peak and FLOPs", phase_dryrun_card)
    examples = phase("examples on the card: examples/torch_*.py at their default sizes", phase_examples)
    for name, record in examples.items():
        on_path(f"examples {name}", record["launches"])

    # wkv6's route at each (type, head_dim) it ran at on the path and in the
    # float32 full-forward check.
    wkv_routes = {
        f"{str(dt)[6:]} hd {key[3]}": wkv_route(dt, key[3])
        for (k, key, dt) in calls if k == "wkv6"
    } | {f"float32 hd {ARCHS['rwkv6-7b'].resolved_head_dim}": wkv_route(torch.float32, ARCHS['rwkv6-7b'].resolved_head_dim)}
    # flash_attention's route at each (type, head_dim) the zoo paths ran it at.
    flash_routes = {
        f"{str(dt)[6:]} hd {key[4]}": route(dt, key[4]) for (k, key, dt) in calls if k == "flash_attention"
    }
    torch_ops = {"B1": phase("torch ops: lindley_ends on the card (B1)", phase_lindley)}
    torch_ops["backends"] = phase("torch ops: simulate(backend='torch') against the stepper", phase_backends)
    torch_ops.update(phase("torch ops: the replica engine (B2, B3)", phase_replicas))
    torch_ops.update(phase("torch ops: the plan evaluator (B4, B5)", phase_evaluator))
    torch_ops["online"] = phase("torch ops: online control on the Fig. 8 trace", phase_online)
    times = {"block_matmul": phase("times: block_matmul", phase_times, matmul_k)}
    times.update(phase("times: flash_attention and wkv6", phase_zoo_times, calls))
    times["selective_scan"] = scans["path_prefill"]
    times["flash_attention_bwd"], train_forward = phase("times: flash_attention_bwd", phase_train_times, train_calls)
    times["wkv6_bwd"], wkv_train_forward = phase("times: wkv6_bwd", phase_wkv_train_times, train_calls,
                                                 train["rwkv6-7b"]["bwd_kernel_ms_per_call"])
    prod_times = phase("times: flash_attention and flash_attention_bwd at the bf16 production train shapes",
                       phase_prod_times, prod_calls)

    line = []
    for k in KERNELS:
        name = k["name"]
        assert launches[name] > 0, f"{name} was not launched on its path"
        line.append({
            "name": name,
            "route": k["route"],
            "source": k["source"],
            "replaces": k["replaces"],
            "launches": launches[name],
            "launches_by_path": by_path[name],
            "max_abs_err": checks[name]["max_abs_err"],
            **times[name],
            **({"shapes_checked": checks[name]["shapes_checked"]} if "shapes_checked" in checks[name] else {}),
            **({"sass_hgmma": matmul_hgmma, "routes": {"main path": path_routes, "kernel vs plain": checks[name]["routes"]}}
               if name == "block_matmul" else {}),
            **({"sass_hgmma": hgmma, "sass_hmma": fwd_hmma, "registers": fwd_resources["registers"],
                "smem_bytes": fwd_resources["smem_bytes"],
                "routes": flash_routes, "train_forward_f32": train_forward,
                "train_bf16": prod_times["flash_attention"] + fam_times["flash_attention"]}
               if name == "flash_attention" else {}),
            **({"sass_hmma": hmma, "routes": wkv_routes, "train_forward_f32": wkv_train_forward,
                "train_bf16": fam_times["wkv6"],
                "registers": wkv_resources["registers"], "smem_bytes": wkv_resources["smem_bytes"]}
               if name == "wkv6" else {}),
            **({"shapes": sorted({str(key) for (k2, key, _dt) in train_calls if k2 == name}),
                "sass_hmma": bwd_hmma, "sass_dmma": bwd_dmma, "sass_hgmma": bwd_hgmma,
                "registers": bwd_resources["registers"], "smem_bytes": bwd_resources["smem_bytes"],
                "routes": {f"{str(dt)[6:]} hd {key[4]}": bwd_route(dt, key[4])
                           for (k2, key, dt) in (*train_calls, *prod_calls, *fam_calls) if k2 == name},
                "train_bf16": prod_times["flash_attention_bwd"] + fam_times["flash_attention_bwd"]}
               if name == "flash_attention_bwd" else {}),
            **({"shapes": sorted({str(key) for (k2, key, _dt) in train_calls if k2 == name}),
                "registers": wkv_bwd_resources["registers"], "spills": 0,
                "smem_bytes": wkv_bwd_resources["smem_bytes"], "sass_hmma": wkv_bwd_hmma,
                "train_bf16": fam_times["wkv6_bwd"]}
               if name == "wkv6_bwd" else {}),
            **({"shapes": sorted({str(key) for (k2, key, _dt) in calls if k2 == name}),
                "prompt_times": scans["times"]}
               if name == "selective_scan" else {}),
        })
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.2f} s")
    print(json.dumps({"torch_ops": torch_ops, "ssm_scans": scans}))
    print(json.dumps({"train": train, "moe_cuda_graph": moe_graph, "production_train_bf16": prod,
                      "production_train_bf16_families": families,
                      "production_check_families": fam_check, "dryrun_vs_card": dryrun, "examples": examples}))
    print(json.dumps({"kernels": line}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
