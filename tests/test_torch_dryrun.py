"""The port's dry run (``repro_torch.launch.dryrun``) and what it rests on,
against the JAX package's.

* Arguments at full size: rank 0's argument bytes of every arch x input
  shape on both production meshes and grok-1's 32 x 8 one equal the
  per-device shard bytes that the reference's own bundles name, read
  through ``NamedSharding.shard_shape`` on a JAX ``AbstractMesh``.
* The skip: the reference's ``run_one`` of a long-context pair (in a
  subprocess, as ``tests/test_dryrun.py`` runs it) writes the port's
  record; every full-attention arch's ``long_500k`` is skipped and nothing
  else.
* The hand kernels' fake forms: the plain versions' shapes, dtypes and
  ``FlopCounterMode`` counts, no launch, and no plain version reached.
* Memory: a handmade function's peak is its hand-summed live bytes; a
  prefill whose plain scores would dominate peaks below them.
* MoE: the expert products at the reference's static capacity.
* Reduced sweep: every reduced arch's train, prefill and decode steps on a
  fake 2 x 2 mesh count, and no process group is left.
* The command line.

Token ids are the port's int64 where the reference's are int32; the
argument comparison counts them at the port's width.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import INPUT_SHAPES as REF_SHAPES
from repro.launch import steps as ref_steps
from repro_torch import tracing
from repro_torch.configs import ARCHS, INPUT_SHAPES
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import wkv6 as wkv_mod
from repro_torch.launch import dryrun, steps
from repro_torch.launch.mesh import MeshView
from repro_torch.models import moe as moe_mod
from repro_torch.roofline.counter import argument_bytes, count

REPO = Path(__file__).resolve().parents[1]
ONE = MeshView({"data": 1, "model": 1}, ("data", "model"))
MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "32x8": ((32, 8), ("data", "model")),
}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def fake_group():
    """Starts a fake process group of the asked size; destroys it after the
    test, and checks that none is left."""
    started = []

    def start(n):
        assert not dist.is_initialized()
        started.append(dryrun.start_fake_group(n))

    yield start
    if started:
        dist.destroy_process_group()
    assert not dist.is_initialized()


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src") + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return env


# --------------------------------------------------------------------------
# Arguments at full size
# --------------------------------------------------------------------------
def _reference_argument_bytes(name: str, shape_name: str, mesh_name: str) -> int:
    """Per-device bytes of the reference bundle's arguments, token ids at
    the port's width (int64 for the reference's int32)."""
    dims, axes = MESHES[mesh_name]
    cfg = REF_ARCHS[name]
    if mesh_name == "32x8":
        cfg = dataclasses.replace(cfg, **{k: v for k, v in dryrun.OPT_OVERRIDES[name].items() if k != "mesh"})
    bundle = ref_steps.build_step(cfg, REF_SHAPES[shape_name], AbstractMesh(dims, axes))
    leaves = jax.tree.leaves(bundle.args)
    shardings = jax.tree.leaves(bundle.in_shardings, is_leaf=lambda s: hasattr(s, "shard_shape"))
    assert len(leaves) == len(shardings)
    total = 0
    for a, s in zip(leaves, shardings):
        width = 8 if a.dtype == np.int32 and a.ndim >= 2 else a.dtype.itemsize    # token ids
        total += math.prod(s.shard_shape(a.shape)) * width
    return total


CASES = [(n, m) for n in ARCHS for m in ("16x16", "2x16x16")] + [("grok-1-314b", "32x8")]


@pytest.mark.parametrize("name, mesh_name", CASES)
def test_argument_bytes_are_the_references_shard_bytes(fake_group, name, mesh_name):
    """Every input shape of ``name`` on ``mesh_name``: rank 0's argument
    bytes in the port's plan equal the reference's per-device shard bytes."""
    dims, axes = MESHES[mesh_name]
    cfg = ARCHS[name]
    if mesh_name == "32x8":
        cfg = dataclasses.replace(cfg, **{k: v for k, v in dryrun.OPT_OVERRIDES[name].items() if k != "mesh"})
    fake_group(math.prod(dims))
    mesh = dryrun.dryrun_mesh(dims, axes)
    for shape_name in INPUT_SHAPES:
        got = argument_bytes(steps.build_step(cfg, INPUT_SHAPES[shape_name], mesh))
        want = _reference_argument_bytes(name, shape_name, mesh_name)
        assert got == want, (shape_name, got, want)


# --------------------------------------------------------------------------
# The skip
# --------------------------------------------------------------------------
REF_SKIP = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import json
from repro.launch.dryrun import run_one
rec = run_one("qwen1.5-0.5b", "long_500k", multi_pod=False, out_dir={out!r}, verbose=False)
print("RESULT:" + json.dumps(rec))
"""


def test_the_skip_record_is_the_references(tmp_path):
    out = subprocess.run([sys.executable, "-c", REF_SKIP.format(out=str(tmp_path / "ref"))],
                         capture_output=True, text=True, timeout=300, env=_env(), cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    want = json.loads([line for line in out.stdout.splitlines() if line.startswith("RESULT:")][0][7:])
    got = dryrun.run_one("qwen1.5-0.5b", "long_500k", out_dir=str(tmp_path / "port"), verbose=False)
    assert got == want
    written = (tmp_path / "port" / "dryrun_16x16.jsonl").read_text().splitlines()
    assert [json.loads(line) for line in written] == [want]
    assert not dist.is_initialized()


def test_every_full_attention_long_context_pair_and_nothing_else_is_skipped(tmp_path):
    for name, cfg in ARCHS.items():
        for shape_name in INPUT_SHAPES:
            skipped = not cfg.supports_shape(shape_name)
            assert skipped == (not REF_ARCHS[name].supports_shape(shape_name)), (name, shape_name)
            assert skipped == (shape_name == "long_500k" and cfg.block not in ("rwkv6", "hymba")
                               and not cfg.window), (name, shape_name)
            if skipped:
                rec = dryrun.run_one(name, shape_name, out_dir=str(tmp_path), verbose=False)
                assert rec["status"] == "skipped" and "sub-quadratic" in rec["reason"]
    assert not dist.is_initialized()


# --------------------------------------------------------------------------
# The hand kernels' fake forms
# --------------------------------------------------------------------------
def _flash_args(dtype, device):
    b, s, h, kv, hd = 2, 48, 4, 2, 64
    return [torch.empty(b, s, n, hd, dtype=dtype, device=device) for n in (h, kv, kv)]


def _wkv_args(dtype, device, with_state=True):
    b, t, h, hd = 2, 40, 3, 64
    args = [torch.empty(b, t, h, hd, dtype=dtype, device=device) for _ in range(3)]
    args.append(torch.empty(b, t, h, hd, dtype=torch.float32, device=device))
    args.append(torch.empty(h, hd, dtype=torch.float32, device=device))
    args.append(torch.empty(b, h, hd, hd, dtype=torch.float32, device=device) if with_state else None)
    return args


KERNEL_CALLS = {
    "flash_attention": (
        lambda a: fa_mod.causal_attention(*a, scale=0.125, window=16),
        lambda a: fa_mod.causal_attention_plain(*a, scale=0.125, window=16),
        _flash_args, "causal_attention_plain"),
    "flash_attention_bwd": (
        lambda a: fa_mod.causal_attention_bwd(*a, a[0], a[0], scale=0.125, window=16),
        lambda a: fa_mod.causal_attention_bwd_plain(*a, a[0], a[0], scale=0.125, window=16),
        _flash_args, "causal_attention_bwd_plain"),
    "wkv6": (lambda a: wkv_mod.wkv6(*a), lambda a: wkv_mod.wkv6_plain(*a), _wkv_args, "wkv6_plain"),
    "wkv6_bwd": (
        lambda a: wkv_mod.wkv6_bwd(*a, a[3].float(), a[5]),
        lambda a: wkv_mod.wkv6_bwd_plain(*a, a[3].float(), a[5]),
        _wkv_args, "wkv6_bwd_plain"),
}


def _flops(fn, *args) -> tuple[int, object]:
    counter = FlopCounterMode(display=False)
    with counter:
        out = fn(*args)
    return counter.get_total_flops(), out


def _signature(out):
    outs = out if isinstance(out, tuple) else (out,)
    return [(tuple(t.shape), t.dtype) for t in outs]


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", list(KERNEL_CALLS))
def test_fake_forms_are_the_plain_versions_shapes_and_flops(monkeypatch, kernel, dtype, device):
    """On fake host and card tensors, each wrapper gives its plain
    version's output shapes and dtypes (the plain version run on real host
    tensors of the same shapes) and its ``FlopCounterMode`` count; no
    launch is counted, and a planted plain version that raises is never
    reached."""
    wrapper, plain, make, plain_name = KERNEL_CALLS[kernel]
    want_flops, want = _flops(plain, [torch.zeros_like(a) if a is not None else None
                                      for a in make(dtype, "cpu")])
    mod = fa_mod if kernel.startswith("flash") else wkv_mod
    launches = {k: tracing.counter(f"launches.{k}")
                for k in ("causal_attention", "causal_attention_bwd", "wkv6", "wkv6_bwd") if hasattr(mod, k)}

    def planted(*a, **k):
        raise AssertionError(f"{plain_name} reached on fake tensors")

    monkeypatch.setattr(mod, plain_name, planted)
    with FakeTensorMode():
        got_flops, got = _flops(wrapper, make(dtype, device))
    assert _signature(got) == _signature(want)
    assert all(t.device.type == device for t in (got if isinstance(got, tuple) else (got,)))
    assert got_flops == want_flops > 0
    assert launches == {k: tracing.counter(f"launches.{k}") for k in launches}


@pytest.mark.parametrize("kernel", list(KERNEL_CALLS))
def test_a_plain_version_refuses_fake_card_tensors(kernel):
    _, plain, make, _ = KERNEL_CALLS[kernel]
    with FakeTensorMode(), pytest.raises(TypeError, match="fake CUDA"):
        plain(make(torch.float32, "cuda"))


@pytest.mark.parametrize("kernel", ["flash_attention", "wkv6"])
def test_fake_forms_under_autograd_take_the_kernels_autograd_functions(monkeypatch, kernel):
    """With a gradient asked for, fake host tensors go through
    ``_FlashAttention`` / ``_WKV6`` as card tensors do: forward and
    backward fake forms, the plain versions' FLOPs (the backward's plain
    version, not autograd through the forward's), no plain version run."""
    wrapper, plain, make, plain_name = KERNEL_CALLS[kernel]
    bwd_plain = KERNEL_CALLS[f"{kernel}_bwd"][3]
    mod = fa_mod if kernel == "flash_attention" else wkv_mod
    real = [torch.zeros_like(a) if a is not None else None for a in make(torch.float32, "cpu")]
    fwd_flops, _ = _flops(plain, real)
    if kernel == "flash_attention":
        bwd_flops, _ = _flops(lambda a: mod.causal_attention_bwd_plain(*a, a[0], a[0], scale=0.125, window=16), real)
    else:
        bwd_flops, _ = _flops(lambda a: mod.wkv6_bwd_plain(*a, a[3], a[5]), real)
    for name in (plain_name, bwd_plain):
        monkeypatch.setattr(mod, name, lambda *a, **k: (_ for _ in ()).throw(AssertionError("plain reached")))
    with FakeTensorMode():
        args = [a.requires_grad_(True) if a is not None and a.is_floating_point() and a.dim() == 4 else a
                for a in make(torch.float32, "cpu")]
        counter = FlopCounterMode(display=False)
        with counter:
            out = wrapper(args)
            first = out[0] if isinstance(out, tuple) else out
            grads = torch.autograd.grad(first.sum(), [a for a in args if a is not None and a.requires_grad])
    assert [g.shape for g in grads] == [a.shape for a in args if a is not None and a.requires_grad]
    assert counter.get_total_flops() == fwd_flops + bwd_flops


# --------------------------------------------------------------------------
# Memory
# --------------------------------------------------------------------------
def _bundle(fn, args):
    return SimpleNamespace(fn=fn, args=args, shape=SimpleNamespace(kind="prefill"), mesh=ONE)


def test_peak_of_a_handmade_function_is_its_live_bytes():
    """a (4 KB) and b (8 KB) are held by the caller; c = a * 2 (4 KB) and
    d = cat(b, b) (16 KB) live together, c is freed, e = d.sum(0) (32 B)
    is the output: the peak is a + b + c + d."""
    with FakeTensorMode():
        a = torch.empty(1024)
        b = torch.empty(2, 1024)

    def fn(a, b):
        c = a * 2
        d = torch.cat([b, b]) + c
        del c
        return d.sum(0)[:8]

    costs, memory = count(_bundle(fn, (a, b)))
    assert memory["argument_bytes"] == 4096 + 8192
    assert memory["peak_bytes"] == 4096 + 8192 + 4096 + 16384 + 16384
    assert memory["temp_bytes"] == memory["peak_bytes"] - memory["argument_bytes"]
    assert memory["output_bytes"] == 4096


def test_a_long_prefill_peaks_below_its_plain_scores():
    """Reduced qwen1.5-0.5b, a prefill of 2 x 2048: the plain attention's
    float32 scores alone would be B * H * S * S * 4 = 128 MiB; the fake
    forms hold what the kernel holds, so the peak lies below that and at
    or above the arguments and outputs."""
    cfg = ARCHS["qwen1.5-0.5b"].reduced()
    shape = dataclasses.replace(INPUT_SHAPES["prefill_32k"], seq_len=2048, global_batch=2)
    _, memory = count(steps.build_step(cfg, shape, ONE))
    scores = 2 * cfg.n_heads * 2048 * 2048 * 4
    assert memory["argument_bytes"] + memory["output_bytes"] <= memory["peak_bytes"] < scores


# --------------------------------------------------------------------------
# MoE at the reference's static capacity
# --------------------------------------------------------------------------
@pytest.mark.parametrize("shape_name", ["train_4k", "prefill_32k"])
@pytest.mark.parametrize("name", ["grok-1-314b", "llama4-maverick-400b-a17b"])
def test_moe_expert_work_is_the_static_capacity(name, shape_name):
    """On fake tensors each expert takes its whole capacity: one MoE layer's
    forward counts the router's product and 3 * 2 * G * E * C * D * F for
    the experts, with G and C as the reference's ``moe_ffn`` sets them."""
    cfg = ARCHS[name].reduced()
    shape = dataclasses.replace(INPUT_SHAPES[shape_name], seq_len=64, global_batch=4)
    with FakeTensorMode():
        p = moe_mod.moe_init(torch.Generator().manual_seed(0), cfg.d_model, cfg.d_ff, cfg.n_experts,
                             torch.bfloat16, "cpu")
        x = torch.empty(shape.global_batch, shape.seq_len, cfg.d_model, dtype=torch.bfloat16)
        flops, out = _flops(lambda: moe_mod.moe_ffn(x, p, k=cfg.experts_per_token,
                                                    capacity_factor=cfg.capacity_factor))
    t, e, d, f = shape.global_batch * shape.seq_len, cfg.n_experts, cfg.d_model, cfg.d_ff
    gs = min(1024, t)
    while t % gs:
        gs //= 2
    g, c = t // gs, moe_mod.expert_capacity(gs, e, cfg.experts_per_token, cfg.capacity_factor)
    assert out.y.shape == x.shape
    assert flops == 2 * t * d * e + 3 * 2 * g * e * c * d * f


# --------------------------------------------------------------------------
# Reduced sweep on a fake 2 x 2 mesh
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(ARCHS))
def test_reduced_archs_count_on_a_2x2_mesh(fake_group, name):
    """Train, prefill and decode of the reduced arch on a fake 2 x 2 mesh:
    each step counts (positive FLOPs, a peak at or above its arguments),
    rank 0 holds less than the whole arguments, and the analysis reads the
    record."""
    from repro_torch.roofline.analysis import analyze_compiled

    cfg = ARCHS[name].reduced()
    fake_group(4)
    mesh = dryrun.dryrun_mesh((2, 2), ("data", "model"))
    for shape_name in ("train_4k", "prefill_32k", "decode_32k"):
        shape = dataclasses.replace(INPUT_SHAPES[shape_name], seq_len=32, global_batch=4)
        costs, memory = count(steps.build_step(cfg, shape, mesh))
        whole = argument_bytes(steps.build_step(cfg, shape, ONE))
        assert costs.flops > 0 and memory["peak_bytes"] >= memory["argument_bytes"] > 0, shape_name
        assert memory["argument_bytes"] < whole, shape_name
        roof = analyze_compiled(cfg, shape, mesh, costs)["roofline"]
        assert roof["n_chips"] == 4 and roof["bottleneck"] in ("compute", "memory", "collective")


def test_run_one_starts_and_ends_its_group(tmp_path, monkeypatch):
    """``run_one`` of a step on its production mesh starts a fake group of
    the mesh's size and destroys it; the record has the reference's keys
    and the port's memory block.  (The step is cut to two layers of
    qwen1.5-0.5b at one decode position to keep the test short.)"""
    small = dataclasses.replace(ARCHS["qwen1.5-0.5b"], n_layers=2)
    monkeypatch.setitem(dryrun.ARCHS, "qwen1.5-0.5b", small)
    rec = dryrun.run_one("qwen1.5-0.5b", "decode_32k", out_dir=str(tmp_path), verbose=False)
    assert not dist.is_initialized()
    assert rec["status"] == "ok", rec.get("error")
    assert {"arch", "shape", "mesh", "variant", "status", "lower_s", "compile_s", "memory", "roofline"} <= set(rec)
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes", "temp_bytes", "peak_bytes"}
    assert rec["roofline"]["n_chips"] == 256
    assert json.loads((tmp_path / "dryrun_16x16.jsonl").read_text()) == rec


def test_the_command_line(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "qwen1.5-0.5b", "--shape", "long_500k",
         "--out-dir", str(tmp_path)],
        capture_output=True, text=True, timeout=120, env=_env(), cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    assert (tmp_path / "dryrun_16x16.jsonl").exists()
    assert "1 skipped" in out.stdout
