"""Generator of training traffic: the program's production train step
(``launch/steps.py::build_train``'s ``fn``, its model and optimizer state
in the types ``train_config_for`` gives them), one step after another on
fresh rows, each step ending in a synchronize.

Traffic parameters (``traffic/<mix>.json``): ``seq_len`` and
``global_batch``, the step's batch (rows of ``seq_len`` tokens; the labels
are the next tokens of each row).  ``ROWS`` rows are drawn from the seed's
input stream before the first step; step k reads the next ``global_batch``
of them.  The first ``CHECKED_STEPS`` steps run in set-up, through the same
call on the same object that the window then drives; the reference follows
them.  With ``--trace 1``, ``TRACE_STEPS`` steps are traced after the
window (the card's activity alone).  The reference's AdamW is the one the
configuration states (its ``optimizer`` block).

End-to-end metrics: ``train_tokens_per_s`` (tokens of every step of the
window over the wall time of those steps), ``peak_mem_gib``, ``setup_s``.

Correctness, against the plain reference (float32, TF32 off, parameters
stored as the configuration stores them) following the checked steps from
the same weights and rows: ``grad_gap``, the first gradient as the
optimizer got it (the first moment after one step over 1 - b1), and
``change_gap``, each parameter's change over the checked steps as the
window's first step finds it, each by the worst leaf: the gap between the
program's norm of the leaf and the reference's, over the larger of the
reference's norm of that leaf and of the median leaf.  Leaves whose
reference gradient norm lies under ``LEAF_FLOOR`` of the median leaf's are
not compared (their change is round-off).  The checked steps' losses are
not compared: neither the control nor a planted fault moves them past what
sound runs read.
"""
from __future__ import annotations

import time

import torch

from harness import model as hm
from harness.check import worst_leaf_gap
from harness.context import Outcome, memory_peak, release, sync
from harness.spec import reference
from harness.trace import Tracer

ROWS = 64             # rows drawn before the first step; the steps take them in turn
CHECKED_STEPS = 3     # steps in set-up that the reference follows
TRACE_STEPS = 1       # steps traced after the window
LEAF_FLOOR = 1e-3     # leaves with a reference gradient under this share of the median leaf's are left out


def norms(tree) -> dict[str, float]:
    vals = [(p, torch.linalg.vector_norm(t.float())) for p, t in hm.leaves(tree)]
    return dict(zip([p for p, _ in vals], torch.stack([v for _, v in vals]).tolist()))


def change_norms(tree, start) -> dict[str, float]:
    vals = [(p, torch.linalg.vector_norm(t.float() - s.float()))
            for (p, t), (_, s) in zip(hm.leaves(tree), hm.leaves(start), strict=True)]
    return dict(zip([p for p, _ in vals], torch.stack([v for _, v in vals]).tolist()))


class Rows:
    def __init__(self, traffic: dict, vocab: int, seed: int, device):
        gen = torch.Generator(device=device).manual_seed(hm.sub_seed(seed, hm.INPUTS))
        self.b, self.n = traffic["global_batch"], ROWS
        self.rows = torch.randint(0, vocab, (self.n, traffic["seq_len"] + 1), generator=gen, device=device)

    def batch(self, k: int) -> dict[str, torch.Tensor]:
        idx = [(k * self.b + j) % self.n for j in range(self.b)]
        r = self.rows[idx]
        return {"tokens": r[:, :-1].contiguous(), "labels": r[:, 1:].contiguous()}


def reference_readings(ctx, rows: Rows, arith: str = "float32", positions: slice | None = None) -> dict:
    """The plain reference's checked steps from the seed's weights, read as
    the program's are.  ``arith`` and ``positions`` make the stand-ins:
    fp8 products (the control), a loss over part of the tokens (a fault)."""
    from adamw import AdamW
    from precision import plain_math

    plain_math()
    dec = reference(ctx.conf["reference"])
    start = hm.make_weights(ctx.conf, ctx.seed, ctx.device)
    params = _tree_map(lambda x: x.to(torch.float32, copy=True).requires_grad_(True), start)
    named = hm.leaves(params)
    opt = AdamW(named, ctx.conf["optimizer"], {p: x.dtype for p, x in hm.leaves(start)})
    first = None
    for k in range(CHECKED_STEPS):
        batch = rows.batch(k)
        loss = sum(dec.loss(ctx.conf["model"], params, batch["tokens"][j], batch["labels"][j], arith, positions)
                   for j in range(rows.b)) / rows.b
        grads = torch.autograd.grad(loss, [p for _, p in named])
        if k == 0:
            first = dict(zip([p for p, _ in named], torch.stack([torch.linalg.vector_norm(g) for g in grads]).tolist()))
        opt.step(grads)
        del grads, loss
    with torch.no_grad():
        changes = change_norms(params, start)
    return {"grads": first, "changes": changes}


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def numbers(got: dict, want: dict) -> dict[str, float]:
    """The compared numbers, over the leaves whose reference gradient is at
    least ``LEAF_FLOOR`` times the median leaf's."""
    med = sorted(want["grads"].values())[len(want["grads"]) // 2]
    counted = [p for p, g in want["grads"].items() if g >= LEAF_FLOOR * med]
    return {"grad_gap": worst_leaf_gap(got["grads"], want["grads"], counted)[0],
            "change_gap": worst_leaf_gap(got["changes"], want["changes"], counted)[0]}


def setup(ctx):
    """The program's train step on the seed's weights and rows, driven
    through the checked steps; returns (fn, params, opt, rows, program's
    readings)."""
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import MeshView
    from repro_torch.training.optimizer import adamw_init

    t, dev = ctx.traffic, ctx.device
    arch = hm.arch_config(ctx.conf)
    shape = InputShape("train", t["seq_len"], t["global_batch"], "train")
    bundle = steps.build_train(arch, shape, MeshView({"data": 1, "model": 1}, ("data", "model")))
    params = hm.make_weights(ctx.conf, ctx.seed, dev)
    opt = adamw_init(params, bundle.train_config.optimizer)
    rows = Rows(t, ctx.conf["model"]["vocab_size"], ctx.seed, dev)
    b1 = bundle.train_config.optimizer.b1
    first = None
    for k in range(CHECKED_STEPS):
        params, opt, _ = bundle.fn(params, opt, rows.batch(k))
        if k == 0:
            first = {p: g / (1 - b1) for p, g in norms(opt["m"]).items()}
    start = hm.make_weights(ctx.conf, ctx.seed, dev)
    changes = change_norms(params, start)
    del start
    return bundle.fn, params, opt, rows, {"grads": first, "changes": changes}


def run(ctx) -> Outcome:
    t, dev = ctx.traffic, ctx.device
    fn, params, opt, rows, got = setup(ctx)
    sync(dev)
    setup_s = time.perf_counter() - ctx.t_start

    k = CHECKED_STEPS
    steps = 0
    t_w = time.perf_counter()
    while True:
        params, opt, metrics = fn(params, opt, rows.batch(k))
        sync(dev)
        k += 1
        steps += 1
        if time.perf_counter() - t_w >= ctx.seconds:
            break
    wall = time.perf_counter() - t_w
    peak = memory_peak(dev)

    tracer = None
    if ctx.trace:
        with Tracer(ctx.ranges) as tracer:
            for _ in range(TRACE_STEPS):
                params, opt, metrics = fn(params, opt, rows.batch(k))
                k += 1
    del fn, params, opt, metrics
    release(dev)

    want = reference_readings(ctx, rows)
    tokens = steps * t["global_batch"] * t["seq_len"]
    e2e = {"train_tokens_per_s": tokens / wall, "peak_mem_gib": peak / 2**30, "setup_s": setup_s}
    window = {"steps": steps, "seq_len": t["seq_len"], "global_batch": t["global_batch"], "wall_s": wall}
    return Outcome(e2e=e2e, attempted=steps, failed=0, numbers=numbers(got, want),
                   memory_peak=peak, window=window, reading=tracer.reading if tracer else None)


STAND_INS = {"control": ("fp8", None), "half_batch": ("float32", "half")}


def readings(ctx, kinds: list[str]) -> dict[str, dict]:
    """The compared numbers of stand-ins for the program on this seed,
    against one run of the reference, without a window: ``control`` (the
    reference with fp8 products in the program's place) and ``half_batch``
    (the reference's loss over half of each row's tokens, a planted fault)."""
    rows = Rows(ctx.traffic, ctx.conf["model"]["vocab_size"], ctx.seed, ctx.device)
    want = reference_readings(ctx, rows)
    out = {}
    for kind in kinds:
        arith, part = STAND_INS[kind]
        got = reference_readings(ctx, rows, arith, slice(0, ctx.traffic["seq_len"] // 2) if part else None)
        out[kind] = numbers(got, want)
    return out
