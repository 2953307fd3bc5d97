"""The port's spans and counters (``repro_torch.tracing``): no span and no
change without a profiler; under one, a prefill's and a train step's span
trees, remat's recompute under the backward, each span bracketing the
profiler's own event for it, and the ring's bound."""
from __future__ import annotations

import dataclasses
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import tracing
from repro_torch.configs import ARCHS
from repro_torch.models import transformer as tf
from repro_torch.training.optimizer import AdamWConfig, adamw_init
from repro_torch.training.train_loop import TrainConfig, make_train_step
from repro_torch.training.tree import leaves_with_paths

SEQ = 64      # two chunks of the chunked scan


def _model(name: str):
    cfg = ARCHS[name].reduced()
    if cfg.block == "hymba":
        cfg = dataclasses.replace(cfg, use_chunked_scan=True)
    params = tf.init_params(cfg, torch.Generator().manual_seed(0), device="cpu", dtype=torch.float32)
    tokens = torch.randint(0, cfg.vocab_size, (1, SEQ), generator=torch.Generator().manual_seed(1))
    return cfg, params, tokens


def _new_spans(before: list) -> list:
    """The spans opened since ``before`` was read (ids rise as spans open;
    the ring holds them as they close)."""
    last = max((s.id for s in before), default=0)
    return [s for s in tracing.spans() if s.id > last]


def _step_inputs(cfg, params, tokens):
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=1e-3))
    labels = torch.roll(tokens, -1, dims=1)
    return make_train_step(cfg, tcfg), adamw_init(params, tcfg.optimizer), {"tokens": tokens, "labels": labels}


def _tree(spans: list, root_name: str):
    """The one root named ``root_name`` among ``spans``, its spans by id,
    and each span's parent's name."""
    roots = [s for s in spans if s.parent is None and s.name == root_name]
    assert len(roots) == 1, [s.name for s in spans if s.parent is None]
    root = roots[0]
    mine = [s for s in spans if s.root == root.id]
    assert len(mine) == len(spans), "every span of the call carries its root's id"
    by_id = {s.id: s for s in mine}
    return root, by_id, {s.id: by_id[s.parent].name for s in mine if s.parent is not None}


def test_without_a_profiler_nothing_is_recorded_and_outputs_equal_the_profiled_ones():
    cfg, params, tokens = _model("hymba-1.5b")
    step, opt, batch = _step_inputs(cfg, params, tokens)
    before = tracing.spans()
    logits, caches = tf.prefill_step(cfg, params, {"tokens": tokens}, SEQ)
    new_params, new_opt, metrics = step(params, opt, batch)
    assert tracing.spans() == before
    with profile(activities=[ProfilerActivity.CPU]):
        p_logits, p_caches = tf.prefill_step(cfg, params, {"tokens": tokens}, SEQ)
        p_params, p_opt, p_metrics = step(params, opt, batch)
    assert len(_new_spans(before)) > 0
    assert torch.equal(logits, p_logits)
    for c, pc in zip(caches, p_caches, strict=True):
        assert c.keys() == pc.keys() and all(torch.equal(c[k], pc[k]) for k in c)
    for tree, p_tree in ((new_params, p_params), (new_opt, p_opt), (metrics, p_metrics)):
        for (path, a), (_, b) in zip(leaves_with_paths(tree), leaves_with_paths(p_tree), strict=True):
            assert torch.equal(a, b), path


@pytest.mark.parametrize("name, ffn", [("hymba-1.5b", "mlp"), ("grok-1-314b", "moe")])
def test_a_prefill_records_one_root_with_its_span_tree(name, ffn):
    cfg, params, tokens = _model(name)
    before = tracing.spans()
    with profile(activities=[ProfilerActivity.CPU]):
        tf.prefill_step(cfg, params, {"tokens": tokens}, SEQ)
    spans = _new_spans(before)
    root, by_id, parent = _tree(spans, "prefill")
    assert root.attrs == {"batch": 1, "tokens": SEQ}
    want = {"prefill": None, "embed": "prefill", "layer": "prefill", "attention": "layer", "cache": "layer",
            ffn: "layer", "head": "prefill"}
    if cfg.block == "hymba":
        want |= {"ssm": "layer", "ssm.scan": "ssm"}
    assert {s.name for s in spans} == set(want)
    for s in spans:
        assert parent.get(s.id) == want[s.name], s
        if s.parent is not None:
            up = by_id[s.parent]
            assert up.start_ns <= s.start_ns <= s.end_ns <= up.end_ns, (s, up)
        assert s.thread == threading.get_ident()
    layers = sorted((s for s in spans if s.name == "layer"), key=lambda s: s.start_ns)
    assert [s.attrs["index"] for s in layers] == list(range(cfg.n_layers))
    per_layer = {n: sum(1 for s in spans if s.name == n) for n in want}
    assert per_layer["cache"] == per_layer["attention"] == cfg.n_layers
    assert per_layer["embed"] == per_layer["head"] == 1


def test_a_remat_train_step_puts_the_recomputed_layers_under_the_backward():
    cfg, params, tokens = _model("hymba-1.5b")
    step, opt, batch = _step_inputs(cfg, params, tokens)
    before = tracing.spans()
    with profile(activities=[ProfilerActivity.CPU]):
        step(params, opt, batch)
    spans = _new_spans(before)
    root, by_id, parent = _tree(spans, "train.step")
    assert root.attrs == {"rows": 1, "tokens": SEQ}
    assert sorted(parent[s.id] for s in spans if s.name.startswith("train.") and s is not root) == ["train.step"] * 3
    layers = [s for s in spans if s.name == "layer"]
    forward = sorted(s.attrs["index"] for s in layers if parent[s.id] == "train.forward")
    recomputed = sorted(s.attrs["index"] for s in layers if parent[s.id] == "train.backward")
    assert forward == recomputed == list(range(cfg.n_layers))
    back = next(s for s in spans if s.name == "train.backward")
    assert all(back.start_ns <= s.start_ns <= s.end_ns <= back.end_ns for s in layers if s.parent == back.id)
    assert {parent[s.id] for s in spans if s.name in ("attention", "ssm", "mlp")} == {"layer"}


def test_a_span_opened_on_another_thread_takes_the_open_roots_id(monkeypatch):
    """Remat's recompute runs on autograd's device thread on the card: a
    span opened on a thread with no span of its own, while a root is open,
    takes that root's id and the innermost span open on the root's
    thread as its parent."""
    monkeypatch.setattr(tracing, "_profiler_enabled", lambda: True)
    before = tracing.spans()

    def worker():
        with tracing.span("layer", index=3):
            with tracing.span("attention"):
                pass

    with tracing.span("train.step", rows=1, tokens=SEQ):
        with tracing.span("train.backward"):
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
        with tracing.span("train.optimizer"):
            pass
    by_name = {s.name: s for s in _new_spans(before)}
    root, back = by_name["train.step"], by_name["train.backward"]
    assert by_name["layer"].root == by_name["attention"].root == root.id
    assert by_name["layer"].parent == back.id and by_name["attention"].parent == by_name["layer"].id
    assert by_name["layer"].thread != root.thread == back.thread
    assert by_name["train.optimizer"].parent == root.id
    # A span opened after the root closed starts a root of its own.
    with tracing.span("prefill"):
        pass
    last = tracing.spans()[-1]
    assert last.name == "prefill" and last.parent is None and last.root == last.id


def test_spans_and_counts_from_many_threads_under_one_root(monkeypatch):
    """Threads opening spans and counting at once, switching often: no
    count is lost, and every span keeps the root's id and its own
    thread's parent."""
    import sys

    monkeypatch.setattr(tracing, "_profiler_enabled", lambda: True)
    threads, each, name = 8, 500, "launches.test_threads"
    start = tracing.counter(name)
    before = tracing.spans()

    def worker():
        for _ in range(each):
            with tracing.span("layer"):
                with tracing.span("attention"):
                    tracing.count(name)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with tracing.span("train.step"):
            with tracing.span("train.backward"):
                pool = [threading.Thread(target=worker) for _ in range(threads)]
                for t in pool:
                    t.start()
                for t in pool:
                    t.join(timeout=60)
                assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(interval)
    assert tracing.counter(name) == start + threads * each
    spans = _new_spans(before)
    root, by_id, parent = _tree(spans, "train.step")
    assert len(spans) == 2 + 2 * threads * each
    for s in spans:
        if s.name == "attention":
            assert parent[s.id] == "layer" and by_id[s.parent].thread == s.thread
        elif s.name == "layer":
            assert parent[s.id] == "train.backward"


def test_each_span_brackets_the_profilers_event_for_it():
    cfg, params, tokens = _model("hymba-1.5b")
    before = tracing.spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tf.prefill_step(cfg, params, {"tokens": tokens}, SEQ)
    spans = _new_spans(before)
    events: dict[str, list[tuple[int, int]]] = {}
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            events.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    for name in {s.name for s in spans}:
        mine = sorted((s.start_ns, s.end_ns) for s in spans if s.name == name)
        theirs = sorted(events.get(name, []))
        assert len(mine) == len(theirs), name
        for (s0, s1), (e0, e1) in zip(mine, theirs):
            assert s0 <= e0 <= e1 <= s1, (name, s0, e0, e1, s1)


def test_the_ring_keeps_the_last_spans(monkeypatch):
    monkeypatch.setattr(tracing, "_profiler_enabled", lambda: True)
    extra = 10
    for i in range(tracing.RING + extra):
        with tracing.span("ring", i=i):
            pass
    kept = tracing.spans()
    assert tracing.RING == 65536 and len(kept) == tracing.RING
    assert [s.attrs["i"] for s in kept[:2]] == [extra, extra + 1] and kept[-1].attrs["i"] == tracing.RING + extra - 1


def test_counters_add_and_read():
    name = "launches.test_only"
    start = tracing.counter(name)
    tracing.count(name)
    tracing.count(name, 3)
    assert tracing.counter(name) == start + 4
    assert tracing.counter("launches.never_counted") == 0


def test_chip_smoke_resolves_its_ranges_from_the_programs_spans():
    """``chip_smoke.span_device_ms``: a kernel counts toward a span name of
    ``RANGES`` when the runtime call that launched it (the profiler gives
    both its correlation id) lies inside a span of that name; overlapping
    spans count once, and host ops (whose ids may collide) and the spans'
    own device annotations are no launches or kernels."""
    import sys
    from pathlib import Path
    from types import SimpleNamespace

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    from torch.autograd import DeviceType

    def ev(name, device, corr, start, dur=0, annotation=False):
        return SimpleNamespace(name=lambda: name, device_type=lambda: device, correlation_id=lambda: corr,
                               start_ns=lambda: start, duration_ns=lambda: dur, is_user_annotation=lambda: annotation)

    cpu, gpu = DeviceType.CPU, DeviceType.CUDA
    events = [
        ev("cudaLaunchKernel", cpu, 1, 100), ev("k1", gpu, 1, 105, 10),           # inside the first moe
        ev("cuLaunchKernel", cpu, 2, 200), ev("k2", gpu, 2, 205, 20),             # inside no span
        ev("cudaLaunchKernelExC", cpu, 3, 350), ev("k3", gpu, 3, 355, 30),        # inside ssm.scan
        ev("cudaLaunchKernel", cpu, 4, 170), ev("k4", gpu, 4, 175, 40),           # inside the second moe
        ev("aten::mm", cpu, 2, 120),                                              # a host op, id 2 again
        ev("moe", gpu, 9, 105, 500, annotation=True),
    ]
    prof = SimpleNamespace(profiler=SimpleNamespace(kineto_results=SimpleNamespace(events=lambda: events)))
    spans = [tracing.Span("moe", 1, None, 1, 0, 50, 150, {}), tracing.Span("moe", 2, None, 2, 0, 120, 180, {}),
             tracing.Span("ssm.scan", 3, None, 3, 0, 300, 400, {}), tracing.Span("layer", 4, None, 4, 0, 0, 1000, {})]
    assert chip_smoke.span_device_ms(prof, spans) == {"moe": (2, 50 / 1e6), "ssm.scan": (1, 30 / 1e6)}


@pytest.mark.cuda
def test_on_the_card_the_recompute_runs_on_autograds_thread_under_the_backward():
    """A tiny hymba remat step on the card, under a profile of the card's
    activity alone: recording is on, the recomputed layers' spans come
    from another thread than the step's and sit under ``train.backward``,
    and every device operation starts after the step's root span."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from torch.autograd import DeviceType

    cfg, _, tokens = _model("hymba-1.5b")
    params = tf.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda", dtype=torch.bfloat16)
    step, opt, batch = _step_inputs(cfg, params, tokens.cuda())
    step(params, opt, batch)
    torch.cuda.synchronize()
    before = tracing.spans()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        assert torch.autograd._profiler_enabled()
        step(params, opt, batch)
        torch.cuda.synchronize()
    spans = _new_spans(before)
    root, by_id, parent = _tree(spans, "train.step")
    recomputed = [s for s in spans if s.name == "layer" and parent[s.id] == "train.backward"]
    assert sorted(s.attrs["index"] for s in recomputed) == list(range(cfg.n_layers))
    assert all(s.thread != root.thread for s in recomputed)
    starts = [e.start_ns() for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA and not e.is_user_annotation()]
    assert starts and min(starts) >= root.start_ns
