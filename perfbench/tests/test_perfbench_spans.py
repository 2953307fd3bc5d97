"""The program's spans laid over a traced stretch (``harness/spans.py``)
and the four readers of idle time by span, on a hand-made ``Reading`` and
hand-made spans, each expected value worked out by hand; and, marked
``cuda``, two tiny prefills traced on the card."""
from __future__ import annotations

import sys

import pytest
import torch
from conftest import tiny_conf, tiny_traffic

from harness import spans, spec
from harness.context import Outcome
from harness.trace import Reading
from repro_torch import tracing

MAIN, AUTOGRAD = 1, 2       # two host threads


def span(name, id_, parent, root, start, end, thread=MAIN, **attrs):
    return tracing.Span(name, id_, parent, root, thread, start, end, attrs)


def reading(ops: list[tuple[int, int]], window_ns: int) -> Reading:
    named = [(f"k{i}", s, e) for i, (s, e) in enumerate(ops)]
    busy = sum(e - s for s, e in ops)
    return Reading(ops=named, window_s=window_ns / 1e9, busy_s=busy / 1e9, ranges={}, gaps=[])


# Two requests over ops with gaps (100, 150), (250, 400), (500, 700): 400 ns
# idle in a 1000 ns window.  The first request's root covers the first two
# gaps whole (50 + 150 ns); the second's starts 100 ns into the third gap.
PREFILL_READING = reading([(0, 100), (150, 250), (400, 500), (700, 800)], 1000)
PREFILL_SPANS = [
    span("embed", 2, 1, 1, 60, 120),
    span("attention", 4, 3, 1, 260, 300),
    span("ssm.scan", 6, 5, 1, 310, 330),
    span("ssm", 5, 3, 1, 300, 420),
    span("layer", 3, 1, 1, 130, 440, index=0),
    span("head", 7, 1, 1, 445, 449),
    span("prefill", 1, None, 1, 50, 450, batch=1, tokens=16),
    span("prefill", 8, None, 8, 600, 900, batch=1, tokens=16),
    # Another stretch's request, and a root of another name: left out.
    span("prefill", 9, None, 9, 2000, 2500),
    span("layer", 10, 9, 9, 2100, 2400),
    span("train.step", 11, None, 11, 0, 1000),
]

# A train step over ops with gaps (100, 300), (400, 600), (700, 900): 600
# ns idle in a 1000 ns window.  The forward covers 150 ns of the first gap;
# the backward 40 ns of it on the main thread, and the second gap whole
# with the recompute on autograd's thread (500-650 under it); the optimizer
# 150 ns of the third.  10 + 50 ns lie outside the three.
TRAIN_READING = reading([(0, 100), (300, 400), (600, 700), (900, 1000)], 1000)
TRAIN_SPANS = [
    span("train.forward", 2, 1, 1, 10, 250),
    span("layer", 3, 2, 1, 20, 240, index=0),
    span("attention", 5, 4, 1, 490, 520, thread=AUTOGRAD),
    span("layer", 4, 6, 1, 480, 650, thread=AUTOGRAD, index=0),
    span("train.backward", 6, 1, 1, 260, 500),
    span("train.optimizer", 7, 1, 1, 660, 850),
    span("train.step", 1, None, 1, 5, 990, rows=1, tokens=16),
]


def outcome(r: Reading, **window) -> Outcome:
    return Outcome(e2e={}, attempted=0, failed=0, numbers={}, memory_peak=0, window=window, reading=r)


def test_gaps_are_the_readings():
    assert spans.gaps(PREFILL_READING) == [(100, 150), (250, 400), (500, 700)]


def test_roots_overlapping_the_stretch_and_only_their_count():
    found = spans.roots(PREFILL_READING, PREFILL_SPANS, "prefill", 2)
    assert [s.id for s in found] == [1, 8]
    assert spans.roots(PREFILL_READING, PREFILL_SPANS, "prefill", 3) is None
    assert spans.roots(PREFILL_READING, PREFILL_SPANS, "prefill", 1) is None


@pytest.mark.parametrize("names, want", [
    (None, 300),                      # 50 + 150 inside the first root, 100 inside the second
    ({"layer"}, 20 + 150),            # 130-150, and 250-400 under layer (attention, ssm, ssm.scan)
    ({"ssm"}, 100),                   # 300-400
    ({"ssm.scan"}, 20),
    ({"embed"}, 20),                  # 100-120
    ({"head"}, 0),                    # no gap while it ran
])
def test_idle_inside_spans_of_the_roots(names, want):
    got = spans.idle_in(PREFILL_READING, PREFILL_SPANS, "prefill", 2, names)
    assert got == pytest.approx(100.0 * want / 1000)


def test_idle_by_innermost_span():
    got = spans.idle_by_span(PREFILL_READING, PREFILL_SPANS, "prefill", 2)
    want = {"embed": 20, "prefill": 10 + 100, "layer": 20 + 10, "attention": 40, "ssm": 10 + 70, "ssm.scan": 20,
            spans.CALLER: 100}
    assert got == pytest.approx({k: v / 1e9 for k, v in want.items()})
    assert sum(got.values()) == pytest.approx(400 / 1e9)


def test_a_second_thread_counts_under_its_parent():
    by = {p: spans.idle_in(TRAIN_READING, TRAIN_SPANS, "train.step", 1, {p})
          for p in ("train.forward", "train.backward", "train.optimizer")}
    assert by == pytest.approx({"train.forward": 15.0, "train.backward": 24.0, "train.optimizer": 15.0})
    split = spans.idle_by_span(TRAIN_READING, TRAIN_SPANS, "train.step", 1)
    # 100-240 the forward's layer, 240-250 the forward, 250-260 the step;
    # 400-480 the backward, 480-490 and 520-600 the recompute's layer (one
    # deeper than the backward), 490-520 its attention; 850-900 the step.
    want = {"train.forward": 10, "layer": 140 + 10 + 80, "train.step": 10 + 50, "train.backward": 40 + 80,
            "attention": 30, "train.optimizer": 150}
    assert split == pytest.approx({k: v / 1e9 for k, v in want.items()})


def test_without_spans_or_a_reading_nothing_is_read():
    assert spans.idle_in(PREFILL_READING, None, "prefill", 2) is None
    assert spans.idle_in(None, PREFILL_SPANS, "prefill", 2) is None
    assert spans.idle_in(reading([], 1000), PREFILL_SPANS, "prefill", 2) is None
    assert spans.idle_by_span(PREFILL_READING, PREFILL_SPANS, "prefill", 3) is None


def test_a_program_without_a_tracing_module_reads_nothing(monkeypatch):
    import repro_torch

    monkeypatch.delattr(repro_torch, "tracing")
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    assert spans.program_spans() is None
    o = outcome(PREFILL_READING, traced_lengths=[16, 16])
    assert spec.metric_reader("idle_in_program.prefill").read(None, o) is None


@pytest.fixture
def recorded(monkeypatch):
    def use(hand_made):
        monkeypatch.setattr(tracing, "spans", lambda: list(hand_made))
    return use


def test_the_prefill_reader(recorded):
    recorded(PREFILL_SPANS)
    read = spec.metric_reader("idle_in_program.prefill").read
    assert read(None, outcome(PREFILL_READING, traced_lengths=[16, 16])) == pytest.approx(30.0)
    # A run whose count of traced requests differs from the roots' reads nothing.
    assert read(None, outcome(PREFILL_READING, traced_lengths=[16, 16, 16])) is None


@pytest.mark.parametrize("metric, want", [("idle_in_forward.train", 15.0), ("idle_in_backward.train", 24.0),
                                          ("idle_in_optimizer.train", 15.0)])
def test_the_train_readers(recorded, metric, want):
    ctx = type("Ctx", (), {"traffic": tiny_traffic("train-4k")})()
    read = spec.metric_reader(metric).read
    recorded(TRAIN_SPANS)
    assert read(ctx, outcome(TRAIN_READING)) == pytest.approx(want)
    # Two steps' roots over the stretch where the generator traces one.
    recorded(TRAIN_SPANS + [span("train.step", 20, None, 20, 950, 995)])
    assert read(ctx, outcome(TRAIN_READING)) is None


@pytest.mark.cuda
def test_two_prefills_traced_on_the_card(card):
    """Two tiny prefills under a profile of the card alone: recording is
    on, and every device operation starts after the start of the root
    span of the prefill that launched it (the first ends in a
    synchronize, so what starts after that is the second's)."""
    import time

    from harness import model as hm
    from harness.trace import Tracer
    from repro_torch.models import transformer as tf

    conf = tiny_conf("hymba-1.5b")
    arch = hm.arch_config(conf)
    params = hm.make_weights(conf, 2**33 + 5, card)
    tokens = torch.randint(0, conf["model"]["vocab_size"], (1, 64), device=card)
    tf.prefill_step(arch, params, {"tokens": tokens}, 64)
    before = max((s.id for s in tracing.spans()), default=0)
    with Tracer([]) as tr:
        enabled = torch.autograd._profiler_enabled()
        tf.prefill_step(arch, params, {"tokens": tokens}, 64)
        torch.cuda.synchronize()
        between = time.time_ns()
        tf.prefill_step(arch, params, {"tokens": tokens}, 64)
    assert enabled
    roots = sorted((s for s in tracing.spans() if s.id > before and s.parent is None), key=lambda s: s.start_ns)
    assert [s.name for s in roots] == ["prefill", "prefill"]
    ops = tr.reading.ops
    first = [s for _, s, _ in ops if s < between]
    second = [s for _, s, _ in ops if s >= between]
    assert first and second
    assert min(first) >= roots[0].start_ns and min(second) >= roots[1].start_ns
    assert spans.roots(tr.reading, tracing.spans(), "prefill", 2) is not None
