"""Generator of prompt-processing traffic: one client in a closed loop,
handing the program's ``prefill_step`` one prompt at a time and waiting
for its first token (the greedy argmax of the last position's logits) on
the host before the next.  The request's caches are dropped then.

Traffic parameters (``traffic/<mix>.json``): ``lengths``, prompt lengths
cycled in this order, the same for every seed; ``batch``, prompts a
request; ``cache_slots``, the ``max_len`` each request's caches are sized
for.  Token ids are drawn from the seed's input stream before the window
(``TOKEN_POOL`` of them); request i reads the next ``length`` of them, so
the prompts differ and nothing is drawn inside the window.  Set-up serves
one cycle of the lengths (prompts of their own); with ``--trace 1``,
``TRACE_REQUESTS`` requests are traced after the window with the card's
activity alone, then as many again with the host's too where a metric
reads a range of the program's functions.

End-to-end metrics: ``prefill_tokens_per_s`` (prompt tokens of all the
window's requests over the window's wall time, from the first request's
start to the last one's first token), ``ttft_p95_ms`` (95th percentile of
every request's time from the call to its first token on the host),
``peak_mem_gib`` and ``setup_s``.

Correctness (the cell's ``workloads/<cell>.json``: ``checked_per_length``
and the limits): of each length, ``checked_per_length`` of the window's
requests are drawn from the seed (``Sample``): one among the first
``CACHE_CYCLES`` cycles, whose caches are kept too, and the others
uniformly from all the window's other requests of that length.  Their
last-position logits and served tokens are kept on the host; once the
window has closed, the plain reference runs each prompt, and the numbers
compared are ``logits_err`` (relative norm of the logits' difference),
``token_gap`` (how far the served token's reference logit lies below the
reference's best, in units of the reference logits' standard deviation)
and, for each part of the layer state that the reference family names
(``state_layout``), the largest relative norm of a layer's difference
(for the decoder family: ``kv_global``, every slot of a full cache,
``kv_window``, ``ssm_state``, ``ssm_prev``).  Each is the worst over the
checked requests.
"""
from __future__ import annotations

import math
import random
import time

import numpy as np
import torch

from harness import model as hm
from harness.check import rel_err
from harness.context import Outcome, memory_peak, release, sync
from harness.spec import reference
from harness.trace import Tracer

TOKEN_POOL = 1 << 21      # token ids drawn before the window (prompts wrap after some 200 cycles)
WARMUP_CYCLES = 1         # cycles of the lengths served in set-up, every shape once
CACHE_CYCLES = 4          # the request of each length whose caches are checked is among these first cycles
TRACE_REQUESTS = 8        # requests traced after the window, in each traced stretch


class Prompts:
    """Request i's prompt, drawn once for the run; set-up's requests take
    negative i, prompts of their own."""

    def __init__(self, traffic: dict, vocab: int, seed: int, device):
        self.lengths = traffic["lengths"]
        self.batch = traffic["batch"]
        gen = torch.Generator(device=device).manual_seed(hm.sub_seed(seed, hm.INPUTS))
        self.pool = torch.randint(0, vocab, (TOKEN_POOL,), generator=gen, device=device)
        self.span = TOKEN_POOL - self.batch * max(self.lengths)
        self.cycle = sum(self.lengths) * self.batch

    def length(self, i: int) -> int:
        return self.lengths[i % len(self.lengths)]

    def tokens(self, i: int) -> torch.Tensor:
        n = len(self.lengths)
        start = (i // n) * self.cycle + sum(self.lengths[: i % n]) * self.batch
        start %= self.span
        length = self.length(i)
        return self.pool[start: start + self.batch * length].view(self.batch, length)


class Sample:
    """The checked requests of a run, drawn from the seed: of each of the
    ``n`` lengths, one among the first ``CACHE_CYCLES`` cycles, whose caches
    are checked too, and ``per_length - 1`` others drawn uniformly from the
    rest of the window's requests of that length by reservoir sampling, so
    that the draw covers the whole window, however long it turns out."""

    def __init__(self, n: int, per_length: int, seed: int):
        self.rng = random.Random(hm.sub_seed(seed, hm.SAMPLE))
        self.n, self.k = n, per_length - 1
        self.with_caches = {self.rng.randrange(CACHE_CYCLES) * n + c for c in range(n)}
        self.seen = [0] * n
        self.held: list[list[int]] = [[] for _ in range(n)]

    def offer(self, i: int) -> tuple[bool, int | None]:
        """Whether request i is kept, and the kept request it displaces."""
        if i in self.with_caches:
            return True, None
        c = i % self.n
        self.seen[c] += 1
        if self.seen[c] <= self.k:
            self.held[c].append(i)
            return True, None
        j = self.rng.randrange(self.seen[c])
        if j < self.k:
            out, self.held[c][j] = self.held[c][j], i
            return True, out
        return False, None

    def complete(self, served: int) -> bool:
        """Whether the first ``served`` requests fill the sample."""
        return all(i < served for i in self.with_caches) and min(self.seen) >= self.k

    def without_window(self) -> list[int]:
        """As many requests as a run checks, for a stand-in that runs no
        window: the caches' draws and the first others of each length."""
        out = set(self.with_caches)
        for c in range(self.n):
            others = [c + self.n * j for j in range(self.k + 1) if c + self.n * j not in self.with_caches]
            out |= set(others[: self.k])
        return sorted(out)


def worse(a: float, b: float) -> float:
    """The larger of two readings; NaN if either is."""
    return math.nan if math.isnan(a) or math.isnan(b) else max(a, b)


def kept_outputs(logits: torch.Tensor, token: int, caches: list[dict], length: int, layout,
                 with_caches: bool) -> dict:
    """A checked request's outputs on the host: the logits (V,), the served
    token, and, ``with_caches``, each layer's state as ``layout(i)`` names
    it; a full cache's slots past the prompt are kept as the squared norm
    of what they hold (zero when they are empty)."""
    out = {"logits": logits[0, -1].float().to("cpu"), "token": token, "layers": None}
    if not with_caches:
        return out
    tails, layers = [], []
    for i, c in enumerate(caches):
        st = {}
        for key, (_, full) in layout(i).items():
            t = c[key][0]
            if full:
                tails.append(t[length:].float().square().sum())
                t = t[:length]
            st[key] = t.to("cpu")
        layers.append(st)
    tail_sq = iter(torch.stack(tails).tolist() if tails else [])
    for i, st in enumerate(layers):
        for key, (_, full) in layout(i).items():
            if full:
                st[f"{key}_tail_sq"] = next(tail_sq)
    out["layers"] = layers
    return out


def compare(got: dict, want_logits: torch.Tensor, want_states: list[dict], layout) -> dict[str, float]:
    """The numbers of one checked request (``got`` as ``kept_outputs``
    keeps it, ``want`` the reference's)."""
    dev = want_logits.device
    nums = {"logits_err": rel_err(got["logits"].to(dev), want_logits),
            "token_gap": float((want_logits.max() - want_logits[got["token"]]) / want_logits.std())}
    for i, (g, w) in enumerate(zip(got["layers"] or [], want_states if got["layers"] else [], strict=True)):
        for key, (name, _) in layout(i).items():
            have, want = g[key].to(dev).double(), w[key].double()
            diff_sq = float((have - want[: have.shape[0]]).square().sum()) + g.get(f"{key}_tail_sq", 0.0)
            err = math.sqrt(diff_sq) / float(torch.linalg.vector_norm(want))
            nums[name] = worse(nums.get(name, 0.0), err)
    return nums


def worst(per_request: list[dict[str, float]]) -> dict[str, float]:
    """The largest of each number over the checked requests (NaN if any
    is NaN)."""
    out: dict[str, float] = {}
    for nums in per_request:
        for k, v in nums.items():
            out[k] = worse(out.get(k, v), v)
    return out


def reference_numbers(ctx, params, prompts: Prompts, kept: dict[int, dict], arith: str = "float32") -> dict:
    """The plain reference over each checked prompt, compared with what
    was kept of the program's answer; the worst of each number."""
    from precision import plain_math

    fam = reference(ctx.conf["reference"])
    plain_math()
    m, max_len = ctx.conf["model"], ctx.traffic["cache_slots"]
    per = []
    for i, got in sorted(kept.items()):
        logits, states, h = fam.prefill(m, params, prompts.tokens(i)[0], max_len, arith)
        nums = compare(got, logits, states, lambda j: fam.state_layout(m, j))
        if "hidden" in got:
            nums["token_gap"] = position_gaps(fam, m, params, h, got["hidden"], got["arith"])
        per.append(nums)
        del logits, states, h
    return worst(per)


def position_gaps(fam, m: dict, params: dict, h_ref, h_low, arith: str, block: int = 1024) -> float:
    """The widest gap, over every position of a prompt, by which the token
    that a lower-precision stand-in puts first (its logits from its own
    final hidden states ``h_low``) lies below the reference's best, in
    units of the reference logits' standard deviation at that position."""
    widest = 0.0
    for s in range(0, h_ref.shape[0], block):
        ref = fam.head(m, params, h_ref[s: s + block])
        top = fam.head(m, params, h_low[s: s + block].to(h_ref.device), arith).argmax(dim=-1)
        gap = (ref.max(dim=-1).values - ref.gather(-1, top[:, None])[:, 0]) / ref.std(dim=-1)
        widest = worse(widest, float(gap.max()))
    return widest


def stand_in_outputs(ctx, params, prompts: Prompts, arith: str) -> dict[int, dict]:
    """The reference put in the program's place, in arithmetic ``arith``:
    its answers to as many prompts as a run checks, kept as the program's
    are, and its final hidden states, so that its token is read at every
    position."""
    fam = reference(ctx.conf["reference"])
    m, max_len = ctx.conf["model"], ctx.traffic["cache_slots"]
    sample = Sample(len(prompts.lengths), ctx.check["checked_per_length"], ctx.seed)
    out = {}
    for i in sample.without_window():
        logits, states, h = fam.prefill(m, params, prompts.tokens(i)[0], max_len, arith)
        layers = []
        for j, st in enumerate(states):
            g = {}
            for key, (_, full) in fam.state_layout(m, j).items():
                g[key] = (st[key][: prompts.length(i)] if full else st[key]).cpu()
                if full:
                    g[f"{key}_tail_sq"] = 0.0
            layers.append(g)
        out[i] = {"logits": logits.cpu(), "token": int(logits.argmax()),
                  "layers": layers if i in sample.with_caches else None, "hidden": h.cpu(), "arith": arith}
    return out


def run(ctx) -> Outcome:
    from repro_torch.models import transformer as tf

    t, conf, dev = ctx.traffic, ctx.conf, ctx.device
    fam = reference(conf["reference"])
    m = conf["model"]
    arch = hm.arch_config(conf)
    params = hm.make_weights(conf, ctx.seed, dev)
    prompts = Prompts(t, m["vocab_size"], ctx.seed, dev)
    n = len(t["lengths"])
    sample = Sample(n, ctx.check["checked_per_length"], ctx.seed)
    max_len = t["cache_slots"]

    def serve(i):
        """Request i: (seconds to its first token on the host, the token,
        logits, caches)."""
        tokens = prompts.tokens(i)
        t0 = time.perf_counter()
        logits, caches = tf.prefill_step(arch, params, {"tokens": tokens}, max_len)
        first = logits[:, -1].argmax(dim=-1).tolist()        # the first token on the host: waits for the card
        return time.perf_counter() - t0, first[0], logits, caches

    for i in range(-WARMUP_CYCLES * n, 0):
        serve(i)
    sync(dev)
    setup_s = time.perf_counter() - ctx.t_start

    kept, lengths, ttft = {}, [], []
    t_w = time.perf_counter()
    i = 0
    while True:
        took, token, logits, caches = serve(i)
        lengths.append(prompts.length(i))
        ttft.append(took)
        keep, out = sample.offer(i)
        if keep:
            kept[i] = kept_outputs(logits, token, caches, prompts.length(i), lambda j: fam.state_layout(m, j),
                                   i in sample.with_caches)
        if out is not None:
            del kept[out]
        del logits, caches
        i += 1
        if time.perf_counter() - t_w >= ctx.seconds and sample.complete(i):
            break
    wall = time.perf_counter() - t_w
    peak = memory_peak(dev)

    stretches, traced = [], []
    if ctx.trace:
        for ranges in ([], ctx.ranges)[: 2 if ctx.ranges else 1]:
            with Tracer(ranges) as tr:
                for _ in range(TRACE_REQUESTS):
                    serve(i)
                    traced.append(prompts.length(i))
                    i += 1
            stretches.append(tr.reading)
    release(dev)

    t_check = time.perf_counter()
    numbers = reference_numbers(ctx, params, prompts, kept)
    check_s = time.perf_counter() - t_check
    tokens = sum(lengths) * t["batch"]
    e2e = {
        "prefill_tokens_per_s": tokens / wall,
        "ttft_p95_ms": float(np.percentile(np.array(ttft), 95)) * 1e3,
        "peak_mem_gib": peak / 2**30,
        "setup_s": setup_s,
    }
    window = {"lengths": lengths, "batch": t["batch"], "wall_s": wall, "checked": len(kept), "check_s": check_s,
              "traced_lengths": traced[:TRACE_REQUESTS]}
    return Outcome(e2e=e2e, attempted=len(lengths), failed=0, numbers=numbers, memory_peak=peak,
                   window=window, reading=stretches[0] if stretches else None,
                   ranged=stretches[1] if len(stretches) > 1 else None)


def readings(ctx, kinds: list[str]) -> dict[str, dict]:
    """The compared numbers of stand-ins for the program on this seed's
    prompts, without a window: ``control`` is the reference with fp8
    products in the program's place; its ``token_gap`` is read at every
    position of each prompt."""
    params = hm.make_weights(ctx.conf, ctx.seed, ctx.device)
    prompts = Prompts(ctx.traffic, ctx.conf["model"]["vocab_size"], ctx.seed, ctx.device)
    out = {}
    for kind in kinds:
        if kind != "control":
            raise ValueError(f"a prefill cell has no stand-in {kind!r}")
        got = stand_in_outputs(ctx, params, prompts, "fp8")
        out[kind] = reference_numbers(ctx, params, prompts, got)
    return out
