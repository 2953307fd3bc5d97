"""Each reference family against the port at a tiny size on the CPU, in
float32 (where both should agree to round-off), and the benchmark's
weights against the layout of the port's ``init_params``."""
from __future__ import annotations

import pytest
import torch
from conftest import tiny_conf

import decoder
from adamw import AdamW
from harness import model as hm

CONFIGS = ["hymba-1.5b", "nemotron-4-15b"]


def f32(tree):
    if isinstance(tree, dict):
        return {k: f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [f32(v) for v in tree]
    return tree.float()


def rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-300))


@pytest.mark.parametrize("name", CONFIGS)
def test_weights_take_the_layout_of_init_params(name):
    from repro_torch.models.transformer import init_params

    conf = tiny_conf(name)
    ours = hm.leaves(hm.make_weights(conf, 7, "cpu"))
    theirs = hm.leaves(init_params(hm.arch_config(conf), torch.Generator().manual_seed(0), device="cpu"))
    assert [(p, tuple(t.shape), t.dtype) for p, t in ours] == [(p, tuple(t.shape), t.dtype) for p, t in theirs]


def test_weights_repeat_for_a_seed_and_differ_between_seeds():
    conf = tiny_conf("hymba-1.5b")
    a, b, c = (hm.leaves(hm.make_weights(conf, s, "cpu")) for s in (2**40 + 1, 2**40 + 1, 2**40 + 2))
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(a, b))
    assert not torch.equal(a[0][1], c[0][1])


def test_linear_scan_is_the_recurrence():
    g = torch.Generator().manual_seed(3)
    a = torch.rand((37, 5), generator=g)
    b = torch.randn((37, 5, 3), generator=g)
    assert rel(decoder.linear_scan(a, b), decoder.sequential_scan(a, b)) < 1e-6


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("s", [32, 64])
def test_prefill_agrees_with_the_port(name, s):
    from repro_torch.models.transformer import prefill_step

    conf = tiny_conf(name)
    m = conf["model"]
    params = f32(hm.make_weights(conf, 11, "cpu"))
    tokens = torch.randint(0, m["vocab_size"], (1, s), generator=torch.Generator().manual_seed(5))
    logits, caches = prefill_step(hm.arch_config(conf), params, {"tokens": tokens}, 64)
    want_logits, states, _ = decoder.prefill(m, params, tokens[0], 64)
    assert rel(logits[0, -1], want_logits) < 1e-5
    for got, want in zip(caches, states, strict=True):
        for key in want:
            assert rel(got[key][0], want[key]) < 1e-5, key


@pytest.mark.parametrize("name", CONFIGS)
def test_loss_and_gradients_agree_with_the_port(name):
    from repro_torch.models.transformer import forward_loss

    conf = tiny_conf(name)
    m = conf["model"]
    params = f32(hm.make_weights(conf, 13, "cpu"))
    row = torch.randint(0, m["vocab_size"], (1, 65), generator=torch.Generator().manual_seed(6))
    batch = {"tokens": row[:, :-1], "labels": row[:, 1:]}
    leaves = [p.requires_grad_(True) for _, p in hm.leaves(params)]
    got, _ = forward_loss(hm.arch_config(conf), params, batch)
    got_grads = torch.autograd.grad(got, leaves)
    want = decoder.loss(m, params, batch["tokens"][0], batch["labels"][0])
    want_grads = torch.autograd.grad(want, leaves)
    assert abs(float(got.detach()) - float(want.detach())) < 1e-5 * float(want.detach())
    for (path, _), g, w in zip(hm.leaves(params), got_grads, want_grads):
        assert rel(g, w) < 1e-4, path


def test_adamw_agrees_with_the_port():
    from repro_torch.training.optimizer import AdamWConfig, adamw_init, adamw_update

    conf = tiny_conf("hymba-1.5b")
    opt = conf["optimizer"]
    params = f32(hm.make_weights(conf, 17, "cpu"))
    grads = [torch.randn(p.shape, generator=torch.Generator().manual_seed(i)) for i, (_, p) in enumerate(hm.leaves(params))]
    cfg = AdamWConfig(**{k: opt[k] for k in ("lr", "b1", "b2", "eps", "weight_decay")})
    state = adamw_init(params, cfg)
    theirs = params
    for _ in range(2):
        theirs, state = adamw_update(hm_tree(params, grads), state, theirs, cfg)
    ours_named = [(p, t.clone()) for p, t in hm.leaves(params)]
    ours = AdamW(ours_named, opt, {p: torch.float32 for p, _ in ours_named})
    for _ in range(2):
        ours.step(grads)
    for (path, a), (_, b) in zip(ours_named, hm.leaves(theirs)):
        assert rel(a - hm_leaf(params, path), b - hm_leaf(params, path)) < 1e-5, path


def hm_tree(like, flat):
    it = iter(flat)

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        if isinstance(node, list):
            return [build(v) for v in node]
        return next(it)

    return build(like)


def hm_leaf(tree, path):
    return dict(hm.leaves(tree))[path]
