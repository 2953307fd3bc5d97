"""A model family is new files only: a stub family, written to a temporary
directory and named by a configuration, drives the harness's weights, FLOP
counts and the prefill check's state comparison without an edit to any
file under ``perfbench/``."""
from __future__ import annotations

import math
import sys

import pytest
import torch

from harness import flops
from harness import model as hm

STUB = '''
import torch


def leaf_specs(m, weights=None):
    d, v = m["d_model"], m["vocab_size"]
    out = [(("embed",), (v, d), "normal", 1.0, "served"), (("lm_head",), (d, v), "normal", d ** -0.5, "served")]
    for i in range(m["n_layers"]):
        out += [(("layers", i, "mix"), (d, d), "normal", d ** -0.5, "served"),
                (("layers", i, "decay"), (d,), "ones", 0.0, "float32")]
    return out


def matmul_weights(m):
    return m["n_layers"] * m["d_model"] ** 2, m["d_model"] * m["vocab_size"]


def attention_calls(m):
    return []


def state_layout(m, i):
    return {"wkv": ("wkv_state", False), "shift": ("shift", True)}


def head(m, params, h, arith="float32"):
    return h @ params["lm_head"].float()


def prefill(m, params, tokens, max_len, arith="float32"):
    h = params["embed"][tokens].float()
    states = []
    for p in params["layers"]:
        h = torch.tanh(h @ p["mix"].float()) * p["decay"]
        shift = h.new_zeros((max_len, h.shape[1]))
        shift[: h.shape[0]] = h
        states.append({"wkv": h.sum(0), "shift": shift})
    return head(m, params, h[-1:])[0], states, h


def tiny(m):
    return dict(m, n_layers=2, d_model=8, vocab_size=32)
'''

MODEL = {"n_layers": 3, "d_model": 8, "vocab_size": 32}


@pytest.fixture
def stub(tmp_path, monkeypatch):
    (tmp_path / "stubfam.py").write_text(STUB)
    monkeypatch.syspath_prepend(str(tmp_path))
    yield {"reference": "stubfam", "dtype": "float32", "model": dict(MODEL)}
    sys.modules.pop("stubfam", None)


def test_the_weights_take_the_familys_layout(stub):
    got = hm.leaves(hm.make_weights(stub, 2**35 + 3, "cpu"))
    assert [p for p, _ in got] == ["embed", "lm_head"] + [f"layers.{i}.{k}" for i in range(3) for k in ("mix", "decay")]
    assert all(t.dtype == torch.float32 for _, t in got)
    assert torch.equal(dict(got)["layers.1.decay"], torch.ones(8))


def test_the_flop_counts_take_the_familys_weights_and_calls(stub):
    s = 5
    assert flops.prefill_flops(stub, s) == 2 * 3 * 64 * s + 2 * 8 * 32
    assert flops.train_flops(stub, s) == 3 * (2 * 3 * 64 * s + 2 * 8 * 32 * s)
    assert flops.flash_calls(stub, s) == []


def test_the_prefill_check_compares_the_familys_state(stub):
    from harness.spec import reference
    from traffic import prefill_cycle as pc

    fam = reference("stubfam")
    m, length, max_len = stub["model"], 6, 10
    params = hm.make_weights(stub, 7, "cpu")
    tokens = torch.arange(length) % m["vocab_size"]
    logits, states, _ = fam.prefill(m, params, tokens, max_len)
    layout = lambda i: fam.state_layout(m, i)  # noqa: E731
    caches = [{k: v[None].clone() for k, v in st.items()} for st in states]      # the program's batch of one

    kept = pc.kept_outputs(logits[None, None], int(logits.argmax()), caches, length, layout, True)
    nums = pc.compare(kept, logits, states, layout)
    assert nums == {"logits_err": 0.0, "token_gap": 0.0, "wkv_state": 0.0, "shift": 0.0}

    caches[1]["shift"][0, max_len - 1, 0] += 1.0                             # a slot past the prompt written
    caches[2]["wkv"][0] *= 1.5
    kept = pc.kept_outputs(logits[None, None], int(logits.argmin()), caches, length, layout, True)
    nums = pc.compare(kept, logits, states, layout)
    assert nums["shift"] == pytest.approx(1.0 / float(states[1]["shift"].norm()))
    assert nums["wkv_state"] == pytest.approx(0.5)
    assert nums["token_gap"] > 0 and math.isfinite(nums["token_gap"])
