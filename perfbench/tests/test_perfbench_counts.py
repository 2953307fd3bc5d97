"""The yardstick's FLOP and byte counts against counts made by hand."""
from __future__ import annotations

import math

import pytest
import torch

import decoder
from harness import flops, spec

TINY = {"n_layers": 3, "d_model": 8, "n_heads": 4, "n_kv_heads": 2, "head_dim": 2, "d_ff": 16,
        "vocab_size": 10, "mlp": "swiglu", "attn_kind": "local_global", "window": 3, "full_attn_layers": [0]}


def conf(m: dict) -> dict:
    return {"reference": "decoder", "model": m}


def mask_pairs(s: int, window: int) -> int:
    q = torch.arange(s)[:, None]
    k = torch.arange(s)[None, :]
    keep = k <= q
    if window:
        keep &= q - k < window
    return int(keep.sum())


@pytest.mark.parametrize("s,window", [(1, 0), (7, 0), (4096, 0), (5, 3), (3, 3), (2, 3), (4096, 1024), (1024, 1024)])
def test_causal_pairs_count_the_mask(s, window):
    if s > 2048:     # by formula, checked against the mask at a smaller size above
        n = s * (s + 1) // 2 if not window else window * (window + 1) // 2 + (s - window) * window
        assert flops.causal_pairs(s, window) == n
    else:
        assert flops.causal_pairs(s, window) == mask_pairs(s, window)


def test_layer_weights_by_hand():
    # wq 8x8, wk 8x4, wv 8x4, wo 8x8 = 192; swiglu 3 x 8 x 16 = 384
    assert decoder.layer_matmul_weights(TINY) == 192 + 384
    hymba = dict(TINY, block="hymba", ssm_inner=12, ssm_state=2)
    # + w_in, w_gate, w_dt 3 x 8 x 12, w_B, w_C 2 x 8 x 2, w_out 12 x 8
    assert decoder.layer_matmul_weights(hymba) == 576 + 288 + 32 + 96
    relu2 = dict(TINY, mlp="relu2")
    assert decoder.layer_matmul_weights(relu2) == 192 + 256


def test_prefill_and_train_flops_by_hand():
    s = 5
    attn = 4 * 2 * 4 * (15 + 12 + 12)        # layer 0 full: 15 pairs; layers 1, 2 window 3: 3 + ... = 12
    assert mask_pairs(5, 3) == 12
    fwd_head_last = 2 * 3 * 576 * s + 2 * 8 * 10 * 1 + attn
    assert flops.prefill_flops(conf(TINY), s) == fwd_head_last
    fwd_head_all = 2 * 3 * 576 * s + 2 * 8 * 10 * s + attn
    assert flops.train_flops(conf(TINY), s) == 3 * fwd_head_all


def test_flash_call_flops_and_bytes_by_hand():
    f, b = flops.flash_call(4, 2, 2, 5, 3)
    assert f == 4 * 2 * 4 * 12
    assert b == 2 * (5 * 4 * 2 + 2 * 5 * 2 * 2 + 5 * 4 * 2)   # q, k, v, o in bf16
    calls = flops.flash_calls(conf(TINY), 5)       # layer 0 full (15 pairs), layers 1, 2 window 3 (12)
    assert [f for f, _ in calls] == [4 * 2 * 4 * 15, 4 * 2 * 4 * 12, 4 * 2 * 4 * 12]
    assert all(b == 2 * (5 * 4 * 2 + 2 * 5 * 2 * 2 + 5 * 4 * 2) for _, b in calls)


@pytest.mark.parametrize("name,billions", [("hymba-1.5b", 1.80), ("nemotron-4-15b", 15.63)])
def test_published_sizes_give_the_published_parameter_counts(name, billions):
    c = spec.config_file(name)
    n = sum(math.prod(shape) for _, shape, *_ in spec.reference(c["reference"]).leaf_specs(c["model"]))
    assert abs(n / 1e9 - billions) < 0.01, (name, n)
