"""The comparison that decides ``correct`` fails what it must, at a tiny
size on the CPU, under each cell's own limits: the control (the plain
reference with fp8 products put in the program's place), and a run whose
timed path is broken underneath (the program patched), driven through
everything of ``run.py`` after its look for a card."""
from __future__ import annotations

import pytest
import torch
from conftest import SEED, cpu_ctx, tiny_conf, tiny_traffic

import run
from harness import check, spec

BENCH = spec.manifest()
CELLS = [w for w in BENCH["workloads"]]


def cell_parts(cell):
    return tiny_conf(cell["config"]), tiny_traffic(cell["traffic"]), spec.workload_file(cell["name"])


def result(cell, seed=SEED):
    conf, traffic, workload = cell_parts(cell)
    return run.result_line(cell, conf, traffic, workload, BENCH, seed=seed, seconds=0.2, trace=False,
                           device=torch.device("cpu"))


@pytest.mark.parametrize("seed", [SEED, SEED + 1, SEED + 2])
@pytest.mark.parametrize("cell", CELLS, ids=lambda c: c["name"])
def test_the_control_is_not_correct(cell, seed):
    conf, traffic, workload = cell_parts(cell)
    ctx = cpu_ctx(conf, traffic, workload.get("check"), seed)
    got = spec.generator(traffic).readings(ctx, ["control"])["control"]
    assert not check.verdict(got, workload["limits"])[0], got


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: c["name"])
def test_a_sound_run_is_correct(cell):
    out = result(cell)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {m["name"] for m in spec.metrics_of("end_to_end", cell["name"], BENCH)}


PREFILL = [c for c in CELLS if spec.traffic_file(c["traffic"])["generator"] == "prefill_cycle"]
TRAIN = [c for c in CELLS if spec.traffic_file(c["traffic"])["generator"] == "train_steps"]


@pytest.mark.parametrize("cell", PREFILL, ids=lambda c: c["name"])
def test_a_prefill_that_returns_its_state_unchanged_is_not_correct(cell, monkeypatch):
    from repro_torch.models import transformer as tf

    real = tf.prefill_step

    def unchanged(cfg, params, batch, max_len):
        logits, _ = real(cfg, params, batch, max_len)
        return logits, tf.init_decode_caches(cfg, batch["tokens"].shape[0], max_len, device="cpu")

    monkeypatch.setattr(tf, "prefill_step", unchanged)
    assert not result(cell)["correct"]


@pytest.mark.parametrize("cell", PREFILL, ids=lambda c: c["name"])
def test_a_prefill_whose_token_is_altered_is_not_correct(cell, monkeypatch):
    from repro_torch.models import transformer as tf

    real = tf.prefill_step

    def altered(cfg, params, batch, max_len):
        logits, caches = real(cfg, params, batch, max_len)
        logits = logits.clone()
        low = logits.argmin(dim=-1, keepdim=True)
        logits.scatter_(-1, low, torch.full_like(low, 0, dtype=logits.dtype) + logits.max() + 1)  # the worst token first
        return logits, caches

    monkeypatch.setattr(tf, "prefill_step", altered)
    assert not result(cell)["correct"]


@pytest.mark.parametrize("cell", TRAIN, ids=lambda c: c["name"])
def test_a_step_that_returns_its_state_unchanged_is_not_correct(cell, monkeypatch):
    from repro_torch.training import train_loop

    def unchanged(grads, state, params, cfg, lr_scale=1.0):
        return params, {"step": state["step"] + 1, "m": state["m"], "v": state["v"]}

    monkeypatch.setattr(train_loop, "adamw_update_", unchanged)
    out = result(cell)
    assert not out["correct"] and out["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", TRAIN, ids=lambda c: c["name"])
def test_a_step_that_leaves_out_half_the_batch_is_not_correct(cell, monkeypatch):
    from repro_torch.training import train_loop

    real = train_loop.forward_loss

    def half(cfg, params, batch, **kw):
        n = batch["tokens"].shape[1] // 2
        return real(cfg, params, {k: v[:, :n] for k, v in batch.items()}, **kw)

    monkeypatch.setattr(train_loop, "forward_loss", half)
    assert not result(cell)["correct"]
