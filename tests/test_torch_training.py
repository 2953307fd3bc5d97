"""The port's training substrate against the JAX package's: AdamW, the
schedules, the data pipeline, checkpoints, the microbatched train step and
the launcher, mirroring ``tests/test_training.py``.

Everything runs on the CPU in float32; parameters come from the reference's
``init_params`` through ``params_from_jax`` where the two are compared.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.data import pipeline as ref_pipeline
from repro.models import transformer as ref_tf
from repro.training import optimizer as ref_opt
from repro.training import schedule as ref_sched
from repro.training import train_loop as ref_loop
from repro_torch import tracing
from repro_torch.configs import get_arch
from repro_torch.data.pipeline import DataConfig, SyntheticTokens, batches_for_arch
from repro_torch.launch import train as train_cli
from repro_torch.models.transformer import init_params, params_from_jax
from repro_torch.training import checkpoint
from repro_torch.training.optimizer import AdamWConfig, adamw_init, adamw_update
from repro_torch.training.schedule import cosine_schedule, wsd_schedule
from repro_torch.training.train_loop import TrainConfig, init_train_state, make_train_step
from repro_torch.training.tree import leaves_with_paths, tree_map, tree_unflatten

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The suite runs several workers on a few cores: two intra-op threads
    for this file's torch ops keep it from starving the wall-clock tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(t):
    return np.asarray(t.float() if isinstance(t, torch.Tensor) else t.astype(jnp.float32))


# --------------------------------------------------------------------------
# AdamW
# --------------------------------------------------------------------------
def _ref_adamw_run(arch, ref_cfg, steps, seed, jitter, jit):
    """``steps`` updates (jitted if ``jit``) of the reference's AdamW on its
    own stacked tree (the reduced ``arch`` from its ``init_params``, every
    leaf moved by ``jitter`` times seeded noise, so that at ``jitter`` > 0
    no leaf starts at 0) with seeded gradients; returns the port's config, its tree at the start, the
    per-step gradients and learning-rate scales mapped into the port's
    layout through ``params_from_jax``, and the reference's parameters and
    state at the end."""
    cfg = get_arch(arch).reduced()
    rng = np.random.default_rng(seed)
    jparams = ref_tf.init_params(ref_get_arch(arch).reduced(), jax.random.PRNGKey(0), dtype=jnp.float32)
    jparams = jax.tree.map(lambda a: a + jitter * rng.standard_normal(a.shape, dtype=np.float32), jparams)
    params = params_from_jax(cfg, jparams)
    state = ref_opt.adamw_init(jparams, ref_cfg)
    update = jax.jit(ref_opt.adamw_update, static_argnums=3) if jit else ref_opt.adamw_update
    grads, scales = [], []
    for step in range(steps):
        g = jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(a.shape, dtype=np.float32)), jparams)
        scale = 0.5 + 0.25 * step
        jparams, state = update(g, state, jparams, ref_cfg, scale)
        grads.append(params_from_jax(cfg, g))
        scales.append(scale)
    return cfg, params, grads, scales, jparams, state


def _assert_trees_close(cfg, port_params, port_state, jparams, ref_state, rtol, atol):
    """Parameters and both moments, leaf by leaf, of the port against the
    reference's stacked tree mapped through ``params_from_jax``."""
    assert int(port_state["step"]) == int(ref_state["step"])
    for name, port_tree, ref_tree in (("params", port_params, jparams), ("m", port_state["m"], ref_state["m"]),
                                      ("v", port_state["v"], ref_state["v"])):
        want_tree = params_from_jax(cfg, ref_tree)
        got_leaves, want_leaves = leaves_with_paths(port_tree), leaves_with_paths(want_tree)
        assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
        for (path, got), (_, want) in zip(got_leaves, want_leaves):
            assert got.dtype == want.dtype, (name, path)
            np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol, err_msg=f"{name}{path}")


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_adamw_equals_the_reference(moments):
    """Three updates of the reduced gemma3-1b from seeded gradients: the
    port on its per-layer tree against the reference's jitted update on its
    stacked tree; new parameters and both moments within 1e-6 relative."""
    ref_cfg = ref_opt.AdamWConfig(lr=1e-2, moments_dtype=getattr(jnp, moments))
    port_cfg = AdamWConfig(lr=1e-2, moments_dtype=getattr(torch, moments))
    cfg, params, grads, scales, jparams, ref_state = _ref_adamw_run("gemma3-1b", ref_cfg, 3, seed=4, jitter=0.0, jit=False)
    state = adamw_init(params, port_cfg)
    for g, scale in zip(grads, scales):
        params, state = adamw_update(g, state, params, port_cfg, scale)
    assert int(state["step"]) == 3
    _assert_trees_close(cfg, params, state, jparams, ref_state, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "rwkv6-7b", "gemma3-1b"])
def test_adamw_decays_per_layer_vectors_as_the_reference(arch):
    """Five updates at lr 1e-2 and weight decay 0.5 of a reduced arch whose
    layers hold 1-D leaves (norm weights; qwen's qkv biases, RWKV's
    ``ln_x``), every leaf non-zero from the start: parameters and both
    moments, leaf by leaf, equal the reference's jitted update on its
    stacked tree, where those leaves are 2-D and decayed.  The decay moves
    each per-layer 1-D leaf by far more than the tolerance (checked against
    the reference without decay), and leaves the top-level vector alone."""
    ref_cfg = ref_opt.AdamWConfig(lr=1e-2, weight_decay=0.5)
    port_cfg = AdamWConfig(lr=1e-2, weight_decay=0.5)
    cfg, params, grads, scales, jparams, ref_state = _ref_adamw_run(arch, ref_cfg, 5, seed=7, jitter=0.5, jit=True)
    *_, undecayed, _ = _ref_adamw_run(arch, ref_opt.AdamWConfig(lr=1e-2, weight_decay=0.0), 5, seed=7, jitter=0.5, jit=True)
    want, free = params_from_jax(cfg, jparams), params_from_jax(cfg, undecayed)
    vectors = [path for path, p in leaves_with_paths(want) if p.dim() == 1]
    assert any(path.startswith("['layers']") for path in vectors) and "['final_norm']" in vectors
    for (path, w), (_, f) in zip(leaves_with_paths(want), leaves_with_paths(free)):
        moved = float((w - f).abs().max())
        if path in vectors:
            assert (moved > 1e-3) == path.startswith("['layers']"), (path, moved)
    state = adamw_init(params, port_cfg)
    for g, scale in zip(grads, scales):
        params, state = adamw_update(g, state, params, port_cfg, scale)
    _assert_trees_close(cfg, params, state, jparams, ref_state, rtol=1e-6, atol=1e-7)


def test_adamw_minimizes_quadratic():
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = adamw_init(params, cfg)
    for _ in range(200):
        params, state = adamw_update({"w": 2.0 * params["w"]}, state, params, cfg)
    assert float(params["w"].abs().max()) < 0.1


def test_weight_decay_only_on_matrices():
    cfg = AdamWConfig(lr=0.1, weight_decay=1.0)
    params = {"mat": torch.ones((2, 2)), "vec": torch.ones((2,))}
    state = adamw_init(params, cfg)
    new, _ = adamw_update(tree_map(torch.zeros_like, params), state, params, cfg)
    assert float(new["mat"].abs().sum()) < float(params["mat"].abs().sum())
    np.testing.assert_allclose(new["vec"].numpy(), 1.0)
    assert float(params["mat"].sum()) == 4.0   # the update returns new tensors


def test_bf16_moments():
    cfg = AdamWConfig(moments_dtype=torch.bfloat16)
    params = {"w": torch.ones((4,))}
    state = adamw_init(params, cfg)
    assert state["m"]["w"].dtype == torch.bfloat16
    _, state = adamw_update({"w": torch.ones((4,))}, state, params, cfg)
    assert state["v"]["w"].dtype == torch.bfloat16


# --------------------------------------------------------------------------
# Schedules
# --------------------------------------------------------------------------
@pytest.mark.parametrize("total", [200, 37])
@pytest.mark.parametrize("name", ["wsd_schedule", "cosine_schedule"])
def test_schedules_equal_the_reference(name, total):
    """Every step of 0..200, as Python numbers and as one tensor of steps;
    within one float32 rounding (the two libraries' cos may differ in the
    last bit)."""
    port = {"wsd_schedule": wsd_schedule, "cosine_schedule": cosine_schedule}[name]
    steps = np.arange(201)
    want = np.array([float(getattr(ref_sched, name)(int(s), total_steps=total)) for s in steps])
    got = np.array([port(int(s), total_steps=total) for s in steps])
    np.testing.assert_allclose(got, want, rtol=0, atol=6e-8)
    np.testing.assert_allclose(port(torch.from_numpy(steps), total_steps=total).numpy(), want, rtol=0, atol=6e-8)
    assert 0.0 <= got.min() and got.max() <= 1.0 + 1e-6


def test_wsd_phases():
    assert wsd_schedule(5, total_steps=1000) < 1.0       # warmup
    assert wsd_schedule(500, total_steps=1000) == 1.0    # stable
    assert wsd_schedule(999, total_steps=1000) < 0.2     # decay


# --------------------------------------------------------------------------
# Data
# --------------------------------------------------------------------------
def test_synthetic_tokens_equal_the_reference():
    dcfg = dict(batch_size=4, seq_len=16, vocab_size=100, seed=7)
    port, ref = iter(SyntheticTokens(DataConfig(**dcfg))), iter(ref_pipeline.SyntheticTokens(ref_pipeline.DataConfig(**dcfg)))
    for _ in range(3):
        got, want = next(port), next(ref)
        assert got.keys() == want.keys()
        for key in want:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])
    np.testing.assert_array_equal(got["tokens"][:, 1:], got["labels"][:, :-1])


@pytest.mark.parametrize("name", ["qwen1.5-0.5b", "gemma3-1b", "rwkv6-7b"])
def test_text_batches_equal_the_reference(name):
    cfg = get_arch(name).reduced()
    port = batches_for_arch(cfg, 4, 32, seed=3, device=CPU)
    ref = ref_pipeline.batches_for_arch(ref_get_arch(name).reduced(), 4, 32, seed=3)
    for _ in range(2):
        got, want = next(port), next(ref)
        for key in want:
            assert got[key].dtype == torch.int64 and got[key].device.type == CPU
            np.testing.assert_array_equal(got[key].numpy(), want[key])


@pytest.mark.parametrize("name", ["phi-3-vision-4.2b", "musicgen-large"])
def test_frontend_batches_have_the_reference_shapes(name):
    cfg = get_arch(name).reduced()
    got = next(batches_for_arch(cfg, 2, 32, device=CPU))
    want = next(ref_pipeline.batches_for_arch(ref_get_arch(name).reduced(), 2, 32))
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: tuple(v.shape) for k, v in want.items()}


def test_batches_need_a_named_device_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(batches_for_arch(get_arch("qwen1.5-0.5b").reduced(), 2, 8))


# --------------------------------------------------------------------------
# Checkpoints
# --------------------------------------------------------------------------
def test_checkpoint_roundtrip(tmp_path):
    cfg = get_arch("gemma3-1b").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(3), device=CPU, dtype=torch.float32)
    params["final_norm"] = params["final_norm"].bfloat16() + 0.125
    path = str(tmp_path / "ckpt")
    checkpoint.save(path, params, {"arch": cfg.name})
    restored = checkpoint.restore(path, params)
    for (p1, a), (p2, b) in zip(leaves_with_paths(params), leaves_with_paths(restored)):
        assert p1 == p2 and a.dtype == b.dtype
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    keys = set(np.load(path + ".npz").files)
    assert "['layers'][0]['attn']['wq']" in keys and len(keys) == len(leaves_with_paths(params))


# llama4's reduced config stacks 2 layers a group (an MoE layer every
# second one), gemma3-1b's 1: the two sides of stack_layers.
CKPT_ARCHS = ["llama4-maverick-400b-a17b", "gemma3-1b"]


def _ref_params(arch, jitter_seed):
    """The reference's reduced parameters, every leaf moved by seeded noise."""
    rng = np.random.default_rng(jitter_seed)
    jparams = ref_tf.init_params(ref_get_arch(arch).reduced(), jax.random.PRNGKey(0), dtype=jnp.float32)
    return jax.tree.map(lambda a: a + rng.standard_normal(a.shape, dtype=np.float32), jparams)


def _ref_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(path): np.asarray(leaf) for path, leaf in flat}


@pytest.mark.parametrize("arch", CKPT_ARCHS)
def test_port_checkpoint_restores_with_the_reference(tmp_path, arch):
    """``save_params`` writes the reference's file: the reference's
    ``restore`` reads it into its ``init_params`` tree, and every leaf
    equals the port's parameter it stacks."""
    from repro.training import checkpoint as ref_ckpt

    cfg = get_arch(arch).reduced()
    assert cfg.n_groups == 2
    params = init_params(cfg, torch.Generator().manual_seed(5), device=CPU, dtype=torch.float32)
    path = str(tmp_path / "ckpt")
    checkpoint.save_params(path, cfg, params, {"arch": cfg.name})
    like = ref_tf.init_params(ref_get_arch(arch).reduced(), jax.random.PRNGKey(1), dtype=jnp.float32)
    got = _ref_leaves(ref_ckpt.restore(path, like))
    assert set(np.load(path + ".npz").files) == set(got) == set(_ref_leaves(like))
    back = params_from_jax(cfg, ref_ckpt.restore(path, like))
    for (p1, want), (p2, leaf) in zip(leaves_with_paths(params), leaves_with_paths(back)):
        assert p1 == p2
        torch.testing.assert_close(leaf, want, rtol=0, atol=0)
    for key, leaf in leaves_with_paths(checkpoint.stack_layers(cfg, params)):
        np.testing.assert_array_equal(got[key], leaf.numpy(), err_msg=key)


@pytest.mark.parametrize("arch", CKPT_ARCHS)
def test_reference_checkpoint_restores_in_the_port(tmp_path, arch):
    """The reference's ``save`` of its parameters, read by
    ``restore_params``, equals ``params_from_jax`` of them, leaf by leaf,
    bfloat16 leaves of ``like`` included."""
    from repro.training import checkpoint as ref_ckpt

    cfg = get_arch(arch).reduced()
    jparams = _ref_params(arch, 7)
    path = str(tmp_path / "ckpt")
    ref_ckpt.save(path, jparams, {"arch": cfg.name})
    like = init_params(cfg, torch.Generator().manual_seed(2), device=CPU, dtype=torch.float32)
    like["final_norm"] = like["final_norm"].bfloat16()
    got = checkpoint.restore_params(path, cfg, like)
    want = params_from_jax(cfg, jparams)
    want["final_norm"] = want["final_norm"].bfloat16()
    assert checkpoint.load_metadata(path) == {"arch": cfg.name}
    got_leaves, want_leaves = leaves_with_paths(got), leaves_with_paths(want)
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    for (path_, a), (_, b) in zip(got_leaves, want_leaves):
        assert a.dtype == b.dtype, path_
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_stack_layers_inverts(tmp_path):
    cfg = get_arch("llama4-maverick-400b-a17b").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(4), device=CPU, dtype=torch.float32)
    stacked = checkpoint.stack_layers(cfg, params)
    assert len(stacked["groups"]) == cfg.group_size == 2 and "layers" not in stacked
    assert stacked["groups"][1]["attn"]["wq"].shape[0] == cfg.n_groups
    torch.testing.assert_close(stacked["groups"][1]["attn"]["wq"][1], params["layers"][3]["attn"]["wq"])
    back = checkpoint.unstack_layers(cfg, stacked)
    for (p1, a), (p2, b) in zip(leaves_with_paths(params), leaves_with_paths(back)):
        assert p1 == p2
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_checkpoint_metadata_and_shape_check(tmp_path):
    path = str(tmp_path / "ckpt")
    checkpoint.save(path, {"x": torch.ones(3)}, {"k": "v"})
    assert checkpoint.load_metadata(path) == {"k": "v"}
    with pytest.raises(ValueError, match="shape"):
        checkpoint.restore(path, {"x": torch.ones(4)})


# --------------------------------------------------------------------------
# Train step
# --------------------------------------------------------------------------
@pytest.mark.parametrize("n_micro", [1, 4])
def test_train_step_equals_the_reference(n_micro):
    """Five steps of reduced qwen from the reference's parameters on the
    same batches, against the reference's jitted step: losses within 1e-4
    relative (parameters and moments leaf by leaf:
    ``test_adamw_decays_per_layer_vectors_as_the_reference``)."""
    name = "qwen1.5-0.5b"
    ref_cfg, cfg = ref_get_arch(name).reduced(), get_arch(name).reduced()
    ref_params = ref_tf.init_params(ref_cfg, jax.random.PRNGKey(1), dtype=jnp.float32)
    params = params_from_jax(cfg, ref_params)
    ref_t = ref_loop.TrainConfig(optimizer=ref_opt.AdamWConfig(lr=3e-3), n_microbatches=n_micro)
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=3e-3), n_microbatches=n_micro)
    ref_step, step = jax.jit(ref_loop.make_train_step(ref_cfg, ref_t)), make_train_step(cfg, tcfg)
    ref_opt_state, opt_state = ref_opt.adamw_init(ref_params, ref_t.optimizer), init_train_state(cfg, tcfg, params)
    data = ref_pipeline.batches_for_arch(ref_cfg, 8, 32, seed=2)
    for i, batch in zip(range(5), data):
        scale = cosine_schedule(i, total_steps=5)
        ref_params, ref_opt_state, want = ref_step(ref_params, ref_opt_state, batch, scale)
        params, opt_state, got = step(params, opt_state, {k: torch.from_numpy(a).long() for k, a in batch.items()}, scale)
        assert float(got["loss"]) == pytest.approx(float(want["loss"]), rel=1e-4), i
        assert float(got["grad_norm"]) == pytest.approx(float(want["grad_norm"]), rel=1e-3), i
        assert got["loss"].dtype == got["grad_norm"].dtype == torch.float32


def test_microbatching_matches_full_batch():
    cfg = get_arch("qwen1.5-0.5b").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(1), device=CPU, dtype=torch.float32)
    batch = next(batches_for_arch(cfg, 8, 32, device=CPU))
    outs = {}
    for n_micro in (1, 4):
        tcfg = TrainConfig(optimizer=AdamWConfig(lr=1e-3), n_microbatches=n_micro)
        new_params, _, m = make_train_step(cfg, tcfg)(params, adamw_init(params, tcfg.optimizer), batch)
        outs[n_micro] = (new_params, float(m["loss"]))
    assert outs[1][1] == pytest.approx(outs[4][1], rel=1e-4)
    for (_, a), (_, b) in zip(leaves_with_paths(outs[1][0]), leaves_with_paths(outs[4][0])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-3, atol=2e-4)
    for _, p in leaves_with_paths(params):
        assert not p.requires_grad


def test_microbatches_must_divide_the_batch():
    cfg = get_arch("qwen1.5-0.5b").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(1), device=CPU, dtype=torch.float32)
    tcfg = TrainConfig(n_microbatches=3)
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(cfg, tcfg)(params, adamw_init(params, tcfg.optimizer), next(batches_for_arch(cfg, 8, 8, device=CPU)))


def test_loss_decreases_qwen_reduced():
    cfg = get_arch("qwen1.5-0.5b").reduced()
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=3e-3))
    params = init_params(cfg, torch.Generator().manual_seed(0), device=CPU, dtype=torch.float32)
    opt = adamw_init(params, tcfg.optimizer)
    step = make_train_step(cfg, tcfg)
    losses = []
    for _, batch in zip(range(25), batches_for_arch(cfg, 8, 64, device=CPU)):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses


def test_moe_trains():
    cfg = get_arch("grok-1-314b").reduced()
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=3e-3))
    params = init_params(cfg, torch.Generator().manual_seed(2), device=CPU, dtype=torch.float32)
    opt = adamw_init(params, tcfg.optimizer)
    step = make_train_step(cfg, tcfg)
    losses = []
    for _, batch in zip(range(15), batches_for_arch(cfg, 4, 32, device=CPU)):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
        assert np.isfinite(losses[-1])
    assert losses[-1] < losses[0]


# --------------------------------------------------------------------------
# Launcher
# --------------------------------------------------------------------------
def test_train_cli_on_the_host(tmp_path):
    """``python -m repro_torch.launch.train --reduced --device cpu`` prints
    the reference launcher's lines and saves a checkpoint that restores."""
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ)
    env["PYTHONPATH"] = src + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    ckpt = str(tmp_path / "ckpt")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "minicpm-2b", "--reduced", "--steps", "4",
         "--batch", "4", "--seq", "16", "--log-every", "2", "--microbatches", "2", "--device", "cpu",
         "--checkpoint", ckpt],
        capture_output=True, text=True, env=env, timeout=300, check=True,
    )
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("arch=minicpm-2b params=") and lines[0].endswith("schedule=wsd")
    assert [ln.split()[1] for ln in lines if ln.startswith("step ")] == ["0", "2", "3"]
    assert lines[-2].startswith("loss: ") and lines[-1] == f"checkpoint saved to {ckpt}"
    assert checkpoint.load_metadata(ckpt) == {"arch": "minicpm-2b", "steps": 4}
    assert "import jax" not in Path(train_cli.__file__).read_text()
    # The file is the reference's: its restore reads it, and so does the
    # port's, to the same values.
    from repro.training import checkpoint as ref_ckpt

    cfg = get_arch("minicpm-2b").reduced()
    like = ref_tf.init_params(ref_get_arch("minicpm-2b").reduced(), jax.random.PRNGKey(0), dtype=jnp.float32)
    ref_restored = params_from_jax(cfg, ref_ckpt.restore(ckpt, like))
    port_like = init_params(cfg, torch.Generator().manual_seed(0), device=CPU, dtype=torch.float32)
    restored = checkpoint.restore_params(ckpt, cfg, port_like)
    for (p1, a), (p2, b) in zip(leaves_with_paths(restored), leaves_with_paths(ref_restored)):
        assert p1 == p2
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_train_cli_needs_a_named_device_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--arch", "qwen1.5-0.5b", "--reduced", "--steps", "1"])


# --------------------------------------------------------------------------
# On the card: kernels without a backward refuse a gradient
# --------------------------------------------------------------------------
@pytest.mark.cuda
def test_kernels_without_a_backward_raise_on_a_gradient_request():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.kernels.matmul import matmul
    from repro_torch.kernels.wkv6 import wkv6

    x = torch.randn(16, 32, device="cuda", requires_grad=True)
    with pytest.raises(NotImplementedError, match="block_matmul"):
        matmul(x, torch.randn(32, 8, device="cuda"))
    # wkv6 has its backward kernel: a gradient request launches it.
    r, k, v, w = (torch.rand(1, 8, 2, 16, device="cuda") for _ in range(4))
    u = torch.zeros(2, 16, device="cuda", requires_grad=True)
    before = tracing.counter("launches.wkv6_bwd")
    out, _ = wkv6(r, k, v, w, u)
    (du,) = torch.autograd.grad(out.sum(), [u])
    assert tracing.counter("launches.wkv6_bwd") == before + 1 and bool(torch.isfinite(du).all())
    with torch.no_grad():   # serving: no gradient asked for, the kernels launch
        assert matmul(x, torch.randn(32, 8, device="cuda")).shape == (16, 8)
        assert wkv6(r, k, v, w, u)[0].shape == (1, 8, 2, 16)
    assert tracing.counter("launches.wkv6_bwd") == before + 1


@pytest.mark.cuda
def test_rwkv6_trains_on_the_card_and_serving_still_works():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.models.transformer import forward_loss, prefill_step

    cfg = get_arch("rwkv6-7b").reduced()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda", dtype=torch.float32)
    flat = leaves_with_paths(params)
    batches = batches_for_arch(cfg, 4, 64, device="cuda")
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=1e-3), n_microbatches=2)
    step, opt = make_train_step(cfg, tcfg), adamw_init(params, tcfg.optimizer)
    fwd, bwd = tracing.counter("launches.wkv6"), tracing.counter("launches.wkv6_bwd")
    for _ in range(3):
        params, opt, metrics = step(params, opt, next(batches))
        assert bool(torch.isfinite(metrics["loss"])) and bool(torch.isfinite(metrics["grad_norm"]))
    # Per layer and microbatch: two forwards (remat) and one backward.
    assert tracing.counter("launches.wkv6") - fwd == 2 * cfg.n_layers * 2 * 3
    assert tracing.counter("launches.wkv6_bwd") - bwd == cfg.n_layers * 2 * 3
    live = [p.detach().requires_grad_(True) for _, p in leaves_with_paths(params)]
    loss, _ = forward_loss(cfg, tree_unflatten(params, live), next(batches))
    grads = torch.autograd.grad(loss, live)
    for (path, _), g in zip(flat, grads):
        assert bool(torch.isfinite(g).all()) and bool(g.abs().max() > 0), path
    with torch.no_grad():
        batch = next(batches)
        logits, _ = prefill_step(cfg, params, {"tokens": batch["tokens"]}, 96)
    assert bool(torch.isfinite(logits).all())
