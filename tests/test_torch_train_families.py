"""The port's microbatched train step against the JAX package's, for the
families whose production train step runs on the card beside qwen1.5-0.5b
and gemma3-1b (hymba-1.5b, phi-3-vision-4.2b, musicgen-large, minicpm-2b,
nemotron-4-15b, grok-1-314b, rwkv6-7b) and for llama4, reduced.

The reference's float32 parameters are carried across by
``params_from_jax``; both sides take the reference's ``batches_for_arch``
batches (the frontends' bfloat16 embeddings through float32), two
microbatches a step, two steps, the reference's step jitted.  Per step:
loss within LOSS_TOL, gradient norm within GNORM_TOL.  After the first
step, the first moment (0.1 times the accumulated gradient) leaf by leaf
within MOMENT_TOL of the leaf's norm, and the parameters element by
element, except where AdamW's first update, about ``lr * sign(g)``, turns
on a gradient within rounding of 0.  (Those elements then differ by up to
2 lr, which moves every gradient of the second step a little, so its
parameters are held through its loss and gradient norm.)

Also the train bundle's donation: a step made with ``donate`` writes the
values of the undonated step into the tensors it is given, and the port's
count of a donated bundle holds one copy of the parameters and moments.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.data import pipeline as ref_pipeline
from repro.models import transformer as ref_tf
from repro.training import optimizer as ref_opt
from repro.training import train_loop as ref_loop
from repro_torch.configs import ARCHS, INPUT_SHAPES
from repro_torch.launch import steps
from repro_torch.launch.mesh import MeshView
from repro_torch.models.transformer import init_params, params_from_jax
from repro_torch.roofline.counter import count
from repro_torch.training import optimizer
from repro_torch.training.optimizer import AdamWConfig, adamw_init
from repro_torch.training.train_loop import TrainConfig, make_train_step
from repro_torch.training.tree import leaves_with_paths, tree_map

FAMILIES = ["hymba-1.5b", "phi-3-vision-4.2b", "musicgen-large", "minicpm-2b", "nemotron-4-15b",
            "grok-1-314b", "rwkv6-7b", "llama4-maverick-400b-a17b"]
# hymba-1.5b also with the chunked SSM scan, as the card trains it (the
# reference's --opt setting): 64 positions are two chunks of 32.
CASES = [(name, False) for name in FAMILIES] + [("hymba-1.5b", True)]
BATCH, SEQ, MICRO, STEPS, LR = 4, 32, 2, 2, 1e-3
CHUNKED_SEQ = 64
LOSS_TOL, GNORM_TOL, MOMENT_TOL = 1e-4, 1e-3, 1e-4
# AdamW's first update moves an element by about lr * sign(g): where |g| is
# within rounding of 0 the two packages may give it opposite signs.  Such
# elements (the step-1 gradient within SIGN_TOL of the leaf's RMS) are
# left out of the parameters' comparison.  Elsewhere a parameter may still
# move by lr * eps |dg| / g^2 more on one side, from float32 rounding dg of
# a small gradient g against AdamW's eps (1e-8); PARAM_ATOL, a tenth of a
# step, holds it, where a wrong update (one whose gradient is wrong by a
# share of itself) would be off by a share of the step and a flipped one
# by two steps.
SIGN_TOL = 1e-4
PARAM_RTOL, PARAM_ATOL = 1e-5, 0.1 * LR


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The suite runs several workers on a few cores: two intra-op threads
    for this file's torch ops keep it from starving the wall-clock tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _torch_batch(batch):
    """The reference's batch for the port: token ids as int64, embeddings
    (``ml_dtypes.bfloat16`` arrays) through float32 into bfloat16."""
    out = {}
    for k, a in batch.items():
        a = np.asarray(a)
        if np.issubdtype(a.dtype, np.integer):
            out[k] = torch.from_numpy(a.astype(np.int64))
        else:
            out[k] = torch.from_numpy(a.astype(np.float32)).bfloat16()
    return out


def _port(cfg, tree):
    return dict(leaves_with_paths(params_from_jax(cfg, tree)))


@pytest.mark.parametrize("name, chunked", CASES, ids=[n + ("-chunked-scan" if c else "") for n, c in CASES])
def test_train_step_equals_the_reference(name, chunked):
    ref_cfg, cfg = REF_ARCHS[name].reduced(), ARCHS[name].reduced()
    seq = SEQ
    if chunked:
        ref_cfg = dataclasses.replace(ref_cfg, use_chunked_scan=True)
        cfg = dataclasses.replace(cfg, use_chunked_scan=True)
        seq = CHUNKED_SEQ
    ref_params = ref_tf.init_params(ref_cfg, jax.random.PRNGKey(7), dtype=jnp.float32)
    params = params_from_jax(cfg, ref_params)
    ref_t = ref_loop.TrainConfig(optimizer=ref_opt.AdamWConfig(lr=LR), n_microbatches=MICRO)
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=LR), n_microbatches=MICRO)
    ref_step, step = jax.jit(ref_loop.make_train_step(ref_cfg, ref_t)), make_train_step(cfg, tcfg)
    ref_state, state = ref_opt.adamw_init(ref_params, ref_t.optimizer), adamw_init(params, tcfg.optimizer)
    data = ref_pipeline.batches_for_arch(ref_cfg, BATCH, seq, seed=3)
    flips = None
    for i, batch in zip(range(STEPS), data):
        ref_params, ref_state, want = ref_step(ref_params, ref_state, batch, 1.0)
        params, state, got = step(params, state, _torch_batch(batch), 1.0)
        assert float(got["loss"]) == pytest.approx(float(want["loss"]), rel=LOSS_TOL), i
        assert float(got["grad_norm"]) == pytest.approx(float(want["grad_norm"]), rel=GNORM_TOL), i
        if i == 0:
            ref_m = _port(cfg, ref_state["m"])
            for path, m in leaves_with_paths(state["m"]):
                w = ref_m[path].float()
                assert float((m.float() - w).norm()) <= MOMENT_TOL * float(w.norm()) + 1e-30, path
            # The step-1 gradient is the first moment over 1 - b1.
            g1 = {path: m.float() / (1 - ref_t.optimizer.b1) for path, m in ref_m.items()}
            flips = {path: g.abs() < SIGN_TOL * g.square().mean().sqrt() for path, g in g1.items()}
            ref_p = _port(cfg, ref_params)
            for path, p in leaves_with_paths(params):
                keep = ~flips[path]
                torch.testing.assert_close(p.float()[keep], ref_p[path].float()[keep], rtol=PARAM_RTOL,
                                           atol=PARAM_ATOL, msg=path)


@pytest.mark.parametrize("name", ["grok-1-314b", "rwkv6-7b"])
def test_donated_step_writes_the_same_values_in_place(monkeypatch, name):
    """Two microbatched steps with ``donate``: each returns the tensors it
    was given, holding bit for bit the undonated step's parameters and
    moments (leaves cut into slices of 1000 elements, as a full-width leaf
    is cut into ``optimizer.SLICE``)."""
    monkeypatch.setattr(optimizer, "SLICE", 1000)
    cfg = ARCHS[name].reduced()
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=LR), n_microbatches=MICRO)
    params = init_params(cfg, torch.Generator().manual_seed(1), device="cpu", dtype=torch.float32)
    assert max(p.numel() for _, p in leaves_with_paths(params)) > optimizer.SLICE
    state = adamw_init(params, tcfg.optimizer)
    mine = tree_map(torch.clone, params), tree_map(torch.clone, state)
    plain, donated = make_train_step(cfg, tcfg), make_train_step(cfg, tcfg, donate=True)
    for i, batch in zip(range(STEPS), ref_pipeline.batches_for_arch(REF_ARCHS[name].reduced(), BATCH, SEQ, seed=5)):
        batch = _torch_batch(batch)
        params, state, want = plain(params, state, batch)
        given = mine
        *mine, got = donated(*mine, batch)
        assert float(got["loss"]) == float(want["loss"]) and float(got["grad_norm"]) == float(want["grad_norm"])
        for tree, ref, before in ((mine[0], params, given[0]), (mine[1], state, given[1])):
            for (path, a), (_, b), (_, c) in zip(leaves_with_paths(tree), leaves_with_paths(ref),
                                                 leaves_with_paths(before), strict=True):
                assert torch.equal(a, b), (i, path)
                if path != "['step']":
                    assert a is c, (i, path)


def test_donated_bundle_holds_one_copy_of_the_state():
    """nemotron-4-15b at full width, one layer, train_4k's microbatch four
    times: the step's temporaries (gradients, activations, the update's
    slices) stay below one copy of the parameters and moments, which a
    step that returned new tensors would hold on top of the old ones."""
    cfg = dataclasses.replace(ARCHS["nemotron-4-15b"], n_layers=1)
    shape = dataclasses.replace(INPUT_SHAPES["train_4k"], global_batch=4)
    bundle = steps.build_train(cfg, shape, MeshView({"data": 1, "model": 1}, ("data", "model")))
    _, memory = count(bundle)
    state = sum(t.untyped_storage().nbytes() for _, t in leaves_with_paths(bundle.args[:2]))
    assert memory["temp_bytes"] < state, memory
