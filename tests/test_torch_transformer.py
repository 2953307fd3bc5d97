"""The port's model zoo (configs, layers, attention, RWKV6, transformer
prefill and decode) against the JAX package's, with the reference's
parameters carried across by ``params_from_jax``.

Everything runs on the CPU in float32, where the port's kernels compute
their plain versions and the reference runs its own paths.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import INPUT_SHAPES as REF_SHAPES
from repro.models import layers as ref_layers
from repro.models import transformer as ref_tf
from repro_torch.configs import ARCHS, INPUT_SHAPES
from repro_torch.models import layers, transformer
from repro_torch.models.transformer import (
    backbone,
    count_params,
    decode_step,
    embed_inputs,
    init_decode_caches,
    init_params,
    layer_window_values,
    params_from_jax,
    prefill_step,
    unembed,
)

PARITY_ARCHS = [
    "qwen1.5-0.5b", "gemma3-1b", "minicpm-2b", "nemotron-4-15b", "rwkv6-7b",
    "grok-1-314b", "llama4-maverick-400b-a17b", "hymba-1.5b", "phi-3-vision-4.2b", "musicgen-large",
]
# Positions of the prompt (patches included) and decode steps; the prompt
# is longer than the reduced window (16).
PROMPT, DECODE, MAX_LEN = 24, 8, 40
TOL = 1e-4


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol, err_msg=msg)


def _stream(cfg, b, n_pos, seed):
    """Seeded numpy inputs of ``n_pos`` positions: (the vision frontend's
    patch embeddings or None, the per-position inputs after them: token
    ids (b, n) or, for the audio frontend, frame embeddings (b, n, dim)).
    Embeddings are rounded to bfloat16, the frontends' embedding type, the
    same way on both sides."""
    rng = np.random.default_rng(seed)
    patches = None
    if cfg.frontend == "vision":
        patches = rng.standard_normal((b, cfg.n_patches, cfg.frontend_dim), dtype=np.float32)
        n_pos -= cfg.n_patches
    if cfg.frontend == "audio":
        return patches, rng.standard_normal((b, n_pos, cfg.frontend_dim), dtype=np.float32)
    return patches, rng.integers(0, cfg.vocab_size, (b, n_pos), dtype=np.int32)


def _batch(cfg, patches, seq, lib):
    """The prefill batch of ``seq`` (and the patches) for the reference
    (``lib="jax"``) or the port (``"torch"``)."""
    def embeds(a):
        return jnp.asarray(a).astype(jnp.bfloat16) if lib == "jax" else torch.from_numpy(a).bfloat16()

    if cfg.frontend == "audio":
        return {"frame_embeds": embeds(seq)}
    batch = {"tokens": jnp.asarray(seq) if lib == "jax" else torch.from_numpy(seq).long()}
    if patches is not None:
        batch["patch_embeds"] = embeds(patches)
    return batch


def _step(cfg, seq, t, lib):
    """The decode input of position ``t`` of ``seq``."""
    batch = _batch(cfg, None, seq[:, t : t + 1], lib)
    return batch["frame_embeds" if cfg.frontend == "audio" else "tokens"]


# --------------------------------------------------------------------------
# Configs
# --------------------------------------------------------------------------
def test_registry_equals_the_reference():
    assert list(ARCHS) == list(REF_ARCHS)
    for name, cfg in ARCHS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(REF_ARCHS[name])
        assert dataclasses.asdict(cfg.reduced()) == dataclasses.asdict(REF_ARCHS[name].reduced())
    assert {k: dataclasses.asdict(v) for k, v in INPUT_SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in REF_SHAPES.items()
    }


@pytest.mark.parametrize("name", ARCHS)
def test_parameter_count_and_windows_equal_the_reference(name):
    cfg, ref_cfg = ARCHS[name], REF_ARCHS[name]
    assert count_params(cfg) == ref_tf.count_params(ref_cfg)
    assert cfg.param_count() == ref_cfg.param_count()
    assert count_params(cfg, active_only=True) == ref_tf.count_params(ref_cfg, active_only=True)
    assert cfg.active_param_count() == ref_cfg.active_param_count()
    assert (cfg.active_param_count() < cfg.param_count()) == cfg.is_moe
    assert layer_window_values(cfg) == ref_tf.layer_window_values(ref_cfg).reshape(-1).tolist()


# --------------------------------------------------------------------------
# Layers
# --------------------------------------------------------------------------
def test_rms_norm_scales_by_one_plus_weight():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 32), dtype=np.float32)
    w = rng.standard_normal(32, dtype=np.float32)
    want = ref_layers.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)
    _close(layers.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6), want, 1e-6)


@pytest.mark.parametrize("positions_2d", [False, True])
def test_apply_rope_rotates_halves(positions_2d):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 16), dtype=np.float32)
    pos = np.arange(7, dtype=np.int32) + 5
    if positions_2d:
        pos = np.stack([pos, pos + 100])
    want = ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4)
    _close(layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4), want, 1e-6)


@pytest.mark.parametrize("kind", ["swiglu", "gelu", "relu2"])
def test_mlp_forward(kind):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 3, 16), dtype=np.float32)
    p = {
        name: (rng.standard_normal(shape, dtype=np.float32) * 0.25)
        for name, shape in (("w_in", (16, 32)), ("w_gate", (16, 32)), ("w_out", (32, 16)))
    }
    want = ref_layers.mlp_forward(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}, kind)
    got = layers.mlp_forward(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in p.items()}, kind)
    _close(got, want, 1e-6)


@pytest.mark.parametrize("window", [0, 3])
def test_attention_plain_with_causal_window_mask(window):
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((1, 9, 2, 8), dtype=np.float32) for _ in range(3))
    pos = np.arange(9)
    want = ref_layers.attention_plain(
        *map(jnp.asarray, (q, k, v)), ref_layers.causal_window_mask(jnp.asarray(pos), jnp.asarray(pos), window), 0.3
    )
    tpos = torch.from_numpy(pos)
    mask = layers.causal_window_mask(tpos, tpos, window)
    got = layers.attention_plain(*map(torch.from_numpy, (q, k, v)), mask, 0.3)
    _close(got, want, 1e-6)
    _close(layers.repeat_kv(torch.from_numpy(k), 3), ref_layers.repeat_kv(jnp.asarray(k), 3), 0)


# --------------------------------------------------------------------------
# Prefill and decode against the reference
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def runs():
    """Per arch: the reference's and the port's prefill of a PROMPT-position
    batch of 2, then DECODE teacher-forced decode steps, from the
    reference's float32 parameters.  The reference's steps are jitted, as
    ``launch/steps.py`` serves them."""
    ref_prefill = jax.jit(ref_tf.prefill_step, static_argnums=(0, 3))
    ref_decode = jax.jit(ref_tf.decode_step, static_argnums=(0,))
    out = {}
    for name in PARITY_ARCHS:
        ref_cfg, cfg = REF_ARCHS[name].reduced(), ARCHS[name].reduced()
        ref_params = ref_tf.init_params(ref_cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
        params = params_from_jax(cfg, ref_params)
        patches, seq = _stream(cfg, 2, PROMPT + DECODE, seed=7)
        first = PROMPT - (cfg.n_patches if patches is not None else 0)   # inputs of seq in the prompt
        ref_logits, ref_caches = ref_prefill(
            ref_cfg, ref_params, _batch(cfg, patches, seq[:, :first], "jax"), MAX_LEN
        )
        logits, caches = prefill_step(cfg, params, _batch(cfg, patches, seq[:, :first], "torch"), MAX_LEN)
        run = {
            "prefill": (np.asarray(ref_logits), logits.numpy()),
            "caches": (
                [{k: np.asarray(a) for k, a in c.items()} for c in ref_caches],
                [{k: a.clone().numpy() for k, a in c.items()} for c in caches],
            ),
            "decode": [],
        }
        for j in range(DECODE):
            t = PROMPT + j
            ref_logits, ref_caches = ref_decode(
                ref_cfg, ref_params, ref_caches, _step(cfg, seq, first + j, "jax"), jnp.int32(t)
            )
            logits, caches = decode_step(cfg, params, caches, _step(cfg, seq, first + j, "torch"), t)
            run["decode"].append((np.asarray(ref_logits), logits.numpy()))
        out[name] = run
    return out


@pytest.mark.parametrize("name", PARITY_ARCHS)
def test_prefill_logits_and_caches_match_the_reference(runs, name):
    want, got = runs[name]["prefill"]
    assert got.shape == want.shape == (2, 1, ARCHS[name].reduced().vocab_size)
    _close(got, want, msg=f"{name}: prefill last-token logits")
    ref_caches, caches = runs[name]["caches"]
    assert len(caches) == len(ref_caches)
    for i, (c_want, c_got) in enumerate(zip(ref_caches, caches)):
        assert sorted(c_got) == sorted(c_want)
        for key in c_want:
            assert c_got[key].shape == c_want[key].shape, (i, key)
            _close(c_got[key], c_want[key], msg=f"{name}: layer {i} cache {key!r}")


@pytest.mark.parametrize("name", PARITY_ARCHS)
def test_decode_logits_match_the_reference(runs, name):
    for step, (want, got) in enumerate(runs[name]["decode"]):
        _close(got, want, msg=f"{name}: decode step {step}")


@pytest.mark.parametrize("name", PARITY_ARCHS)
def test_full_forward_matches_the_reference(name):
    """embed_inputs (with the vision frontend's loss mask), backbone (with
    the MoE layers' load-balance loss) and unembed, from the reference's
    float32 parameters."""
    ref_cfg, cfg = REF_ARCHS[name].reduced(), ARCHS[name].reduced()
    ref_params = ref_tf.init_params(ref_cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    params = params_from_jax(cfg, ref_params)
    patches, seq = _stream(cfg, 2, PROMPT, seed=11)
    ref_h, ref_mask = ref_tf.embed_inputs(ref_cfg, ref_params, _batch(cfg, patches, seq, "jax"))
    h, mask = embed_inputs(cfg, params, _batch(cfg, patches, seq, "torch"))
    assert (mask is None) == (ref_mask is None) == (cfg.frontend != "vision")
    if mask is not None:
        assert np.array_equal(mask.numpy(), np.asarray(ref_mask))
    _close(h, ref_h, msg=f"{name}: embeddings")
    ref_h, ref_aux = ref_tf.backbone(ref_cfg, ref_params, ref_h, remat=False)
    h, aux = backbone(cfg, params, h, remat=False)
    _close(aux, ref_aux, msg=f"{name}: MoE load-balance loss")
    assert (float(aux) > 0) == cfg.is_moe
    _close(unembed(cfg, params, h), ref_tf.unembed(ref_cfg, ref_params, ref_h), msg=f"{name}: logits")


@pytest.mark.parametrize("name", PARITY_ARCHS)
def test_prefill_then_decode_equals_the_full_forward(name):
    """The port's own invariant (as ``tests/test_prefill_decode.py``), from
    its own parameters: prefilling 8 positions (after the patches, for the
    vision frontend), then decoding, gives the logits of one full forward;
    with a window, a prompt of 20 overruns the reduced window of 16.  MoE
    layers take capacity factor 8.0, as the reference's test does: prefill
    groups could otherwise drop tokens that one-token decode never drops."""
    cfg = ARCHS[name].reduced()
    if cfg.is_moe:
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu", dtype=torch.float32)
    n_patches = cfg.n_patches if cfg.frontend == "vision" else 0
    prompt = (20 if cfg.window else 8) + n_patches
    patches, seq = _stream(cfg, 1, prompt + 4, seed=1)
    h, _ = embed_inputs(cfg, params, _batch(cfg, patches, seq, "torch"))
    full = unembed(cfg, params, backbone(cfg, params, h, remat=False)[0])
    first = prompt - n_patches
    logits, caches = prefill_step(cfg, params, _batch(cfg, patches, seq[:, :first], "torch"), max_len=32)
    torch.testing.assert_close(logits[:, 0], full[:, prompt - 1], rtol=2e-3, atol=2e-3)
    for j in range(4):
        logits, caches = decode_step(cfg, params, caches, _step(cfg, seq, first + j, "torch"), prompt + j)
        torch.testing.assert_close(logits[:, 0], full[:, prompt + j], rtol=5e-3, atol=5e-3)


@pytest.mark.parametrize(
    "name",
    ["gemma3-1b", "rwkv6-7b", "grok-1-314b", "llama4-maverick-400b-a17b", "hymba-1.5b",
     "phi-3-vision-4.2b", "musicgen-large"],
)
def test_init_params_has_the_reference_structure(name):
    cfg = ARCHS[name].reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    ref_params = params_from_jax(cfg, ref_tf.init_params(REF_ARCHS[name].reduced(), jax.random.PRNGKey(0)))
    flat = lambda p: {  # noqa: E731
        k: (tuple(t.shape), t.dtype) for k, t in torch.utils._pytree.tree_flatten_with_path(p)[0]
    }
    assert flat(params) == flat(ref_params)
    assert sum(t.numel() for t in torch.utils._pytree.tree_leaves(params)) == count_params(cfg)
    caches = init_decode_caches(cfg, 2, MAX_LEN, device="cpu")
    assert len(caches) == cfg.n_layers


def test_entry_points_default_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = ARCHS["gemma3-1b"].reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_decode_caches(cfg, 1, 8)
    assert transformer.DEFAULT_DTYPE == torch.bfloat16


@pytest.mark.parametrize("head_dim,theta", [(16, 1e4), (256, 1e6)])
def test_rope_frequencies_equal_the_reference(head_dim, theta):
    want = ref_layers.rope_frequencies(head_dim, theta).astype(np.float32)
    assert np.array_equal(layers.rope_frequencies(head_dim, theta).numpy(), want)
