"""The port's ``forward_loss`` and its gradient against the JAX package's.

For every registered architecture, reduced: the reference's float32
parameters carried across by ``params_from_jax``, the same seeded numpy
batch on both sides, the loss and every parameter's gradient against
``jax.value_and_grad`` of the reference's ``forward_loss``.  On the CPU the
port's attention goes through ``_FlashAttention`` (the autograd function
the card uses) with the plain versions of its kernels, and rwkv6's time mix
through the plain ``wkv6`` recurrence; MoE layers keep the reference's
capacity, so both drop the same tokens.  Then ``remat=True``, ``False`` and
``"dots"`` give the port the same gradients.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.models import transformer as ref_tf
from repro_torch.configs import ARCHS
from repro_torch.models.transformer import forward_loss, params_from_jax
from repro_torch.training.tree import leaves_with_paths

B, S = 2, 24          # past the reduced window (16); the vision patches come first
LOSS_TOL = 1e-5       # relative
GRAD_TOL = 1e-4       # each leaf's error norm over its norm


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The suite runs several workers on a few cores: two intra-op threads
    for this file's torch ops keep it from starving the wall-clock tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _batch(cfg, seed):
    """A seeded numpy batch: tokens or frame embeddings, labels, and for the
    vision frontend its patch embeddings (embeddings rounded to bfloat16,
    the frontends' type, on both sides)."""
    rng = np.random.default_rng(seed)
    s_text = S - cfg.n_patches if cfg.frontend == "vision" else S
    batch = {"labels": rng.integers(0, cfg.vocab_size, (B, s_text), dtype=np.int32)}
    if cfg.frontend == "audio":
        batch["frame_embeds"] = rng.standard_normal((B, S, cfg.frontend_dim), dtype=np.float32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab_size, (B, s_text), dtype=np.int32)
    if cfg.frontend == "vision":
        batch["patch_embeds"] = rng.standard_normal((B, cfg.n_patches, cfg.frontend_dim), dtype=np.float32)
    return batch


def _jax_batch(batch):
    return {k: jnp.asarray(a).astype(jnp.bfloat16) if a.dtype == np.float32 else jnp.asarray(a)
            for k, a in batch.items()}


def _torch_batch(batch):
    return {k: torch.from_numpy(a).bfloat16() if a.dtype == np.float32 else torch.from_numpy(a).long()
            for k, a in batch.items()}


def _port_grads(cfg, params, batch, **kw):
    """(loss, {"ce", "aux"}, gradient of every leaf by path)."""
    flat = leaves_with_paths(params)
    for _, p in flat:
        p.requires_grad_(True)
    try:
        loss, metrics = forward_loss(cfg, params, batch, **kw)
        grads = torch.autograd.grad(loss, [p for _, p in flat], allow_unused=True)
    finally:
        for _, p in flat:
            p.requires_grad_(False)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, {
        path: torch.zeros_like(p) if g is None else g for (path, p), g in zip(flat, grads)
    }


@pytest.fixture(scope="module")
def runs():
    """Per arch: the reference's (loss, metrics, gradients as the port's
    tree) and the port's (loss, metrics, gradients) under each remat
    setting."""
    out = {}
    for name in ARCHS:
        ref_cfg, cfg = REF_ARCHS[name].reduced(), ARCHS[name].reduced()
        ref_params = ref_tf.init_params(ref_cfg, jax.random.PRNGKey(11), dtype=jnp.float32)
        batch = _batch(cfg, seed=5)
        (ref_loss, ref_metrics), ref_grads = jax.value_and_grad(
            lambda p: ref_tf.forward_loss(ref_cfg, p, _jax_batch(batch)), has_aux=True
        )(ref_params)
        ref_grads = dict(leaves_with_paths(params_from_jax(cfg, ref_grads)))
        params = params_from_jax(cfg, ref_params)
        port = {
            remat: _port_grads(cfg, params, _torch_batch(batch), remat=remat is not False,
                               remat_policy="dots" if remat == "dots" else "nothing")
            for remat in (True, False, "dots")
        }
        out[name] = ((float(ref_loss), {k: float(v) for k, v in ref_metrics.items()}, ref_grads), port)
    return out


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    want = want.float()
    return float((got.float() - want).norm() / want.norm().clamp_min(1e-30))


@pytest.mark.parametrize("name", list(ARCHS))
def test_loss_equals_the_reference(runs, name):
    (ref_loss, ref_metrics, _), port = runs[name]
    loss, metrics, _ = port[True]
    assert float(loss) == pytest.approx(ref_loss, rel=LOSS_TOL)
    assert float(metrics["ce"]) == pytest.approx(ref_metrics["ce"], rel=LOSS_TOL)
    assert float(metrics["aux"]) == pytest.approx(ref_metrics["aux"], rel=LOSS_TOL, abs=1e-7)
    if ARCHS[name].is_moe:
        assert ref_metrics["aux"] > 0


@pytest.mark.parametrize("name", list(ARCHS))
def test_every_gradient_equals_the_reference(runs, name):
    (_, _, ref_grads), port = runs[name]
    _, _, grads = port[True]
    assert set(grads) == set(ref_grads)
    bad = {path: _rel(g, ref_grads[path]) for path, g in grads.items() if _rel(g, ref_grads[path]) > GRAD_TOL}
    assert not bad, bad
    # Every leaf the loss reads gets a gradient (the audio frontend never
    # reads the token embedding).
    unread = {"['embed']"} if ARCHS[name].frontend == "audio" else set()
    zero = {path for path, g in grads.items() if not bool(g.abs().max() > 0)}
    assert zero == unread, zero


@pytest.mark.parametrize("name", list(ARCHS))
def test_remat_settings_give_the_same_gradients(runs, name):
    _, port = runs[name]
    loss, _, want = port[True]
    for remat in (False, "dots"):
        other_loss, _, got = port[remat]
        assert float(other_loss) == pytest.approx(float(loss), rel=1e-6)
        for path, g in got.items():
            assert _rel(g, want[path]) <= 1e-6, (remat, path)
