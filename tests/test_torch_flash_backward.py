"""The gradient of the port's ``causal_attention`` against autograd and the
JAX package.

``causal_attention_bwd_plain`` (the backward kernels' plain version) and
autograd through ``_FlashAttention`` on CPU tensors (the plumbing the card
runs: saved tensors, GQA shapes, dtypes) are held against three things:
``torch.autograd.grad`` of ``causal_attention_plain``, ``jax.grad`` of the
reference's ``kernels/ref.py::attention_ref`` (KV heads repeated, as
``tests/test_kernels.py`` lays it out) and ``jax.grad`` of
``models/layers.py::attention_chunked`` at lengths past its chunks.  The
hand-written CUDA kernels are held against the plain version by the test
here that needs a card (skipped without one) and by ``chip_smoke.py``.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.models import layers as ref_layers
from repro_torch import tracing
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels.flash_attention import (
    HEAD_DIMS,
    causal_attention,
    causal_attention_bwd,
    causal_attention_bwd_plain,
    causal_attention_plain,
)

# Error norm over the reference's norm, per gradient: float32 arithmetic
# in another order; for bfloat16 inputs the gradients are stored in
# bfloat16 and JAX rounds do v^T to bfloat16 where the port keeps float32.
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The suite runs several workers on a few cores: two intra-op threads
    for this file's torch ops keep it from starving the wall-clock tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _inputs(b, s, h, kv, hd, dtype, seed):
    """Seeded numpy q, k, v and the output gradient, as (jax, torch) of
    ``dtype``."""
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(shape, dtype=np.float32)
              for shape in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd), (b, s, h, hd))]
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    return (
        [jnp.asarray(a).astype(jdt) for a in arrays],
        [torch.from_numpy(a).to(tdt) for a in arrays],
    )


def _rel(got, want) -> float:
    got = np.asarray(got.float().cpu() if isinstance(got, torch.Tensor) else got.astype(jnp.float32), np.float64)
    want = np.asarray(want.float().cpu() if isinstance(want, torch.Tensor) else want.astype(jnp.float32), np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _close(got, want, dtype, what=""):
    for name, g, w in zip("qkv", got, want):
        err = _rel(g, w)
        assert err <= TOL[dtype], f"{what} d{name}: {err:.3e} > {TOL[dtype]}"


def _port_grads(q, k, v, do, scale, window, fn=causal_attention):
    q, k, v = (a.clone().requires_grad_(True) for a in (q, k, v))
    out = fn(q, k, v, scale=scale, window=window)
    return out.detach(), torch.autograd.grad(out, (q, k, v), do)


def _ref_grads(q, k, v, do, scale, window):
    """jax.grad of ``attention_ref`` over the natural layout, KV heads
    repeated inside the function (so dk, dv sum over each group)."""
    b, s, h, hd = q.shape
    rep = h // k.shape[2]

    def flat(a):
        return a.transpose(0, 2, 1, 3).reshape(b * h, s, hd)

    def f(q, k, v):
        k, v = jnp.repeat(k, rep, axis=2), jnp.repeat(v, rep, axis=2)
        out = ref.attention_ref(flat(q), flat(k), flat(v), scale=scale, window=window)
        return out.reshape(b, h, s, hd).transpose(0, 2, 1, 3)

    _, vjp = jax.vjp(f, q, k, v)
    return vjp(do)


def _check_all(b, s, h, kv, hd, window, dtype, seed):
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _inputs(b, s, h, kv, hd, dtype, seed)
    scale = 1.0 / np.sqrt(hd)
    out, through_function = _port_grads(tq, tk, tv, tdo, scale, window)
    _, through_plain = _port_grads(tq, tk, tv, tdo, scale, window, fn=causal_attention_plain)
    plain = causal_attention_bwd_plain(tq, tk, tv, out, tdo, scale=scale, window=window)
    reference = _ref_grads(jq, jk, jv, jdo, scale, window)
    for got, name in ((through_function, "_FlashAttention"), (plain, "bwd_plain")):
        assert [g.dtype for g in got] == [tq.dtype] * 3
        assert [g.shape for g in got] == [tq.shape, tk.shape, tv.shape]
        _close(got, through_plain, dtype, f"{name} vs autograd of causal_attention_plain")
        _close(got, reference, dtype, f"{name} vs jax.grad of attention_ref")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_every_head_dim(hd, dtype):
    _check_all(2, 37, 4, 2, hd, 16, dtype, seed=hd)


@pytest.mark.parametrize("group", [1, 4, 8])
@pytest.mark.parametrize("window", [0, 16, 44])   # global, windowed, S - 1
def test_windows_and_groups_at_a_ragged_length(window, group):
    _check_all(1, 45, 8, 8 // group, 32, window, "float32", seed=window + group)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 512])
def test_matches_jax_grad_of_attention_chunked(window, dtype):
    """At 2048 positions ``attention_chunked`` scans 4 query chunks of 512
    and 2 KV chunks of 1024 (its defaults); the reference trains through
    it from ``CHUNKED_SEQ_THRESHOLD`` (2048) up."""
    b, s, h, kv, hd = 1, 2048, 2, 1, 16
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _inputs(b, s, h, kv, hd, dtype, seed=3)
    scale = 1.0 / np.sqrt(hd)
    pos = jnp.arange(s)

    def f(q, k, v):
        k, v = jnp.repeat(k, h // kv, axis=2), jnp.repeat(v, h // kv, axis=2)
        return ref_layers.attention_chunked(q, k, v, pos, pos, window, scale)

    _, vjp = jax.vjp(f, jq, jk, jv)
    out, got = _port_grads(tq, tk, tv, tdo, scale, window)
    _close(got, vjp(jdo), dtype, "_FlashAttention vs jax.grad of attention_chunked")
    _close(causal_attention_bwd_plain(tq, tk, tv, out, tdo, scale=scale, window=window), vjp(jdo), dtype,
           "bwd_plain vs jax.grad of attention_chunked")


@pytest.mark.parametrize("group", [1, 4, 8])
def test_group_sum_covers_every_query_head(group):
    """With an output gradient on one query head at a time, each head of a
    group gives its own non-zero dk and dv, and the gradient of all of them
    together is their sum: a sum that covered one head only would fail."""
    h, hd = 8, 16
    _, (q, k, v, do) = _inputs(1, 40, h, h // group, hd, "float32", seed=group)
    scale = 1.0 / np.sqrt(hd)
    out = causal_attention_plain(q, k, v, scale=scale)
    _, dk_all, dv_all = causal_attention_bwd_plain(q, k, v, out, do, scale=scale)
    dk_sum, dv_sum = torch.zeros_like(dk_all), torch.zeros_like(dv_all)
    for head in range(h):
        one = torch.zeros_like(do)
        one[:, :, head] = do[:, :, head]
        _, dk, dv = causal_attention_bwd_plain(q, k, v, out, one, scale=scale)
        _, (_, dk_f, dv_f) = _port_grads(q, k, v, one, scale, 0)
        np.testing.assert_allclose(dk_f.numpy(), dk.numpy(), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(dv_f.numpy(), dv.numpy(), rtol=1e-5, atol=1e-6)
        kv_head = head // group
        assert float(dk[:, :, kv_head].abs().max()) > 0 and float(dv[:, :, kv_head].abs().max()) > 0
        others = [j for j in range(h // group) if j != kv_head]
        assert float(dk[:, :, others].abs().sum()) == 0.0
        dk_sum += dk
        dv_sum += dv
    np.testing.assert_allclose(dk_sum.numpy(), dk_all.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(dv_sum.numpy(), dv_all.numpy(), rtol=1e-5, atol=1e-6)


def test_plain_backward_runs_in_float64_for_float64_inputs():
    """The plain version computes in float64 when given float64 (the
    yardstick ``chip_smoke.py`` holds both the kernel and the float32 plain
    version against); it agrees with the float32 one to float32 rounding."""
    _, (q, k, v, do) = _inputs(1, 40, 4, 2, 32, "float32", seed=5)
    scale = 32 ** -0.5
    out = causal_attention_plain(q, k, v, scale=scale, window=16)
    got = causal_attention_bwd_plain(*(a.double() for a in (q, k, v, out, do)), scale=scale, window=16)
    want = causal_attention_bwd_plain(q, k, v, out, do, scale=scale, window=16)
    assert [g.dtype for g in got] == [torch.float64] * 3
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-6


def test_masked_pairs_get_no_gradient():
    """A key outside every query's window gets no gradient from a query
    that cannot see it: with window 1 each query sees its own key alone
    (p = 1), so dv is do and dq, dk are 0 up to rounding (ds = dp - delta,
    two sums of the same products)."""
    _, (q, k, v, do) = _inputs(1, 20, 2, 2, 16, "float32", seed=9)
    out, (dq, dk, dv) = _port_grads(q, k, v, do, 0.25, 1)
    np.testing.assert_allclose(out.numpy(), v.numpy(), rtol=1e-6, atol=1e-6)
    assert float(dq.abs().max()) < 1e-5 and float(dk.abs().max()) < 1e-5
    np.testing.assert_allclose(dv.numpy(), do.numpy(), rtol=1e-6, atol=1e-6)


def test_autograd_only_when_a_gradient_is_asked_for():
    _, (q, k, v, _) = _inputs(1, 8, 2, 1, 16, "float32", seed=1)
    assert causal_attention(q, k, v, scale=0.25).grad_fn is None
    out = causal_attention(q.requires_grad_(True), k, v, scale=0.25)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    with torch.no_grad():
        assert causal_attention(q, k, v, scale=0.25).grad_fn is None


@pytest.mark.parametrize("which", ["o", "do"])
def test_backward_wrapper_rejects_a_mismatched_output(which):
    _, (q, k, v, do) = _inputs(1, 8, 2, 1, 16, "float32", seed=2)
    args = {"o": q.clone(), "do": do}
    args[which] = args[which][:, :4]
    with pytest.raises(ValueError, match=which):
        causal_attention_bwd(q, k, v, args["o"], args["do"], scale=0.25)


def test_backward_source_dispatches_every_head_dim():
    """The launch entry and the shared-memory query each cover
    ``HEAD_DIMS`` in order, in their bfloat16 switch and their float32 one
    (which routes each case takes: ``test_torch_flash_backward_tc.py``)."""
    src = (fa_mod.build.CSRC_DIR / "flash_attention_bwd.cu").read_text()
    for entry, call in (('extern "C" int flash_attention_bwd(', "launch"),
                        ('extern "C" int flash_attention_bwd_smem(', "smem_of")):
        body = src[src.index(entry):]
        bf16_switch = body[body.index("if (is_bf16) {"):]
        f32_switch = bf16_switch[bf16_switch.index("default:") + 1:]
        for part in (bf16_switch[:bf16_switch.index("default:")], f32_switch[:f32_switch.index("default:")]):
            cases = re.findall(rf"case (\d+): return (?:tc::)?{call}<(?:\w+, )?(\d+)>", part)
            assert all(a == b for a, b in cases)
            assert tuple(int(a) for a, _ in cases) == HEAD_DIMS


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_backward_kernel_matches_plain_version(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the backward kernel has no CPU mode")
    for b, s, h, kv, hd, window in [(2, 37, 4, 1, 64, 0), (1, 130, 8, 2, 256, 17), (2, 100, 4, 4, 96, 0),
                                    (1, 200, 4, 1, 256, 0)]:
        _, tensors = _inputs(b, s, h, kv, hd, dtype, seed=s)
        q, k, v, do = (a.cuda() for a in tensors)
        scale = 1.0 / np.sqrt(hd)
        before = tracing.counter("launches.causal_attention_bwd")
        out, got = _port_grads(q, k, v, do, scale, window)
        torch.cuda.synchronize()
        assert tracing.counter("launches.causal_attention_bwd") == before + 1
        _close(got, causal_attention_bwd_plain(q, k, v, out, do, scale=scale, window=window), dtype, "kernel")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_backward_kernel_is_deterministic(dtype):
    """No atomics, sums in one fixed order: two calls on the same inputs give
    the same bits, also where the dK/dV work list cuts key tiles."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the backward kernel has no CPU mode")
    for b, s, h, kv, hd, window in [(1, 300, 8, 1, 16, 299), (2, 2048, 4, 1, 256, 0), (2, 512, 16, 16, 64, 0)]:
        _, tensors = _inputs(b, s, h, kv, hd, dtype, seed=s)
        q, k, v, do = (a.cuda() for a in tensors)
        scale = 1.0 / np.sqrt(hd)
        out = causal_attention(q, k, v, scale=scale, window=window)
        first = causal_attention_bwd(q, k, v, out, do, scale=scale, window=window)
        second = causal_attention_bwd(q, k, v, out, do, scale=scale, window=window)
        torch.cuda.synchronize()
        for a, b_ in zip(first, second):
            assert torch.equal(a, b_)
