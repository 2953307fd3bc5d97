"""The port's ``causal_attention`` against the JAX package's
``ops.causal_attention`` and ``ref.attention_ref``.

On CPU tensors the port's wrapper computes its plain version; the JAX side
runs the Pallas kernel in interpret mode, as ``tests/test_kernels.py`` runs
it.  The hand-written CUDA kernel itself is held against the plain version
by the test here that needs a card (skipped without one) and by
``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels.flash_attention import causal_attention, causal_attention_plain

TOL = {"float32": 5e-4, "bfloat16": 3e-2}   # tests/test_kernels.py::TestFlashAttention


def _inputs(b, s, h, kv, hd, dtype, seed=0):
    """The same seeded numpy q, k, v as a (jax, torch) pair of ``dtype``."""
    rng = np.random.default_rng(seed)
    arrays = [
        rng.standard_normal(shape, dtype=np.float32)
        for shape in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd))
    ]
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    return (
        tuple(jnp.asarray(a).astype(jdt) for a in arrays),
        tuple(torch.from_numpy(a).to(tdt) for a in arrays),
    )


def _attention_ref(q, k, v, scale, window):
    """``ref.attention_ref`` over the natural layout, KV heads repeated (as
    ``tests/test_kernels.py::_attn_expect``)."""
    b, s, h, hd = q.shape
    rep = h // k.shape[2]
    k, v = jnp.repeat(k, rep, axis=2), jnp.repeat(v, rep, axis=2)

    def flat(a):
        return a.transpose(0, 2, 1, 3).reshape(b * h, s, hd)

    out = ref.attention_ref(flat(q), flat(k), flat(v), scale=scale, window=window)
    return out.reshape(b, h, s, hd).transpose(0, 2, 1, 3)


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 64, 17])
def test_causal_and_window_match_the_pallas_kernel_and_its_oracle(window, dtype):
    (jq, jk, jv), (tq, tk, tv) = _inputs(2, 128, 4, 2, 32, dtype)
    scale = 1.0 / np.sqrt(32)
    got = _f32(causal_attention(tq, tk, tv, scale=scale, window=window))
    pallas = _f32(ops.causal_attention(jq, jk, jv, scale=scale, window=window, block_q=32, block_k=32))
    oracle = _f32(_attention_ref(jq, jk, jv, scale, window))
    tol = TOL[dtype]
    np.testing.assert_allclose(got, pallas, rtol=tol, atol=tol)
    np.testing.assert_allclose(got, oracle, rtol=tol, atol=tol)


@pytest.mark.parametrize(
    "b,s,h,kv,hd,window",
    [
        (1, 64, 4, 1, 256, 16),   # GQA rep 4 at gemma3's head_dim, windowed
        (1, 37, 4, 2, 32, 0),     # ragged S, global
        (2, 37, 2, 1, 64, 5),     # ragged S, windowed
        (1, 1, 2, 2, 16, 0),      # one token
    ],
)
def test_gqa_head_dims_and_ragged_lengths(b, s, h, kv, hd, window):
    (jq, jk, jv), (tq, tk, tv) = _inputs(b, s, h, kv, hd, "float32", seed=s)
    scale = 1.0 / np.sqrt(hd)
    got = _f32(causal_attention(tq, tk, tv, scale=scale, window=window))
    np.testing.assert_allclose(got, _f32(_attention_ref(jq, jk, jv, scale, window)), rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(
        got, _f32(ops.causal_attention(jq, jk, jv, scale=scale, window=window)), rtol=5e-4, atol=5e-4
    )


def test_first_token_attends_to_itself_only():
    _, (tq, tk, tv) = _inputs(1, 64, 2, 2, 16, "float32", seed=20)
    out = causal_attention(tq, tk, tv, scale=0.25, window=0)
    np.testing.assert_allclose(out[:, 0].numpy(), tv[:, 0].numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize(
    "q,k,v,error",
    [
        (torch.ones(1, 4, 2, 16), torch.ones(1, 4, 3, 16), torch.ones(1, 4, 3, 16), ValueError),
        (torch.ones(4, 2, 16), torch.ones(4, 2, 16), torch.ones(4, 2, 16), ValueError),
        (torch.ones(1, 4, 2, 16), torch.ones(1, 5, 2, 16), torch.ones(1, 5, 2, 16), ValueError),
        (torch.ones(1, 4, 2, 16), torch.ones(1, 4, 2, 16).bfloat16(), torch.ones(1, 4, 2, 16), TypeError),
        (torch.ones(1, 4, 2, 16).double(),) * 3 + (TypeError,),
        (torch.ones(1, 4, 2, 16), torch.ones(1, 4, 2, 16, device="meta"), torch.ones(1, 4, 2, 16), ValueError),
    ],
    ids=["kv-heads", "rank", "lengths", "mixed-dtype", "float64", "devices"],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(q, k, v, error):
    with pytest.raises(error):
        causal_attention(q, k, v, scale=0.25)


def test_library_path_is_under_the_checkout_build_dir():
    path = fa_mod.build.library_path("flash_attention")
    assert path.parent.parts[-2:] == ("build", "repro_torch")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain_version(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    shapes = [
        (2, 128, 4, 2, 32, 0), (2, 128, 4, 2, 32, 64), (2, 128, 4, 2, 32, 17),
        (1, 64, 4, 1, 256, 16), (1, 37, 4, 2, 32, 0), (2, 37, 2, 1, 64, 5),
        (1, 1, 2, 2, 16, 0), (1, 100, 2, 1, 128, 0), (2, 600, 4, 1, 256, 512),
    ]
    for b, s, h, kv, hd, window in shapes:
        _, (tq, tk, tv) = _inputs(b, s, h, kv, hd, dtype, seed=s)
        tq, tk, tv = tq.cuda(), tk.cuda(), tv.cuda()
        before = causal_attention.launches
        got = causal_attention(tq, tk, tv, scale=hd**-0.5, window=window)
        torch.cuda.synchronize()
        assert causal_attention.launches == before + 1
        want = causal_attention_plain(tq, tk, tv, scale=hd**-0.5, window=window)
        torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype], atol=TOL[dtype])
