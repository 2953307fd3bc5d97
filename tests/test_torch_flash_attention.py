"""The port's ``causal_attention`` against the JAX package's
``ops.causal_attention`` and ``ref.attention_ref``.

On CPU tensors the port's wrapper computes its plain version; the JAX side
runs the Pallas kernel in interpret mode, as ``tests/test_kernels.py`` runs
it.  The hand-written CUDA kernel itself is held against the plain version
by the test here that needs a card (skipped without one) and by
``chip_smoke.py``.
"""
import re

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
        (2, 48, 4, 4, 96, 0),     # phi-3-vision's head_dim, global
        (1, 37, 4, 2, 96, 16),    # head_dim 96, GQA, ragged S, windowed
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


@pytest.mark.parametrize("head_dim", fa_mod.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_route_puts_bf16_at_64_128_256_on_the_tensor_cores(dtype, head_dim):
    want = "tensor-core" if dtype == torch.bfloat16 and head_dim in (64, 128, 256) else "cuda-core"
    assert fa_mod.route(dtype, head_dim) == want


def test_head_dims_mirror_the_c_dispatch():
    """``HEAD_DIMS`` are the cases of both of ``flash_attention.cu``'s
    switches: the float32 ``dispatch`` and the bfloat16 one, where 96 goes
    to the CUDA-core ``launch``."""
    src = (fa_mod.build.CSRC_DIR / "flash_attention.cu").read_text()
    dispatch = src[src.index("int dispatch("):]
    dispatch = dispatch[: dispatch.index("default:")]
    entry = src[src.index('extern "C" int flash_attention('):]
    bf16_switch = entry[entry.index("switch (hd)"):]
    assert tuple(int(d) for d in re.findall(r"case (\d+): return launch<T, \1>", dispatch)) == fa_mod.HEAD_DIMS
    assert tuple(int(d) for d in re.findall(r"case (\d+):", bf16_switch)) == fa_mod.HEAD_DIMS
    assert "case 96: return launch<__nv_bfloat16, 96>" in bf16_switch


def test_route_mirrors_the_c_dispatch():
    """The head dims that ``flash_attention.cu``'s bfloat16 switch sends to
    ``tc::launch`` are ``TENSOR_CORE_HEAD_DIMS``; float32 never goes there."""
    src = (fa_mod.build.CSRC_DIR / "flash_attention.cu").read_text()
    entry = src[src.index('extern "C" int flash_attention('):]
    bf16_switch = entry[entry.index("switch (hd)"):]
    tc_dims = tuple(int(d) for d in re.findall(r"case (\d+): return tc::launch<\1>", bf16_switch))
    assert tc_dims == fa_mod.TENSOR_CORE_HEAD_DIMS
    assert "if (!is_bf16) return dispatch<float>" in entry


def _misaligned(shape, dtype):
    """A contiguous view whose data starts one element past an aligned base."""
    n = int(np.prod(shape))
    return torch.zeros(n + 1, dtype=dtype)[1:].view(shape)


@pytest.mark.parametrize("which", ["q", "k", "v"])
def test_alignment_check_rejects_a_misaligned_view_on_the_tensor_core_route(which):
    tensors = {name: torch.zeros(1, 4, 2, 64, dtype=torch.bfloat16) for name in "qkv"}
    tensors[which] = _misaligned((1, 4, 2, 64), torch.bfloat16)
    assert tensors[which].is_contiguous() and tensors[which].data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte-aligned"):
        fa_mod.check_alignment("tensor-core", *tensors.values())
    fa_mod.check_alignment("cuda-core", *tensors.values())   # reads element by element


def test_alignment_check_takes_aligned_tensors():
    q = torch.zeros(1, 4, 2, 64, dtype=torch.bfloat16)
    assert q.data_ptr() % 16 == 0
    fa_mod.check_alignment("tensor-core", q, q, q)


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
    # The tensor-core route's head dims (bfloat16), global and windowed, at
    # one token, a ragged tile and a ragged length past several tiles.
    shapes += [
        (1, s, 4, kv, hd, window)
        for hd, kv in ((64, 4), (128, 2), (256, 1))
        for s in (1, 33, 2047)
        for window in (0, 512)
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain_version_at_head_dim_96(dtype):
    """phi-3-vision's head_dim on the CUDA-core route: its path shape's
    heads, global and windowed, at one token, a ragged tile and a length
    past several tiles."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    assert fa_mod.route(getattr(torch, dtype), 96) == "cuda-core"
    for b, s, h, kv, window in [(1, 1, 32, 32, 0), (2, 33, 4, 2, 0), (1, 700, 32, 32, 0), (2, 300, 8, 8, 64)]:
        _, (tq, tk, tv) = _inputs(b, s, h, kv, 96, dtype, seed=s)
        tq, tk, tv = tq.cuda(), tk.cuda(), tv.cuda()
        before = causal_attention.launches
        got = causal_attention(tq, tk, tv, scale=96**-0.5, window=window)
        torch.cuda.synchronize()
        assert causal_attention.launches == before + 1
        want = causal_attention_plain(tq, tk, tv, scale=96**-0.5, window=window)
        torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype], atol=TOL[dtype])
