"""The port's ``wkv6`` against the JAX package's ``ops.wkv6``,
``ref.wkv6_ref`` and ``models.rwkv.wkv_scan``.

On CPU tensors the port's wrapper computes its plain version (the
step-by-step recurrence); the JAX side runs the Pallas kernel in interpret
mode, as ``tests/test_kernels.py`` runs it.  The hand-written CUDA kernels
themselves are held against the plain version by the test here that needs a
card (skipped without one) and by ``chip_smoke.py``.

``wkv6_chunk_model`` below is a float32 model of the chunk kernel's schedule
(``csrc/wkv6.cu``, ``tc::chunk_kernel``): chunks of 64 tokens, sub-blocks of
16 and groups of 4, every decay a factor 2^x with x a sum of log2 w between
an earlier and a later position, running products of w inside a group, the
state carried across chunks, a ragged last chunk, and each tensor-core
product on TF32 operands split into high and low parts (v too, as the
float32 route splits it; bfloat16 v has a zero low part, so the same model
holds the bfloat16 route's two products).  It is test code,
not a second plain version: it shows on the CPU that the algorithm meets
the tolerance at decays where the Pallas kernel's closed form overflows.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro.models.rwkv import wkv_scan as ref_wkv_scan
from repro_torch import tracing
from repro_torch.kernels import wkv6 as wkv6_mod
from repro_torch.kernels.wkv6 import wkv6, wkv6_plain


def _inputs(b, t, h, hd, seed, w_lo=0.69, w_span=0.3):
    """Seeded numpy r, k, v, decays w in (w_lo, w_lo + w_span), bonus u, as
    in ``tests/test_kernels.py::TestWKV6``."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, t, h, hd), dtype=np.float32) for _ in range(3))
    z = rng.standard_normal((b, t, h, hd)).astype(np.float32)
    w = (1.0 / (1.0 + np.exp(-z)) * w_span + w_lo).astype(np.float32)
    u = (rng.standard_normal((h, hd)) * 0.1).astype(np.float32)
    return r, k, v, w, u


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _jax(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _wkv6_ref(r, k, v, w, u):
    """``ref.wkv6_ref`` over the natural layout (as
    ``tests/test_kernels.py::_wkv_expect``)."""
    b, t, h, hd = r.shape

    def flat(a):
        return a.transpose(0, 2, 1, 3).reshape(b * h, t, hd)

    uf = jnp.broadcast_to(u[None], (b, h, hd)).reshape(b * h, 1, hd)
    out = ref.wkv6_ref(flat(r), flat(k), flat(v), flat(w), uf)
    return out.reshape(b, h, t, hd).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("chunk", [8, 16, 32, 64])
def test_matches_the_pallas_kernel_at_every_chunk(chunk):
    arrays = _inputs(1, 64, 2, 16, seed=0)
    out, _ = wkv6(*_torch(*arrays))
    np.testing.assert_allclose(out.numpy(), np.asarray(ops.wkv6(*_jax(*arrays), chunk=chunk)), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(out.numpy(), np.asarray(_wkv6_ref(*_jax(*arrays))), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize(
    "t,h,hd,w_lo,seed",
    [(16, 1, 8, 0.55, 0), (32, 2, 16, 0.7, 1), (128, 4, 32, 0.9, 2), (64, 2, 8, 0.6, 3)],
)
def test_property_sweep_shapes(t, h, hd, w_lo, seed):
    arrays = _inputs(1, t, h, hd, seed=seed, w_lo=w_lo, w_span=0.98 - w_lo)
    out, _ = wkv6(*_torch(*arrays))
    np.testing.assert_allclose(out.numpy(), np.asarray(ops.wkv6(*_jax(*arrays), chunk=16)), rtol=3e-3, atol=3e-3)


@pytest.mark.parametrize("from_zero", [True, False])
def test_output_and_final_state_match_the_model_recurrence(from_zero):
    b, t, h, hd = 2, 32, 2, 8
    r, k, v, w, u = _inputs(b, t, h, hd, seed=9)
    rng = np.random.default_rng(10)
    s0 = np.zeros((b, h, hd, hd), np.float32) if from_zero else rng.standard_normal((b, h, hd, hd), dtype=np.float32)
    want_out, want_state = ref_wkv_scan(*_jax(r, k, v, w, u, s0))
    out, state = wkv6(*_torch(r, k, v, w, u), None if from_zero else torch.from_numpy(s0))
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(state.numpy(), np.asarray(want_state), rtol=2e-3, atol=2e-3)
    assert out.dtype == state.dtype == torch.float32


def test_decay_near_one_isolates_the_first_token():
    """With w ~ 1 and k = 0 except at t0, out_t = (r_t . k0) v0 w^t."""
    b, t, h, hd = 1, 16, 1, 8
    r = np.random.default_rng(30).standard_normal((b, t, h, hd), dtype=np.float32)
    k = np.zeros((b, t, h, hd), np.float32)
    k[:, 0] = 1.0
    v = np.zeros((b, t, h, hd), np.float32)
    v[:, 0] = 2.0
    w = np.full((b, t, h, hd), 0.9999, np.float32)
    u = np.zeros((h, hd), np.float32)
    out, _ = wkv6(*_torch(r, k, v, w, u))
    for step in range(1, t):
        expect = float(r[0, step, 0].sum()) * 2.0 * (0.9999**step)
        np.testing.assert_allclose(out[0, step, 0].numpy(), expect, rtol=2e-2)


@pytest.mark.parametrize(
    "shapes,error",
    [
        (((1, 4, 2, 8),) * 3 + ((1, 5, 2, 8),) + ((2, 8),), ValueError),
        (((1, 4, 2, 8),) * 4 + ((2, 4),), ValueError),
        (((4, 2, 8),) * 4 + ((2, 8),), ValueError),
    ],
    ids=["w-shape", "u-shape", "rank"],
)
def test_wrapper_rejects_bad_shapes(shapes, error):
    with pytest.raises(error):
        wkv6(*(torch.ones(s) for s in shapes))


def test_wrapper_rejects_bad_dtypes_and_state():
    r = torch.ones(1, 4, 2, 8)
    u = torch.ones(2, 8)
    with pytest.raises(TypeError):
        wkv6(r.double(), r.double(), r.double(), r, u)
    with pytest.raises(ValueError):
        wkv6(r, r, r, r, u, torch.zeros(1, 2, 8, 4))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain_version(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    shapes = [(1, 64, 2, 16), (2, 32, 2, 8), (1, 37, 3, 32), (2, 100, 4, 64), (1, 1, 2, 64)]
    for b, t, h, hd in shapes:
        r, k, v, w, u = (a.cuda() for a in _torch(*_inputs(b, t, h, hd, seed=t)))
        r, k, v = (a.to(getattr(torch, dtype)) for a in (r, k, v))
        for state in (None, torch.randn(b, h, hd, hd, device="cuda")):
            before = tracing.counter("launches.wkv6")
            out, final = wkv6(r, k, v, w, u, state)
            torch.cuda.synchronize()
            assert tracing.counter("launches.wkv6") == before + 1
            want_out, want_final = wkv6_plain(r, k, v, w, u, state)
            torch.testing.assert_close(out, want_out, rtol=2e-3, atol=2e-3)
            torch.testing.assert_close(final, want_final, rtol=2e-3, atol=2e-3)
    # The chunk route (hd 64, both types) at strong decays (|log w| up to
    # 20, w = 0, w = 1 - 1e-4), at ragged lengths and at rwkv6-7b's prefill
    # and train shape.
    for b, t, h, hd in [(1, 1, 2, 64), (1, 37, 3, 64), (2, 100, 4, 64), (2, 2048, 64, 64)]:
        for with_state in (False, True):
            r, k, v, w, u, s0 = _model_inputs(b, t, h, hd, "strong", seed=t, with_state=with_state)
            args = [a.cuda() for a in _torch(r, k, v, w, u)]
            args[:3] = [a.to(getattr(torch, dtype)) for a in args[:3]]
            state = None if s0 is None else torch.from_numpy(s0).cuda()
            assert wkv6_mod.route(args[0].dtype, hd) == "chunk"
            out, final = wkv6(*args, state)
            torch.cuda.synchronize()
            want_out, want_final = wkv6_plain(*args, state)
            assert torch.isfinite(out).all() and torch.isfinite(final).all()
            torch.testing.assert_close(out, want_out, rtol=2e-3, atol=2e-3)
            torch.testing.assert_close(final, want_final, rtol=2e-3, atol=2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_backward_kernel_matches_autograd_of_plain_version(dtype):
    """The gradient through ``_WKV6`` on the card (the ``wkv6_bwd``
    kernels) against autograd of ``wkv6_plain`` on the same inputs, per row
    (float32: 1e-4; bfloat16 gradients: 3e-2), at mild and strong decays,
    ragged lengths, every head_dim, from a state and with a final-state
    gradient; a second backward call is bitwise equal to the first."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    tdt = getattr(torch, dtype)
    tol = 1e-4 if dtype == "float32" else 3e-2
    for b, t, h, hd in [(1, 1, 2, 8), (1, 37, 3, 16), (2, 100, 4, 32), (2, 130, 2, 64), (2, 2048, 64, 64)]:
        for kind in ("mild", "strong"):
            r, k, v, w, u, s0 = _model_inputs(b, t, h, hd, kind, seed=t, with_state=True)
            g = torch.Generator().manual_seed(t)
            dout, dfinal = torch.randn(b, t, h, hd, generator=g).cuda(), torch.randn(b, h, hd, hd, generator=g).cuda()
            grads = []
            for fn in (wkv6, wkv6_plain):
                leaves = [a.cuda().to(tdt if i < 3 else torch.float32).requires_grad_(True)
                          for i, a in enumerate(_torch(r, k, v, w, u, s0))]
                before = tracing.counter("launches.wkv6_bwd")
                out, final = fn(*leaves)
                grads.append(torch.autograd.grad((out * dout).sum() + (final * dfinal).sum(), leaves))
                torch.cuda.synchronize()
                assert tracing.counter("launches.wkv6_bwd") == before + (fn is wkv6)
            want = grads[1]
            sq = torch.cat([x.float().reshape(-1, hd).norm(dim=-1).square() for x in want[:4]])
            floor = float(0.1 * sq.mean().sqrt())
            for got_g, want_g in zip(grads[0], want):
                assert got_g.dtype == want_g.dtype and bool(torch.isfinite(got_g).all())
                diff = (got_g.float() - want_g.float()).reshape(-1, hd).norm(dim=-1)
                norm = want_g.float().reshape(-1, hd).norm(dim=-1).clamp_min(floor)
                assert float((diff / norm).max()) <= tol, ((b, t, h, hd), kind)
            args = [a.cuda() for a in _torch(r, k, v, w, u, s0)]
            args[:3] = [a.to(tdt) for a in args[:3]]
            once = wkv6_mod.wkv6_bwd(*args, dout, dfinal)
            again = wkv6_mod.wkv6_bwd(*args, dout, dfinal)
            assert all(torch.equal(x, y) for x, y in zip(once, again))


# --------------------------------------------------------------------------
# A CPU model of the chunk kernel's schedule
# --------------------------------------------------------------------------
CHUNK, SUB, GRP = 64, 16, 4
NSUB = CHUNK // SUB
LOG2_FLOOR = -100.0
_TF32_MASK = -8192   # 0xFFFFE000: sign, exponent and 10 mantissa bits


def _tf32_split(x):
    """x as a high TF32 part (truncated) and the rest, itself cut to TF32."""
    x = x.contiguous()
    hi = (x.view(torch.int32) & _TF32_MASK).view(torch.float32)
    lo = (x - hi).contiguous()
    return hi, (lo.view(torch.int32) & _TF32_MASK).view(torch.float32)


SPLIT = True   # False: one TF32 pass per product (the design the kernel rejects)


def _mm3(a, b):
    """a @ b with both operands split: hi*hi + (lo*hi + hi*lo).  Where ``b``
    is exact in TF32 (bfloat16 v) its low part is 0 and this is the
    bfloat16 route's hi*b + lo*b."""
    ah, al = _tf32_split(a)
    bh, bl = _tf32_split(b)
    return ah @ bh + (al @ bh + ah @ bl) if SPLIT else ah @ bh


def wkv6_chunk_model(r, k, v, w, u, state=None):
    """The chunk kernel's algorithm in float32 torch, on the CPU."""
    b, t_len, h, d = r.shape
    r, k, v, w = (a.float().permute(0, 2, 1, 3) for a in (r, k, v, w))   # (B, H, T, D)
    s = torch.zeros(b, h, d, d) if state is None else state.float().clone()
    uu = u.float()[None]                                                  # (1, H, D)
    zero = torch.zeros(b, h, d)
    outs = []
    for c0 in range(0, t_len, CHUNK):
        n = min(CHUNK, t_len - c0)

        def rows(a):   # the chunk's rows; rows past T are zeros, as the copies leave them
            return torch.cat([a[:, :, c0:c0 + n], a.new_zeros(b, h, CHUNK - n, d)], 2)

        rc, kc, vc, wc = (rows(a) for a in (r, k, v, w))
        lw = torch.clamp(torch.log2(wc), min=LOG2_FLOOR)
        lw[:, :, n:] = 0.0                                                # w = 1 past T
        rh, rg, kh, kg = (torch.empty_like(rc) for _ in range(4))
        tot = torch.empty(b, h, NSUB, d)
        grp_tot = torch.empty(b, h, NSUB, SUB // GRP, d)
        for i in range(NSUB):
            acc = grp = zero
            for q in range(SUB):   # forward: R^ over the sub-block, R' over the group
                t = i * SUB + q
                rh[:, :, t] = rc[:, :, t] * torch.exp2(acc)
                rg[:, :, t] = rc[:, :, t] * torch.exp2(grp)
                acc, grp = acc + lw[:, :, t], grp + lw[:, :, t]
                if q % GRP == GRP - 1:
                    grp_tot[:, :, i, q // GRP], grp = grp, zero
            tot[:, :, i] = acc
            acc = grp = zero
            for q in reversed(range(SUB)):   # backward: K^ and K'
                t = i * SUB + q
                kh[:, :, t] = kc[:, :, t] * torch.exp2(acc)
                kg[:, :, t] = kc[:, :, t] * torch.exp2(grp)
                acc = acc + lw[:, :, t]
                grp = zero if q % GRP == 0 else grp + lw[:, :, t]
        f = torch.ones(b, h, NSUB + 1, NSUB + 1, d)   # F[i][j] = 2^(T_j + ... + T_{i-1})
        for i in range(NSUB):
            acc = zero
            for j in range(i, -1, -1):
                acc = acc + tot[:, :, j]
                f[:, :, i + 1, j] = torch.exp2(acc)

        a_mat = torch.zeros(b, h, CHUNK, CHUNK)
        for g0 in range(0, CHUNK, GRP):   # inside a group: running products, bonus on the diagonal
            for t in range(g0, g0 + GRP):
                a_mat[:, :, t, t] = (rc[:, :, t] * uu * kc[:, :, t]).sum(-1)
                q = rc[:, :, t]
                for s_ in range(t - 1, g0 - 1, -1):
                    a_mat[:, :, t, s_] = (q * kc[:, :, s_]).sum(-1)
                    q = q * wc[:, :, s_]
        for i in range(NSUB):   # between groups of a sub-block: (R' G) K'^T
            for bg in range(SUB // GRP - 1):
                keys = slice(i * SUB + bg * GRP, i * SUB + (bg + 1) * GRP)
                for ag in range(bg + 1, SUB // GRP):
                    qs = slice(i * SUB + ag * GRP, i * SUB + (ag + 1) * GRP)
                    g_fac = torch.exp2(grp_tot[:, :, i, bg + 1:ag].sum(2))[:, :, None]
                    a_mat[:, :, qs, keys] = _mm3(rg[:, :, qs] * g_fac, kg[:, :, keys].transpose(-1, -2))
        for i in range(1, NSUB):   # between sub-blocks: (R^ F) K^^T
            for j in range(i):
                qs, keys = slice(i * SUB, (i + 1) * SUB), slice(j * SUB, (j + 1) * SUB)
                a_mat[:, :, qs, keys] = _mm3(rh[:, :, qs] * f[:, :, i, j + 1][:, :, None], kh[:, :, keys].transpose(-1, -2))

        f_out = f[:, :, torch.arange(NSUB), 0].repeat_interleave(SUB, dim=2)      # F[i(t)][0]
        f_state = f[:, :, NSUB, 1:].repeat_interleave(SUB, dim=2)                  # F[4][j(s)+1]
        out = _mm3(rh * f_out, s) + _mm3(a_mat, vc)
        s = f[:, :, NSUB, 0][..., None] * s + _mm3((kh * f_state).transpose(-1, -2), vc)
        outs.append(out[:, :, :n])
    return torch.cat(outs, 2).permute(0, 2, 1, 3), s


def _bf16(a):
    """Values exact in bfloat16 (the chunk kernel's r, k, v)."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _decays(kind, shape, rng):
    """Decays w (float32) of one regime.  ``mild``: RWKV6's initial
    exp(-exp(-2 + noise)), |log w| about 0.14; ``strong``: exp(-exp(x)) with
    |log w| up to 20, a stretch of w = 0 and a stretch of w = 1 - 1e-4."""
    if kind == "mild":
        return np.exp(-np.exp(-2.0 + 0.5 * rng.standard_normal(shape))).astype(np.float32)
    w = np.exp(-np.exp(rng.uniform(-6.0, np.log(20.0), shape))).astype(np.float32)
    t = shape[1]
    w[:, t // 4:t // 4 + 20] = 0.0
    w[:, t // 2:t // 2 + 70] = np.float32(1.0 - 1e-4)
    return w


def _model_inputs(b, t, h, hd, kind, seed, with_state, rkv="bfloat16"):
    """r, k, v as the ``rkv`` route gets them: values exact in bfloat16, or
    float32 values that are not (neither they nor v exact in TF32)."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, t, h, hd), dtype=np.float32) for _ in range(3))
    if rkv == "bfloat16":
        r, k, v = (_bf16(a) for a in (r, k, v))
    w = _decays(kind, (b, t, h, hd), rng)
    u = (rng.standard_normal((h, hd)) * 0.1).astype(np.float32)
    s0 = rng.standard_normal((b, h, hd, hd), dtype=np.float32) if with_state else None
    return r, k, v, w, u, s0


@pytest.mark.parametrize("rkv", ["bfloat16", "float32"])
@pytest.mark.parametrize("with_state", [False, True], ids=["zero-state", "random-state"])
@pytest.mark.parametrize("kind", ["mild", "strong"])
@pytest.mark.parametrize("b,t,h,hd", [(1, 200, 2, 16), (2, 130, 2, 32)])
def test_chunk_model_matches_the_plain_recurrence(b, t, h, hd, kind, with_state, rkv):
    """At mild and at strong decays (|log w| up to 20, w = 0, w = 1 - 1e-4),
    from zero and from a random state, over a ragged last chunk, for r, k, v
    exact in bfloat16 and in float32: finite, and within 2e-3 of the
    step-by-step recurrence."""
    r, k, v, w, u, s0 = _model_inputs(b, t, h, hd, kind, seed=t + hd, with_state=with_state, rkv=rkv)
    args = _torch(r, k, v, w, u) + [None if s0 is None else torch.from_numpy(s0)]
    out, state = wkv6_chunk_model(*args)
    want_out, want_state = wkv6_plain(*args)
    assert torch.isfinite(out).all() and torch.isfinite(state).all()
    torch.testing.assert_close(out, want_out, rtol=2e-3, atol=2e-3)
    torch.testing.assert_close(state, want_state, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("rkv", ["bfloat16", "float32"])
@pytest.mark.parametrize("t", [64, 128])
def test_chunk_model_matches_the_pallas_kernel_at_mild_decays(t, rkv):
    """At mild decays, where the Pallas kernel's closed form is in range,
    the model agrees with ``ops.wkv6`` and ``ref.wkv6_ref`` too."""
    r, k, v, w, u, _ = _model_inputs(1, t, 2, 16, "mild", seed=t, with_state=False, rkv=rkv)
    out, _ = wkv6_chunk_model(*_torch(r, k, v, w, u))
    np.testing.assert_allclose(out.numpy(), np.asarray(ops.wkv6(*_jax(r, k, v, w, u), chunk=16)), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(out.numpy(), np.asarray(_wkv6_ref(*_jax(r, k, v, w, u))), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("head_dim", wkv6_mod.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_route_puts_bf16_at_64_on_the_chunk_kernel(dtype, head_dim):
    """Head_dim 64 takes the chunk kernel whatever r, k, v's type; the
    token kernel keeps 8, 16 and 32."""
    want = "chunk" if head_dim == 64 else "token"
    assert wkv6_mod.route(dtype, head_dim) == want


def test_route_takes_only_the_kernels_types():
    with pytest.raises(TypeError):
        wkv6_mod.route(torch.float64, 64)


def test_route_mirrors_the_c_dispatch():
    """The head dims that ``wkv6.cu``'s entry sends to ``tc::launch`` are
    ``CHUNK_HEAD_DIMS``, for bfloat16 and for float32 r, k, v."""
    src = (wkv6_mod.build.CSRC_DIR / "wkv6.cu").read_text()
    entry = src[src.index('extern "C" int wkv6('):]
    chunk_dims = tuple(int(d) for d in re.findall(r"if \(hd == (\d+)\)", entry))
    assert chunk_dims == wkv6_mod.CHUNK_HEAD_DIMS
    block = entry[entry.index("if (hd =="):]
    block = block[:block.index("}")]
    assert block.count("tc::launch<__nv_bfloat16>") == block.count("tc::launch<float>") == 1


def test_token_kernel_takes_only_the_small_head_dims():
    """The token kernel's switch instantiates hd 8, 16 and 32 alone: no
    call at ``CHUNK_HEAD_DIMS`` can reach it, in either type."""
    src = (wkv6_mod.build.CSRC_DIR / "wkv6.cu").read_text()
    switch = src[src.index("int dispatch("):src.index("namespace tc {")]
    token_dims = tuple(int(d) for d in re.findall(r"case (\d+): return launch<TR, TW, \1>", switch))
    assert token_dims == tuple(d for d in wkv6_mod.HEAD_DIMS if d not in wkv6_mod.CHUNK_HEAD_DIMS) == (8, 16, 32)


def _misaligned(shape, dtype):
    """A contiguous view whose data starts one element past an aligned base."""
    n = int(np.prod(shape))
    return torch.zeros(n + 1, dtype=dtype)[1:].view(shape)


@pytest.mark.parametrize("rkv", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("which", ["r", "k", "v", "w"])
def test_alignment_check_rejects_a_misaligned_view_on_the_chunk_route(which, rkv):
    assert wkv6_mod.route(rkv, 64) == "chunk"
    tensors = {name: torch.zeros(1, 4, 2, 64, dtype=rkv) for name in "rkv"}
    tensors["w"] = torch.zeros(1, 4, 2, 64)
    dtype = torch.float32 if which == "w" else rkv
    tensors[which] = _misaligned((1, 4, 2, 64), dtype)
    assert tensors[which].is_contiguous() and tensors[which].data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte-aligned"):
        wkv6_mod.check_alignment("chunk", *tensors.values())
    wkv6_mod.check_alignment("token", *tensors.values())   # reads element by element


def test_alignment_check_takes_aligned_tensors():
    r = torch.zeros(1, 4, 2, 64, dtype=torch.bfloat16)
    assert r.data_ptr() % 16 == 0
    wkv6_mod.check_alignment("chunk", r, r, r, torch.zeros(1, 4, 2, 64))


if __name__ == "__main__":
    # The model against the plain recurrence at rwkv6-7b's prefill and train
    # shape (B 2, T 2048, H 64, hd 64), r, k, v exact in bfloat16 and in
    # float32, with split operands and with one TF32 pass per product: the
    # largest absolute error, and how far it passes 2e-3 + 2e-3 |want|
    # (negative: within the tolerance).
    for rkv in ("bfloat16", "float32"):
        for kind in ("mild", "strong"):
            r, k, v, w, u, s0 = _model_inputs(2, 2048, 64, 64, kind, seed=0, with_state=True, rkv=rkv)
            args = _torch(r, k, v, w, u) + [torch.from_numpy(s0)]
            want, _ = wkv6_plain(*args)
            for SPLIT in (True, False):
                out, _ = wkv6_chunk_model(*args)
                err = (out - want).abs()
                excess = float((err - 2e-3 - 2e-3 * want.abs()).max())
                print(f"{rkv} r, k, v, {kind} decays, {'split' if SPLIT else 'one TF32 pass'}: "
                      f"max_abs_err={float(err.max()):.3e} excess over the tolerance {excess:.3e}, "
                      f"finite={bool(torch.isfinite(out).all())}")
