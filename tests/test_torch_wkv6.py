"""The port's ``wkv6`` against the JAX package's ``ops.wkv6``,
``ref.wkv6_ref`` and ``models.rwkv.wkv_scan``.

On CPU tensors the port's wrapper computes its plain version (the
step-by-step recurrence); the JAX side runs the Pallas kernel in interpret
mode, as ``tests/test_kernels.py`` runs it.  The hand-written CUDA kernel
itself is held against the plain version by the test here that needs a card
(skipped without one) and by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro.models.rwkv import wkv_scan as ref_wkv_scan
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
            before = wkv6.launches
            out, final = wkv6(r, k, v, w, u, state)
            torch.cuda.synchronize()
            assert wkv6.launches == before + 1
            want_out, want_final = wkv6_plain(r, k, v, w, u, state)
            torch.testing.assert_close(out, want_out, rtol=2e-3, atol=2e-3)
            torch.testing.assert_close(final, want_final, rtol=2e-3, atol=2e-3)
