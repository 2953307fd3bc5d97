"""The port's ``models/ssm.py`` against the JAX package's.

Sequential scans are held to each other at 1e-5.  The chunked closed forms
are held to each other at the reference's own mild decays, within 1e-3 as
``tests/test_chunked_recurrences.py`` holds the reference's chunked form to
its scan.  At strong decays the reference's chunked form overflows float32
(it scales by ``exp(-cumsum(log a))``); the port's chunked form is then
held to the reference's sequential scan.  Everything runs on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as ref_ssm
from repro_torch.models import ssm

TOL = 1e-3


def _scan_inputs(b, s, d, n, seed, dt_shift=0.0, with_h0=False):
    """x, B, C, dt (pre-softplus), A, h0 as float32 numpy, the reference's
    test distribution (``TestSSDChunked``) with ``dt`` shifted by
    ``dt_shift``."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, d))
    bt = rng.standard_normal((b, s, n)) * 0.5
    ct = rng.standard_normal((b, s, n)) * 0.5
    dt = rng.standard_normal((b, s, d)) * 0.5 + dt_shift
    a = np.exp(rng.standard_normal(d) * 0.2)
    h0 = rng.standard_normal((b, d, n)) * 0.5 if with_h0 else np.zeros((b, d, n))
    return [v.astype(np.float32) for v in (x, bt, ct, dt, a, h0)]


def _both(fn_ref, fn_port, arrays, **kw):
    want = fn_ref(*map(jnp.asarray, arrays), **kw)
    got = fn_port(*map(torch.from_numpy, arrays), **kw)
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("s", [1, 16, 37])
def test_sequential_scan_matches_the_reference(s, with_h0):
    arrays = _scan_inputs(2, s, 12, 8, seed=s, with_h0=with_h0)
    (y_want, h_want), (y_got, h_got) = _both(ref_ssm.selective_scan, ssm.selective_scan, arrays)
    np.testing.assert_allclose(y_got, y_want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(h_got, h_want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize(
    "s,chunk,with_h0",
    [(16, 8, False), (64, 16, False), (128, 32, False), (16, 8, True), (96, 32, True), (37, 8, False)],
)
def test_chunked_scan_matches_the_reference_chunked_at_mild_decays(s, chunk, with_h0):
    arrays = _scan_inputs(2, s, 12, 8, seed=100 + s, with_h0=with_h0)
    (y_want, h_want), (y_got, h_got) = _both(
        ref_ssm.selective_scan_chunked, ssm.selective_scan_chunked, arrays, chunk=chunk
    )
    np.testing.assert_allclose(y_got, y_want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(h_got, h_want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("with_h0", [False, True])
def test_chunked_scan_stays_finite_and_right_at_strong_decays(with_h0):
    """softplus(dt) about 6 and A about 1: a chunk of 32 sums some 190 of
    log decay, past float32's exp limit (about 88), so the reference's
    chunked form overflows; the port's matches the sequential scan."""
    arrays = _scan_inputs(2, 128, 12, 8, seed=7, dt_shift=6.0, with_h0=with_h0)
    x, bt, ct, dt, a, h0 = arrays
    per_chunk = (np.logaddexp(dt, 0.0) * a).reshape(2, 4, 32, 12).sum(axis=2)
    with np.errstate(over="ignore"):
        assert per_chunk.min() > 100 and np.isinf(np.exp(per_chunk.astype(np.float32))).all()
        y_ref_chunked, _ = ref_ssm.selective_scan_chunked(*map(jnp.asarray, arrays), chunk=32)
    assert not np.isfinite(np.asarray(y_ref_chunked)).all()   # the trap the port avoids

    y_want, h_want = ref_ssm.selective_scan(*map(jnp.asarray, arrays))
    y_got, h_got = ssm.selective_scan_chunked(*map(torch.from_numpy, arrays), chunk=32)
    assert torch.isfinite(y_got).all() and torch.isfinite(h_got).all()
    np.testing.assert_allclose(y_got.numpy(), np.asarray(y_want), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(h_got.numpy(), np.asarray(h_want), rtol=TOL, atol=TOL)


def test_chunked_scan_holds_its_decay_blocks_to_the_budget(monkeypatch):
    """A budget of one chunk's decay tensor takes a block per chunk; the
    result is the one-block result."""
    arrays = [torch.from_numpy(a) for a in _scan_inputs(2, 64, 12, 8, seed=3, with_h0=True)]
    whole = ssm.selective_scan_chunked(*arrays, chunk=8)
    monkeypatch.setattr(ssm, "_DECAY_BLOCK_BYTES", 2 * 8 * 8 * 12 * 4)
    blocked = ssm.selective_scan_chunked(*arrays, chunk=8)
    for a, b in zip(whole, blocked):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def _ssm_params(d_model, d_inner, n, seed=0):
    rng = np.random.default_rng(seed)
    p = {
        "w_in": rng.standard_normal((d_model, d_inner)) / np.sqrt(d_model),
        "w_gate": rng.standard_normal((d_model, d_inner)) / np.sqrt(d_model),
        "w_B": rng.standard_normal((d_model, n)) / np.sqrt(d_model),
        "w_C": rng.standard_normal((d_model, n)) / np.sqrt(d_model),
        "w_dt": rng.standard_normal((d_model, d_inner)) / np.sqrt(d_model),
        "A_log": rng.standard_normal(d_inner) * 0.2,
        "D": 1.0 + 0.1 * rng.standard_normal(d_inner),
        "w_out": rng.standard_normal((d_inner, d_model)) / np.sqrt(d_inner),
    }
    return {k: v.astype(np.float32) for k, v in p.items()}


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssm_forward_matches_the_reference(chunked, with_h0):
    p = _ssm_params(32, 48, 8)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 64, 32)).astype(np.float32)
    h0 = (rng.standard_normal((2, 48, 8)) * 0.5).astype(np.float32) if with_h0 else None
    y_want, h_want = ref_ssm.ssm_forward(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()},
        None if h0 is None else jnp.asarray(h0), chunked=chunked,
    )
    y_got, h_got = ssm.ssm_forward(
        torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in p.items()},
        None if h0 is None else torch.from_numpy(h0), chunked=chunked,
    )
    tol = TOL if chunked else 1e-5
    np.testing.assert_allclose(y_got.numpy(), np.asarray(y_want), rtol=tol, atol=tol)
    np.testing.assert_allclose(h_got.numpy(), np.asarray(h_want), rtol=tol, atol=tol)


def test_init_state_and_param_count():
    p = ssm.ssm_init(torch.Generator().manual_seed(0), 32, 48, 8, torch.bfloat16, device="cpu")
    ref = ref_ssm.ssm_init(jax.random.PRNGKey(0), 32, 48, 8, jnp.bfloat16)
    for name, leaf in ref.items():
        assert tuple(p[name].shape) == leaf.shape and str(p[name].dtype)[6:] == str(leaf.dtype)
    assert torch.equal(p["A_log"], torch.zeros(48)) and torch.equal(p["D"], torch.ones(48))
    assert sum(t.numel() for t in p.values()) == ssm.ssm_param_count(32, 48, 8) == ref_ssm.ssm_param_count(32, 48, 8)
    state = ssm.ssm_state_init(2, 48, 8, device="cpu")
    assert state.shape == ref_ssm.ssm_state_init(2, 48, 8).shape and state.dtype == torch.float32


def test_entry_points_default_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ssm.ssm_init(torch.Generator(), 32, 48, 8, torch.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ssm.ssm_state_init(1, 48, 8)
