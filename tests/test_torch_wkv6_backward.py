"""The gradient of the port's ``wkv6`` against autograd and the JAX package.

``wkv6_bwd_plain`` (the plain version of the ``wkv6_bwd`` kernels) is held
against ``jax.grad`` of the reference's ``models/rwkv.py::wkv_scan`` (the
recurrence its rwkv6-7b trains through), of ``kernels/ref.py::wkv6_ref``
and, at mild decays, of ``models/rwkv.py::wkv_chunked`` (whose
``exp(-cumsum log w)`` overflows at strong ones); against
``torch.autograd`` of ``wkv6_plain``; and against finite differences in
float64 (``gradcheck``).  Decays are mild (RWKV6's initialisation) or
strong (|log w| up to 20, a stretch of w = 0, a stretch of w = 1 - 1e-4),
lengths ragged, with and without an initial state and a final-state
gradient, at every head_dim the kernels take.  Each gradient of a token
(dr, dk, dv, dw; d(state) per state row; du per head) is held per row:
its error norm over its norm in the reference, that norm floored at
``GRAD_ROW_FLOOR`` times the RMS row norm.

``wkv6_bwd_schedule_model`` is a float32 model of the kernels' schedule
(``csrc/wkv6_bwd.cu``): chunk summaries of ``L`` tokens as running
products and products, the scan over chunks in both directions, and per
chunk, from its two checkpoints, dr, dk, dv through the sub-block
factorization (``SUB``-token sub-blocks) and dw term by term; du's
per-(b, h, chunk) partials summed in one order.  It is held against the
plain backward at ragged lengths, mild and strong decays, with and without
a state and a final-state gradient; two planted faults (a chunk reading the
previous chunk's S checkpoint; a chunk's dG left out of the scan) must
exceed the row limit.  Pins on the source: no atomics, no division by w,
no log or exp, each kernel launched, every head_dim dispatched, the
products on ``mma``.  Autograd through ``_WKV6`` runs here on CPU tensors
with the plain versions (the plumbing the card runs); the CUDA kernels are
held against the plain version by ``tests/test_torch_wkv6.py``'s card test
and by ``chip_smoke.py``.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.models.rwkv import wkv_chunked as ref_wkv_chunked
from repro.models.rwkv import wkv_scan as ref_wkv_scan
from repro_torch.configs import get_arch
from repro_torch.data.pipeline import batches_for_arch
from repro_torch.kernels import wkv6 as wkv6_mod
from repro_torch.kernels.wkv6 import HEAD_DIMS, wkv6, wkv6_bwd, wkv6_bwd_plain, wkv6_plain
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models.transformer import forward_loss, init_params
from repro_torch.training.tree import leaves_with_paths, tree_unflatten

SOURCE = Path(wkv6_mod.__file__).resolve().parent / "csrc" / "wkv6_bwd.cu"
ROW_TOL = 1e-4          # float32 arithmetic in another order
GRAD_ROW_FLOOR = 0.1    # the row norm's floor, times the RMS row norm


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The suite runs several workers on a few cores: two intra-op threads
    for this file's torch ops keep it from starving the wall-clock tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _decays(kind, shape, rng):
    """``mild``: exp(-exp(-2 + noise)), |log w| about 0.14; ``strong``:
    exp(-exp(x)) with |log w| up to 20, a stretch of 20 tokens of w = 0
    and one of up to 70 of w = 1 - 1e-4."""
    if kind == "mild":
        return np.exp(-np.exp(-2.0 + 0.5 * rng.standard_normal(shape))).astype(np.float32)
    w = np.exp(-np.exp(rng.uniform(-6.0, np.log(20.0), shape))).astype(np.float32)
    t = shape[1]
    w[:, t // 4:t // 4 + 20] = 0.0
    w[:, t // 2:t // 2 + 70] = np.float32(1.0 - 1e-4)
    return w


def _inputs(b, t, h, hd, kind, seed, with_state=True):
    """Seeded numpy r, k, v, w, u, initial state, dout and final-state
    gradient (the last two None without ``with_state``), float32."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, t, h, hd), dtype=np.float32) for _ in range(3))
    w = _decays(kind, (b, t, h, hd), rng)
    u = (rng.standard_normal((h, hd)) * 0.1).astype(np.float32)
    dout = rng.standard_normal((b, t, h, hd), dtype=np.float32)
    s0 = rng.standard_normal((b, h, hd, hd), dtype=np.float32) if with_state else None
    dfinal = rng.standard_normal((b, h, hd, hd), dtype=np.float32) if with_state else None
    return r, k, v, w, u, s0, dout, dfinal


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a, np.float32))


def _rows(x):
    x = torch.from_numpy(np.array(x, np.float32)) if not isinstance(x, torch.Tensor) else x
    return x.float().reshape(-1, x.shape[-1])


def row_err(got, want, floor) -> float:
    """The largest error norm of one row over that row's norm in ``want``,
    floored at ``floor``."""
    diff = (_rows(got) - _rows(want)).norm(dim=-1)
    return float((diff / _rows(want).norm(dim=-1).clamp_min(max(floor, 1e-30))).max())


def row_floor(*grads) -> float:
    """GRAD_ROW_FLOOR times the RMS row norm over ``grads`` together."""
    sq = torch.cat([_rows(g).norm(dim=-1).square() for g in grads])
    return float(GRAD_ROW_FLOOR * sq.mean().sqrt())


def _check(got, want, tol=ROW_TOL):
    """got, want: (dr, dk, dv, dw, du, d(state)); the four token gradients
    per row under one floor, du per head and d(state) per row under their
    own."""
    floor = row_floor(*want[:4])
    for name, g, w_ in zip(("dr", "dk", "dv", "dw"), got[:4], want[:4]):
        err = row_err(g, w_, floor)
        assert err <= tol, f"{name}: row error {err:.3e} over {tol}"
    for name, g, w_ in zip(("du", "dstate"), got[4:], want[4:]):
        if w_ is None:
            continue
        err = row_err(g, w_, row_floor(w_))
        assert err <= tol, f"{name}: row error {err:.3e} over {tol}"
    for g in got:
        if g is not None:
            assert bool(torch.isfinite(_rows(g)).all())


def _jax_scan_grads(r, k, v, w, u, s0, dout, dfinal):
    """jax.grad of sum(out * dout) + sum(final * dfinal) through the
    reference's ``wkv_scan`` (zero state and no final gradient when None)."""
    b, _, h, hd = r.shape
    s0 = np.zeros((b, h, hd, hd), np.float32) if s0 is None else s0
    df = np.zeros((b, h, hd, hd), np.float32) if dfinal is None else dfinal

    def loss(r, k, v, w, u, s):
        out, final = ref_wkv_scan(r, k, v, w, u, s)
        return jnp.sum(out * dout) + jnp.sum(final * df)

    return jax.grad(loss, argnums=tuple(range(6)))(*(jnp.asarray(a) for a in (r, k, v, w, u, s0)))


def _plain(r, k, v, w, u, s0, dout, dfinal):
    return wkv6_bwd_plain(*(_t(a) for a in (r, k, v, w, u)), _t(s0), _t(dout), _t(dfinal))


# --------------------------------------------------------------------------
# The plain backward against the JAX package and autograd
# --------------------------------------------------------------------------
@pytest.mark.parametrize("with_state", [False, True], ids=["zero-state", "state-and-dfinal"])
@pytest.mark.parametrize("kind", ["mild", "strong"])
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_plain_backward_matches_jax_grad_of_wkv_scan(hd, kind, with_state):
    # T = 150: ragged against the kernels' 64-token chunks, and long enough
    # for both strong-decay stretches (w = 0 at 37..56, w ~ 1 at 75..144).
    arrays = _inputs(2, 150, 2, hd, kind, seed=hd, with_state=with_state)
    got = _plain(*arrays)
    want = _jax_scan_grads(*arrays)
    _check(got, want[:5] + (want[5] if with_state else None,))


@pytest.mark.parametrize("kind", ["mild", "strong"])
@pytest.mark.parametrize("b,t,h,hd", [(1, 37, 3, 16), (2, 100, 2, 64)])
def test_plain_backward_matches_jax_grad_of_wkv6_ref(b, t, h, hd, kind):
    r, k, v, w, u, _, dout, _ = _inputs(b, t, h, hd, kind, seed=t, with_state=False)

    def flat(a):
        return jnp.asarray(a).transpose(0, 2, 1, 3).reshape(b * h, t, hd)

    def loss(r, k, v, w, u):
        uf = jnp.broadcast_to(u[None], (b, h, hd)).reshape(b * h, 1, hd)
        out = ref.wkv6_ref(flat(r), flat(k), flat(v), flat(w), uf)
        return jnp.sum(out.reshape(b, h, t, hd).transpose(0, 2, 1, 3) * dout)

    want = jax.grad(loss, argnums=tuple(range(5)))(*(jnp.asarray(a) for a in (r, k, v, w, u)))
    got = _plain(r, k, v, w, u, None, dout, None)
    _check(got[:5] + (None,), tuple(want) + (None,))


@pytest.mark.parametrize("chunk", [16, 32])
def test_plain_backward_matches_jax_grad_of_wkv_chunked_at_mild_decays(chunk):
    arrays = _inputs(2, 64, 2, 16, "mild", seed=chunk)

    def loss(r, k, v, w, u, s):
        out, final = ref_wkv_chunked(r, k, v, w, u, s, chunk=chunk)
        return jnp.sum(out * arrays[6]) + jnp.sum(final * arrays[7])

    r, k, v, w, u, s0 = arrays[:6]
    want = jax.grad(loss, argnums=tuple(range(6)))(*(jnp.asarray(a) for a in (r, k, v, w, u, s0)))
    _check(_plain(*arrays), want)


@pytest.mark.parametrize("with_state", [False, True], ids=["zero-state", "state-and-dfinal"])
@pytest.mark.parametrize("kind", ["mild", "strong"])
@pytest.mark.parametrize("b,t,h,hd", [(1, 1, 2, 8), (2, 150, 3, 32)])
def test_plain_backward_matches_autograd_of_wkv6_plain(b, t, h, hd, kind, with_state):
    arrays = _inputs(b, t, h, hd, kind, seed=7, with_state=with_state)
    r, k, v, w, u, s0, dout, dfinal = (_t(a) for a in arrays)
    leaves = [a.clone().requires_grad_(True) for a in (r, k, v, w, u)]
    state = None if s0 is None else s0.clone().requires_grad_(True)
    out, final = wkv6_plain(*leaves, state)
    loss = (out * dout).sum() + (0.0 if dfinal is None else (final * dfinal).sum())
    inputs = leaves + ([] if state is None else [state])
    # At T = 1 without a final-state gradient the loss does not reach w.
    want = [torch.zeros_like(a) if g is None else g
            for a, g in zip(inputs, torch.autograd.grad(loss, inputs, allow_unused=True))]
    _check(wkv6_bwd_plain(r, k, v, w, u, s0, dout, dfinal), tuple(want) + (() if with_state else (None,)))


def _wkv6_f64(r, k, v, w, u, s):
    """The recurrence in float64 (the yardstick's forward)."""
    outs = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, t], s + u[None, :, :, None] * kv))
        s = w[:, t, :, :, None] * s + kv
    return torch.stack(outs, dim=1), s


class _PlainF64(torch.autograd.Function):
    @staticmethod
    def forward(ctx, r, k, v, w, u, s):
        ctx.save_for_backward(r, k, v, w, u, s)
        return _wkv6_f64(r, k, v, w, u, s)

    @staticmethod
    def backward(ctx, dout, dfinal):
        return wkv6_bwd_plain(*ctx.saved_tensors, dout, dfinal)


def test_plain_backward_passes_gradcheck_in_float64():
    rng = np.random.default_rng(3)
    b, t, h, hd = 1, 5, 2, 3
    args = [torch.from_numpy(rng.standard_normal(shape)).requires_grad_(True)
            for shape in [(b, t, h, hd)] * 3]
    w = torch.from_numpy(rng.uniform(0.0, 1.0, (b, t, h, hd))).requires_grad_(True)
    u = torch.from_numpy(rng.standard_normal((h, hd))).requires_grad_(True)
    s = torch.from_numpy(rng.standard_normal((b, h, hd, hd))).requires_grad_(True)
    assert torch.autograd.gradcheck(_PlainF64.apply, (*args, w, u, s))
    assert wkv6_bwd_plain(*(a.detach() for a in (*args, w, u, s)), torch.ones(b, t, h, hd).double())[0].dtype \
        == torch.float64


# --------------------------------------------------------------------------
# A CPU model of the kernels' schedule
# --------------------------------------------------------------------------
def _source_constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE.read_text()).group(1))


L, SUB = _source_constant("L"), _source_constant("SUB")
NSUB = L // SUB


def _chunked(x, n_chunks, fill):
    """(B, T, H, hd) -> (B, H, chunks, L, hd) in float32, rows past T set
    to ``fill``."""
    b, t_len, h, hd = x.shape
    out = torch.full((b, h, n_chunks * L, hd), fill, dtype=torch.float32)
    out[:, :, :t_len] = x.float().permute(0, 2, 1, 3)
    return out.reshape(b, h, n_chunks, L, hd)


def _blk(x, a):
    """Rows of sub-block a (the second-last axis)."""
    return x[..., a * SUB:(a + 1) * SUB, :]


def wkv6_bwd_schedule_model(r, k, v, w, u, state, dout, dfinal, s_fault=None, g_fault=None):
    """The ``wkv6_bwd`` kernels' schedule in float32 torch, every (b, h,
    chunk) at once: the chunk summaries (running products of w, then dS
    and dG as products); the scan of S forward and of G backward over the
    chunks; per chunk, from the two checkpoints, dr, dk and dv through the
    sub-block factorization (products between sub-blocks, running products
    inside them) and dw as the row sums of G_t * S_{t-1} taken term by term
    (each pair of a source of S and a source of G); du's per-(b, h, chunk)
    partials summed in one order.  Planted faults: chunk ``s_fault`` reads
    the previous chunk's S checkpoint; chunk ``g_fault``'s dG is left out
    of the scan, so the G checkpoints of earlier chunks miss it."""
    b, t_len, h, hd = r.shape
    nc = -(-t_len // L)
    rc, kc, vc, dc = (_chunked(a, nc, 0.0) for a in (r, k, v, dout))
    wc = _chunked(w, nc, 1.0)
    uu = u.float()[None, :, None, None, :]
    ones = torch.ones_like(wc[..., 0, :])

    # sums_kernel
    pre, suf = torch.empty_like(wc), torch.empty_like(wc)
    p = ones
    for t in range(L):
        pre[..., t, :] = p
        p = p * wc[..., t, :]
    total = p
    p = ones
    for t in reversed(range(L)):
        suf[..., t, :] = p
        p = p * wc[..., t, :]
    d_s = (kc * suf).transpose(-1, -2) @ vc
    d_g = (rc * pre).transpose(-1, -2) @ dc

    # scan_kernel
    s = torch.zeros((b, h, hd, hd)) if state is None else state.float()
    ck_s = []
    for c in range(nc):
        ck_s.append(s)
        s = total[:, :, c, :, None] * s + d_s[:, :, c]
    g = torch.zeros((b, h, hd, hd)) if dfinal is None else dfinal.float()
    ck_g = [None] * nc
    for c in reversed(range(nc)):
        ck_g[c] = g
        g = total[:, :, c, :, None] * g + (0.0 if c == g_fault else d_g[:, :, c])
    dstate = g
    if s_fault is not None:
        ck_s[s_fault] = ck_s[s_fault - 1]
    sc, gc = torch.stack(ck_s, 2), torch.stack(ck_g, 2)

    # grads_kernel.  pf_t = P(p..t-1), pb_s = P(s+1..e) inside a sub-block;
    # f[a][b] = T_b ... T_{a-1}, the sub-block totals' products.
    pf, pb = torch.empty_like(wc), torch.empty_like(wc)
    tot = []
    for a in range(NSUB):
        p = ones
        for q in range(SUB):
            pf[..., a * SUB + q, :] = p
            p = p * wc[..., a * SUB + q, :]
        tot.append(p)
        p = ones
        for q in reversed(range(SUB)):
            pb[..., a * SUB + q, :] = p
            p = p * wc[..., a * SUB + q, :]
    f = [[ones] * (a + 1) for a in range(NSUB + 1)]
    for a in range(NSUB + 1):
        for bb in reversed(range(a)):
            f[a][bb] = f[a][bb + 1] * tot[bb]
    rh, kh = rc * pf, kc * pb
    da = dc @ vc.transpose(-1, -2)                                 # dA[t][s] = dout_t . v_s
    am = torch.zeros_like(da)
    for a in range(NSUB):
        for bb in range(a):
            am[..., a * SUB:(a + 1) * SUB, bb * SUB:(bb + 1) * SUB] = (
                (_blk(rh, a) * f[a][bb + 1][..., None, :]) @ _blk(kh, bb).transpose(-1, -2))
    for t in range(L):
        p0 = t - t % SUB
        am[..., t, t] = (rc[..., t, :] * uu[..., 0, :] * kc[..., t, :]).sum(-1)
        q = rc[..., t, :]
        for s_ in reversed(range(p0, t)):
            am[..., t, s_] = (q * kc[..., s_, :]).sum(-1)
            q = q * wc[..., s_, :]
    q1, q2 = dc @ sc.transpose(-1, -2), vc @ gc.transpose(-1, -2)  # dout S_c^T, v G_c^T
    dv = am.transpose(-1, -2) @ dc
    d_acc, e_acc = torch.empty_like(rc), torch.empty_like(rc)     # S before the sub-block . dout, G after it . v
    w_pairs = {}
    for a in range(NSUB):
        rows = slice(a * SUB, (a + 1) * SUB)
        dv[..., rows, :] += (_blk(kh, a) * f[NSUB][a + 1][..., None, :]) @ gc
        d_acc[..., rows, :] = f[a][0][..., None, :] * _blk(q1, a)
        for bb in range(a):
            part = da[..., rows, bb * SUB:(bb + 1) * SUB] @ _blk(kh, bb)
            d_acc[..., rows, :] += f[a][bb + 1][..., None, :] * part
            if a - bb >= 2:
                w_pairs[a, bb] = (_blk(rh, a) * part).sum(-2)
        e_acc[..., rows, :] = f[NSUB][a + 1][..., None, :] * _blk(q2, a)
        for cc in range(a + 1, NSUB):
            part = da[..., cc * SUB:(cc + 1) * SUB, rows].transpose(-1, -2) @ _blk(rh, cc)
            e_acc[..., rows, :] += f[cc][a + 1][..., None, :] * part
    vd = torch.diagonal(da, dim1=-2, dim2=-1)[..., None]            # v_t . dout_t
    dr = pf * d_acc + uu * kc * vd
    dk = pb * e_acc + rc * uu * vd
    du_part = (rc * kc * vd).sum(-2)
    for t in range(L):
        p0 = t - t % SUB
        p = ones
        for s_ in reversed(range(p0, t)):
            dr[..., t, :] += da[..., t, s_, None] * kc[..., s_, :] * p
            p = p * wc[..., s_, :]
        p = ones
        for t2 in range(t + 1, p0 + SUB):
            dk[..., t, :] += da[..., t2, t, None] * rc[..., t2, :] * p
            p = p * wc[..., t2, :]

    # dw_t = rowsum(G_t * S_{t-1}).  For t in sub-block a with S^a the state
    # before the sub-block and G^a its gradient after it: pf_t pb_t
    # rowsum(S^a * G^a), plus pf_t sum_{s>t in a} P(t+1..s-1) r_s D_s, plus
    # pb_t sum_{s<t in a} P(s+1..t-1) k_s E_s, plus the pairs of a k_s v_s^T
    # and an r_s' dout_s'^T both inside the sub-block (s < t < s').
    rq1 = [(_blk(rh, a) * _blk(q1, a)).sum(-2) for a in range(NSUB)]
    kq2 = [(_blk(kh, a) * _blk(q2, a)).sum(-2) for a in range(NSUB)]
    rs_c = (sc * gc).sum(-1)
    dw = torch.empty_like(rc)
    for a in range(NSUB):
        rs_a = f[a][0] * f[NSUB][a + 1] * rs_c
        for cc in range(a + 1, NSUB):
            rs_a = rs_a + f[a][0] * f[cc][a + 1] * rq1[cc]
        for bb in range(a):
            rs_a = rs_a + f[NSUB][a + 1] * f[a][bb + 1] * kq2[bb]
            for cc in range(a + 1, NSUB):
                rs_a = rs_a + f[a][bb + 1] * f[cc][a + 1] * w_pairs[cc, bb]
        p0, e = a * SUB, (a + 1) * SUB
        z = torch.zeros_like(ones)
        later = {}
        for t in reversed(range(p0, e)):
            later[t] = z
            z = wc[..., t, :] * z + rc[..., t, :] * d_acc[..., t, :]
        z = torch.zeros_like(ones)
        m = {s_: torch.zeros_like(ones) for s_ in range(p0, e)}   # sum_{s<t} P(s+1..t-1) k_s dA[s'][s]
        for t in range(p0, e):
            inner, p = torch.zeros_like(ones), ones
            for s2 in range(t + 1, e):
                inner = inner + p * rc[..., s2, :] * m[s2]
                p = p * wc[..., s2, :]
            dw[..., t, :] = (pf[..., t, :] * pb[..., t, :] * rs_a + pf[..., t, :] * later[t]
                             + pb[..., t, :] * z + inner)
            z = wc[..., t, :] * z + kc[..., t, :] * e_acc[..., t, :]
            for s2 in range(t + 1, e):
                m[s2] = wc[..., t, :] * m[s2] + kc[..., t, :] * da[..., s2, t, None]

    def back(x):
        return x.reshape(b, h, nc * L, hd)[:, :, :t_len].permute(0, 2, 1, 3)

    return (*(back(x) for x in (dr, dk, dv, dw)), du_part.sum((0, 2)), dstate)


@pytest.mark.parametrize("with_state", [False, True], ids=["zero-state", "state-and-dfinal"])
@pytest.mark.parametrize("kind", ["mild", "strong"])
@pytest.mark.parametrize("b,t,h,hd", [(2, 150, 2, 16), (1, 97, 3, 8), (3, 31, 1, 32), (1, 200, 1, 64)])
def test_schedule_model_matches_the_plain_backward(b, t, h, hd, kind, with_state):
    arrays = [_t(a) for a in _inputs(b, t, h, hd, kind, seed=b * t, with_state=with_state)]
    _check(wkv6_bwd_schedule_model(*arrays), wkv6_bwd_plain(*arrays))


def test_a_one_chunk_fault_exceeds_the_row_limit():
    arrays = [_t(a) for a in _inputs(2, 150, 2, 16, "mild", seed=5)]
    want = wkv6_bwd_plain(*arrays)
    fault = wkv6_bwd_schedule_model(*arrays, s_fault=2)
    floor = row_floor(*want[:4])
    errs = [row_err(g, w_, floor) for g, w_ in zip(fault[:4], want[:4])]
    assert errs[0] > 10 * ROW_TOL and errs[3] > 10 * ROW_TOL, errs   # dr and dw see the wrong state
    with pytest.raises(AssertionError):
        _check(fault, want)


def test_a_g_checkpoint_missing_its_chunk_summary_exceeds_the_row_limit():
    """Chunk 2's dG left out of the scan: the G checkpoints of chunks 0 and
    1 miss it, so their dk, dv and dw (which read G) pass the row limit.
    dr reads S alone, so it stays right, as does everything of chunks 2
    and 3."""
    arrays = [_t(a) for a in _inputs(2, 200, 2, 16, "mild", seed=6)]
    want = wkv6_bwd_plain(*arrays)
    fault = wkv6_bwd_schedule_model(*arrays, g_fault=2)
    floor = row_floor(*want[:4])
    early, late = slice(0, 2 * L), slice(2 * L, None)
    errs = {name: row_err(g[:, early], w_[:, early], floor)
            for name, g, w_ in zip(("dr", "dk", "dv", "dw"), fault[:4], want[:4])}
    assert min(errs["dk"], errs["dv"], errs["dw"]) > 10 * ROW_TOL, errs
    assert errs["dr"] <= ROW_TOL, errs
    for g, w_ in zip(fault[:4], want[:4]):
        assert row_err(g[:, late], w_[:, late], floor) <= ROW_TOL
    with pytest.raises(AssertionError):
        _check(fault, want)


def test_bwd_chunk_mirrors_the_source():
    assert wkv6_mod.BWD_CHUNK == L
    assert L % SUB == 0


def _code() -> str:
    return "\n".join(line.split("//")[0] for line in SOURCE.read_text().splitlines())


def test_source_has_no_atomics_and_never_divides_by_a_decay():
    code = _code()
    assert not re.search(r"atomic", code)
    assert not re.search(r"/\s*w", code) and not re.search(r"\blog2?f?\s*\(", code)
    assert not re.search(r"\b(exp2?f?|__expf|ex2)\b", code)   # every factor a product of w


def test_source_launches_each_kernel_and_dispatches_every_head_dim():
    code = _code()
    for kernel in ("sums_kernel", "grads_kernel"):
        assert re.search(rf"{kernel}<TR, TW, HD><<<", code), kernel
    assert re.search(r"scan_kernel<<<", code)
    for hd in HEAD_DIMS:
        assert re.search(rf"case {hd}: return launch<TR, TW, {hd}>", code), hd


def test_source_runs_its_products_on_the_tensor_cores():
    code = _code()
    assert re.search(r"tf32::mma\(", code) and "mma_split<" in code
    assert "cp_async16(" in code


# --------------------------------------------------------------------------
# The autograd function's plumbing, on CPU tensors with the plain versions
# --------------------------------------------------------------------------
def _function_leaves(arrays, dtype=torch.float32, w_dtype=torch.float32, with_state=True):
    r, k, v, w, u, s0, _, _ = (_t(a) for a in arrays)
    leaves = [a.to(dtype).requires_grad_(True) for a in (r, k, v)]
    leaves += [w.to(w_dtype).requires_grad_(True), u.requires_grad_(True)]
    state = s0.requires_grad_(True) if with_state else None
    return leaves, state


@pytest.mark.parametrize("uses", ["out", "final", "both"])
def test_function_matches_autograd_of_the_plain_version(uses):
    arrays = _inputs(2, 70, 2, 16, "strong", seed=11)
    dout, dfinal = _t(arrays[6]), _t(arrays[7])
    grads = []
    for fn in (wkv6_mod._WKV6.apply, wkv6_plain):
        leaves, state = _function_leaves(arrays)
        out, final = fn(*leaves, state)
        loss = {"out": (out * dout).sum(), "final": (final * dfinal).sum(),
                "both": (out * dout).sum() + (final * dfinal).sum()}[uses]
        inputs = leaves + [state]
        # The final state does not reach r (nor u): the function gives
        # zeros where autograd of the plain loop gives None.
        grads.append([torch.zeros_like(a) if g is None else g
                      for a, g in zip(inputs, torch.autograd.grad(loss, inputs, allow_unused=True))])
    for g, w_ in zip(*grads):
        assert g.dtype == w_.dtype
        torch.testing.assert_close(g, w_, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16])
def test_function_returns_gradients_in_the_inputs_dtypes(w_dtype):
    arrays = _inputs(1, 40, 2, 8, "mild", seed=12)
    dout = _t(arrays[6])
    grads = []
    for fn in (wkv6_mod._WKV6.apply, wkv6_plain):
        leaves, _ = _function_leaves(arrays, torch.bfloat16, w_dtype, with_state=False)
        out, _ = fn(*leaves, None)
        grads.append(torch.autograd.grad((out * dout).sum(), leaves))
    for g, w_, dt in zip(*grads, (torch.bfloat16,) * 3 + (w_dtype, torch.float32)):
        assert g.dtype == w_.dtype == dt
        torch.testing.assert_close(g.float(), w_.float(), rtol=1e-2, atol=1e-2)


def test_function_gives_no_gradient_to_a_missing_state_and_one_to_a_given_state():
    arrays = _inputs(1, 20, 1, 8, "mild", seed=13)
    dout = _t(arrays[6])
    leaves, state = _function_leaves(arrays)
    out, _ = wkv6_mod._WKV6.apply(*leaves, state)
    grads = torch.autograd.grad((out * dout).sum(), leaves + [state])
    want = wkv6_bwd_plain(*(a.detach() for a in leaves), state.detach(), dout)
    torch.testing.assert_close(grads[5], want[5])
    leaves, _ = _function_leaves(arrays, with_state=False)
    out, _ = wkv6_mod._WKV6.apply(*leaves, None)
    assert all(g is not None for g in torch.autograd.grad((out * dout).sum(), leaves))


@pytest.mark.parametrize("remat", [True, False])
def test_function_gives_reduced_rwkv6_the_plain_recurrences_gradient(monkeypatch, remat):
    """forward_loss of reduced rwkv6-7b with its time mix through ``_WKV6``
    (the card's autograd function, here with the plain versions) against
    the same model through ``wkv6_plain``, which autograd differentiates."""
    cfg = get_arch("rwkv6-7b").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu", dtype=torch.float32)
    batch = next(batches_for_arch(cfg, 2, 40, seed=1, device="cpu"))
    flat = leaves_with_paths(params)

    def grads():
        live = [p.detach().requires_grad_(True) for _, p in flat]
        loss, _ = forward_loss(cfg, tree_unflatten(params, live), batch, remat=remat)
        return torch.autograd.grad(loss, live)

    want = grads()
    calls = []

    def through_function(r, k, v, w, u, state=None):
        calls.append(r.shape)
        return wkv6_mod._WKV6.apply(r, k, v, w, u, state)

    monkeypatch.setattr(rwkv_mod, "wkv6", through_function)
    got = grads()
    assert len(calls) == cfg.n_layers * (2 if remat else 1)
    for (path, _), g, w_ in zip(flat, got, want):
        err = float((g - w_).norm() / w_.norm().clamp_min(1e-30))
        assert err <= 1e-5, (path, err)


def test_cpu_call_records_through_the_plain_recurrence():
    """On CPU tensors ``wkv6`` is ``wkv6_plain``: its output has the
    plain loop's autograd graph, not the function's."""
    leaves, _ = _function_leaves(_inputs(1, 4, 1, 8, "mild", seed=1), with_state=False)
    out, _ = wkv6(*leaves)
    assert "WKV6" not in type(out.grad_fn).__name__


def test_bwd_wrapper_rejects_a_bad_output_gradient():
    r, k, v, w, u, s0, dout, _ = (_t(a) for a in _inputs(1, 4, 1, 8, "mild", seed=2))
    with pytest.raises(ValueError, match="dout"):
        wkv6_bwd(r, k, v, w, u, s0, dout[:, :3])
    with pytest.raises(ValueError, match="dout"):
        wkv6_bwd(r, k, v, w, u, s0, dout.double())
    with pytest.raises(ValueError, match="dfinal"):
        wkv6_bwd(r, k, v, w, u, s0, dout, torch.zeros(1, 1, 8, 4))
