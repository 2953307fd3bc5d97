"""The port's ``models/moe.py`` against the JAX package's.

The reference's dispatch decisions are read from the reference itself: its
``_moe_groups`` builds a (G, gs, E, C) one-hot ``dispatch`` tensor (1 where
a token is kept at an expert's slot) and contracts it with the tokens in
``einsum("gtd,gtec->gecd", ...)``; the tests run the reference un-jitted
with that einsum observed, and hold the port's kept (token, expert, slot)
triples equal to it.  Everything runs on the CPU in float32.
"""
import contextlib
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode

from repro.models import moe as ref_moe
from repro_torch.configs import ARCHS
from repro_torch.models import moe
from repro_torch.roofline import counter

D, F = 32, 48
TOL = 1e-5


class _RecordingNumpy:
    """``jax.numpy`` with ``einsum`` observed: records the dispatch tensor
    of every ``"gtd,gtec->gecd"`` contraction."""

    def __init__(self):
        self.dispatch = []

    def __getattr__(self, name):
        return getattr(jnp, name)

    def einsum(self, spec, *operands, **kw):
        if spec == "gtd,gtec->gecd":
            self.dispatch.append(np.asarray(operands[1]))
        return jnp.einsum(spec, *operands, **kw)


def _params(n_experts, seed=0):
    rng = np.random.default_rng(seed)
    arrays = {
        "router": rng.standard_normal((D, n_experts)) / np.sqrt(D),
        "w_gate": rng.standard_normal((n_experts, D, F)) / np.sqrt(D),
        "w_in": rng.standard_normal((n_experts, D, F)) / np.sqrt(D),
        "w_out": rng.standard_normal((n_experts, F, D)) / np.sqrt(F),
    }
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    return (
        {k: jnp.asarray(v) for k, v in arrays.items()},
        {k: torch.from_numpy(v) for k, v in arrays.items()},
    )


def _run(monkeypatch, b, s, n_experts, k, **kw):
    """Both packages' moe_ffn on the same seeded input; returns (reference
    output, port output, the reference's dispatch tensors, the port's)."""
    jp, tp = _params(n_experts)
    x = np.random.default_rng(1).standard_normal((b, s, D), dtype=np.float32)
    rec = _RecordingNumpy()
    monkeypatch.setattr(ref_moe, "jnp", rec)
    with jax.disable_jit():          # lax.map then runs its body on concrete arrays
        want = ref_moe.moe_ffn(jnp.asarray(x), jp, k=k, **kw)
    port_dispatch = []
    route = moe.route

    def observed_route(xg, router, k_, C):
        out = route(xg, router, k_, C)
        _, _, keep, slot, _ = out
        one_hot = torch.nn.functional.one_hot(slot.clamp(max=C - 1), C).float()
        port_dispatch.append((one_hot * keep[..., None]).numpy())
        return out

    monkeypatch.setattr(moe, "route", observed_route)
    got = moe.moe_ffn(torch.from_numpy(x), tp, k=k, **kw)
    return want, got, np.concatenate(rec.dispatch), np.concatenate(port_dispatch)


CASES = {
    "top1": dict(b=2, s=24, n_experts=4, k=1),
    "top2": dict(b=2, s=24, n_experts=4, k=2),
    "top2-drops": dict(b=2, s=32, n_experts=4, k=2, capacity_factor=0.25),
    "top1-groups": dict(b=2, s=32, n_experts=8, k=1, group_size=8, capacity_factor=0.5),
    "top2-groups": dict(b=2, s=32, n_experts=4, k=2, group_size=8),
    "top2-chunked-groups": dict(b=2, s=128, n_experts=4, k=2, group_size=2, scan_group_chunk=64),
}


@pytest.mark.parametrize("case", CASES)
def test_moe_ffn_matches_the_reference(monkeypatch, case):
    want, got, ref_dispatch, port_dispatch = _run(monkeypatch, **CASES[case])
    # Kept tokens, experts and slots are the reference's, exactly.
    assert port_dispatch.shape == ref_dispatch.shape
    assert np.array_equal(port_dispatch, ref_dispatch)
    np.testing.assert_allclose(got.y.numpy(), np.asarray(want.y), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(got.aux_loss), float(want.aux_loss), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(got.router_entropy), float(want.router_entropy), rtol=TOL, atol=TOL)
    assert got.y.dtype == torch.float32 and got.y.shape == (CASES[case]["b"], CASES[case]["s"], D)


def test_low_capacity_really_drops_tokens(monkeypatch):
    """At capacity factor 0.25 some (token, expert) choices are dropped, and
    the chunked case runs more groups than one chunk holds."""
    _, _, ref_dispatch, _ = _run(monkeypatch, **CASES["top2-drops"])
    assert ref_dispatch.sum() < 2 * 32 * 2
    _, _, ref_dispatch, _ = _run(monkeypatch, **CASES["top2-chunked-groups"])
    assert ref_dispatch.shape[0] == 128 > 64


@pytest.mark.parametrize(
    "n_tokens,n_experts,k,factor",
    list(itertools.product([1, 7, 64, 1000, 4096], [1, 4, 8, 128], [1, 2], [0.25, 1.0, 1.25, 8.0])),
)
def test_expert_capacity_equals_the_reference(n_tokens, n_experts, k, factor):
    assert moe.expert_capacity(n_tokens, n_experts, k, factor) == ref_moe.expert_capacity(
        n_tokens, n_experts, k, factor
    )


def test_param_count_and_init_shapes():
    p = moe.moe_init(torch.Generator().manual_seed(0), D, F, 4, torch.bfloat16, device="cpu")
    ref = ref_moe.moe_init(jax.random.PRNGKey(0), D, F, 4, jnp.bfloat16)
    for name, leaf in ref.items():
        assert tuple(p[name].shape) == leaf.shape
        assert str(p[name].dtype)[6:] == str(leaf.dtype)
    assert sum(t.numel() for t in p.values()) == moe.moe_param_count(D, F, 4) == ref_moe.moe_param_count(D, F, 4)


def test_init_defaults_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        moe.moe_init(torch.Generator(), D, F, 4, torch.float32)


def test_weight_gather_is_a_no_op():
    _, tp = _params(4)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((1, 16, D), dtype=np.float32))
    a = moe.moe_ffn(x, tp, k=2)
    b = moe.moe_ffn(x, tp, k=2, weight_gather=True)
    assert torch.equal(a.y, b.y)


class _NoHostSync(TorchDispatchMode):
    """Raises on an op that reads a value back to the host or whose output
    shape depends on the values."""

    REFUSED = {torch.ops.aten._local_scalar_dense, torch.ops.aten.nonzero, torch.ops.aten.bincount}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in self.REFUSED:
            raise AssertionError(f"{func} on the MoE's path")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("case", ["top1", "top2", "top2-drops", "top1-groups", "top2-chunked-groups"])
def test_moe_ffn_makes_no_host_sync(case):
    """On plain tensors, forward and backward, the MoE reads no value back
    to the host and makes no shape from values: one static path, as a CUDA
    graph needs."""
    kw = dict(CASES[case])
    b, s, n_experts = kw.pop("b"), kw.pop("s"), kw.pop("n_experts")
    _, tp = _params(n_experts)
    tp = {n: t.requires_grad_() for n, t in tp.items()}
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((b, s, D), dtype=np.float32)).requires_grad_()
    with _NoHostSync():
        out = moe.moe_ffn(x, tp, **kw)
        loss = out.y.square().mean() + out.aux_loss + out.router_entropy
        grads = torch.autograd.grad(loss, [x, *tp.values()])
    assert all(torch.isfinite(g).all() and g.abs().sum() > 0 for g in grads)


def _counted_moe_layer(fake: bool) -> tuple[int, int, int]:
    """FLOPs, bytes and peak live bytes that the roofline counter sees for
    one reduced grok-1 MoE layer's forward and backward, on plain CPU
    tensors or on fake ones."""
    cfg = ARCHS["grok-1-314b"].reduced()
    p = moe.moe_init(torch.Generator().manual_seed(0), cfg.d_model, cfg.d_ff, cfg.n_experts, torch.float32,
                     device="cpu")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 256, cfg.d_model), dtype=np.float32))
    mode = FakeTensorMode() if fake else contextlib.nullcontext()
    leaves = [mode.from_tensor(t) if fake else t for t in (x, *p.values())]
    leaves = [t.requires_grad_() for t in leaves]
    x, p = leaves[0], dict(zip(p, leaves[1:]))
    c = counter._Counter(sharded=False)
    with mode:
        for t in leaves:
            c.hold(t)
        with c:
            out = moe.moe_ffn(x, p, k=cfg.experts_per_token, capacity_factor=cfg.capacity_factor, group_size=128)
            loss = out.y.square().mean() + cfg.n_experts * out.aux_loss
            grads = torch.autograd.grad(loss, leaves)
    assert len(grads) == len(leaves)
    return c.flops, c.bytes, c.peak


def test_moe_plan_counts_the_path_that_runs():
    """A reduced grok-1 MoE layer, forward and backward: the counter's
    FLOPs, bytes and peak on plain CPU tensors equal those on fake tensors
    (a dry run's), so the plan and the run are one path."""
    plain, fake = _counted_moe_layer(False), _counted_moe_layer(True)
    assert plain == fake
    assert plain[0] > 0 and plain[2] > 0
