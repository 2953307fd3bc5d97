"""The port's step bundles and its production training setup against the
JAX package's ``launch/steps.py``.

* ``train_config_for``: microbatches, moments' dtype, remat and its policy,
  for every arch and input shape on 1x1, 16x16 and 2x16x16 meshes.
* Every bundle (arch x input shape) on ``make_host_mesh(1, 1)``: each
  abstract argument's shape and dtype equals the reference's
  ``jax.eval_shape`` leaf, and each placement is the one its
  ``NamedSharding.spec`` names (the stacked layer axis dropped); the
  description and donated arguments are the reference's.
* ``materialize`` gives tensors of the abstract shapes and dtypes, plain
  on a one-device mesh and DTensors under the placements otherwise.
* bf16: the gradient of ``forward_loss`` of every reduced arch in
  bfloat16 against ``jax.grad`` of the reference's, and AdamW's update of
  bfloat16 parameters against the reference's.

Token ids are the port's ``TOKEN_DTYPE`` (int64) where the reference's are
int32; the comparison maps one onto the other.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import INPUT_SHAPES as REF_SHAPES
from repro.data import pipeline as ref_pipeline
from repro.launch import steps as ref_steps
from repro.launch.mesh import make_host_mesh as ref_make_host_mesh
from repro.models import transformer as ref_tf
from repro.training import optimizer as ref_opt
from repro_torch.configs import ARCHS, INPUT_SHAPES
from repro_torch.launch import sharding as shd
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import moe as port_moe
from repro_torch.models.frontend import TOKEN_DTYPE
from repro_torch.models.transformer import forward_loss, params_from_jax
from repro_torch.training.optimizer import AdamWConfig, adamw_init, adamw_update
from repro_torch.training.tree import leaves_with_paths, tree_unflatten
from tests.test_sharding_rules import FakeMesh

MESHES = {
    "1x1": {"data": 1, "model": 1},
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
}
DTYPES = {torch.float32: "float32", torch.bfloat16: "bfloat16", torch.int32: "int32", TOKEN_DTYPE: "int32"}
# bfloat16 keeps 8 significant bits (eps = 2^-8): every stored value is
# rounded by up to eps / 2.  The two packages round activations, attention
# probabilities and gradients at different points, so each package's bf16
# gradient carries its own accumulation of such roundings: on these models
# each leaf lies within about 8 eps of its norm from the float32 gradient
# of the same parameters (the test holds the port to that bound too, with
# margin, at 16 eps), and the two independent errors within twice that.
BF16_EPS = 2.0**-8
BF16_GRAD_TOL = 16 * BF16_EPS
# Leaves the reference's init_params keeps in float32 whatever the default
# type: the MoE router, RWKV6's decay base and bonus, the SSM's decay and
# skip.
FLOAT32_LEAVES = ("['router']", "['w0']", "['u']", "['A_log']", "['D']")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The suite runs several workers on a few cores: two intra-op threads
    for this file's torch ops keep it from starving the wall-clock tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def host_mesh():
    """The port's 1x1 mesh over a one-rank gloo group, destroyed afterwards."""
    assert not dist.is_initialized()
    mesh = make_host_mesh(1, 1, device="cpu")
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


# --------------------------------------------------------------------------
# train_config_for
# --------------------------------------------------------------------------
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("name", list(ARCHS))
def test_train_config_is_the_references(name, mesh_name):
    mesh = FakeMesh(dict(MESHES[mesh_name]))
    for shape_name, shape in INPUT_SHAPES.items():
        want = ref_steps.train_config_for(REF_ARCHS[name], REF_SHAPES[shape_name], mesh)
        got = steps.train_config_for(ARCHS[name], shape, mesh)
        assert got.n_microbatches == want.n_microbatches, shape_name
        assert (got.remat, got.remat_policy, got.aux_weight) == (want.remat, want.remat_policy, want.aux_weight)
        assert DTYPES[got.optimizer.moments_dtype] == jnp.dtype(want.optimizer.moments_dtype).name
        assert dataclasses.replace(got.optimizer, moments_dtype=None) == AdamWConfig(moments_dtype=None)
        assert dataclasses.replace(want.optimizer, moments_dtype=None) == ref_opt.AdamWConfig(moments_dtype=None)
    assert steps.BIG_MODEL_PARAMS == ref_steps.BIG_MODEL_PARAMS


def test_big_models_keep_bf16_moments():
    mesh = FakeMesh(dict(MESHES["16x16"]))
    big = [n for n, cfg in ARCHS.items() if cfg.param_count() > steps.BIG_MODEL_PARAMS]
    assert sorted(big) == ["grok-1-314b", "llama4-maverick-400b-a17b"]
    for name in big:
        tcfg = steps.train_config_for(ARCHS[name], INPUT_SHAPES["train_4k"], mesh)
        assert tcfg.optimizer.moments_dtype == torch.bfloat16
        assert tcfg.n_microbatches == 256 // 16


# --------------------------------------------------------------------------
# Bundles on the 1x1 host mesh
# --------------------------------------------------------------------------
def _ref_path(path: str, cfg) -> tuple[str, bool]:
    if "['layers'][" not in path:
        return path, False
    head, rest = path.split("['layers'][", 1)
    i, tail = rest.split("]", 1)
    return f"{head}['groups'][{int(i) % cfg.group_size}]{tail}", True


def _norm(spec) -> tuple:
    out = []
    for entry in spec:
        if isinstance(entry, tuple) and len(entry) == 1:
            entry = entry[0]
        out.append(entry if entry != () else None)
    return tuple(out)


def _ref_leaves(tree) -> dict:
    return {jax.tree_util.keystr(p): leaf for p, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _check_args(cfg, got, want):
    """Leaf by leaf: the port's abstract tensors against the reference's
    ShapeDtypeStructs (a stacked leaf carries n_groups first); every
    reference leaf is matched."""
    ref = _ref_leaves(want)
    seen = set()
    for path, leaf in leaves_with_paths(got):
        ref_path, stacked = _ref_path(path, cfg)
        w = ref[ref_path]
        seen.add(ref_path)
        shape = (cfg.n_groups, *leaf.shape) if stacked else tuple(leaf.shape)
        assert shape == tuple(w.shape), path
        assert DTYPES[leaf.dtype] == jnp.dtype(w.dtype).name, path
        # int64 only for token ids: the batch's, or decode's bare tokens argument
        assert leaf.dtype != TOKEN_DTYPE or path in ("", "['tokens']", "['labels']"), path
    assert seen == set(ref)


def _check_placements(cfg, mesh, got, want):
    """Each port leaf's placements are those of the reference leaf's spec,
    its stacked axis (never sharded) dropped."""
    ref = {k: _norm(s.spec) for k, s in _ref_leaves(want).items()}
    seen = set()
    for path, places in shd._spec_leaves(got):
        ref_path, stacked = _ref_path(path, cfg)
        spec = ref[ref_path]
        seen.add(ref_path)
        if stacked:
            assert spec[0] is None, path
            spec = spec[1:]
        assert places == shd.placements(spec, mesh), (path, places, spec)
    assert seen == set(ref)


@pytest.mark.parametrize("shape_name", list(INPUT_SHAPES))
@pytest.mark.parametrize("name", list(ARCHS))
def test_bundle_is_the_references(host_mesh, name, shape_name):
    cfg = ARCHS[name]
    want = ref_steps.build_step(REF_ARCHS[name], REF_SHAPES[shape_name], ref_make_host_mesh(1, 1))
    got = steps.build_step(cfg, INPUT_SHAPES[shape_name], host_mesh)
    assert got.description == want.description
    assert got.donate_argnums == want.donate_argnums
    assert len(got.args) == len(want.args)
    for g, w in zip(got.args, want.args):
        _check_args(cfg, g, w)
    for g, w in zip(got.in_placements, want.in_shardings):
        _check_placements(cfg, host_mesh, g, w)
    for g, w in zip(got.out_placements, want.out_shardings):
        _check_placements(cfg, host_mesh, g, w)
    # Abstract arguments hold no storage.
    assert all(isinstance(leaf, torch._subclasses.fake_tensor.FakeTensor)
               for _, leaf in leaves_with_paths(got.args))


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_materialize_runs_the_bundle(host_mesh, kind):
    """Reduced qwen1.5-0.5b: concrete arguments of the abstract shapes and
    dtypes, plain on the one-device mesh, through the bundle's ``fn``."""
    cfg = ARCHS["qwen1.5-0.5b"].reduced()
    shape = dataclasses.replace(INPUT_SHAPES[{"train": "train_4k", "prefill": "prefill_32k",
                                              "decode": "decode_32k"}[kind]], seq_len=32, global_batch=2)
    bundle = steps.build_step(cfg, shape, host_mesh)
    args = steps.materialize(bundle, torch.Generator().manual_seed(0), "cpu")
    for (path, a), (_, b) in zip(leaves_with_paths(args), leaves_with_paths(bundle.args), strict=True):
        assert type(a) is torch.Tensor, path
        assert (a.shape, a.dtype, a.device.type) == (b.shape, b.dtype, "cpu"), path
    out = bundle.fn(*args)
    logits = out[2]["loss"] if kind == "train" else out[0]
    assert bool(torch.isfinite(logits).all())
    if kind == "train":
        assert int(out[1]["step"]) == 1 and bundle.train_config.n_microbatches == 2


def test_materialize_distributes_on_a_larger_mesh():
    """On a 2 x 1 mesh (a fake two-rank group: its collectives move nothing)
    the arguments are DTensors under the bundle's placements."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    try:
        mesh = make_host_mesh(2, 1, device="cpu")
        cfg = ARCHS["qwen1.5-0.5b"].reduced()
        shape = dataclasses.replace(INPUT_SHAPES["prefill_32k"], seq_len=16, global_batch=2)
        bundle = steps.build_step(cfg, shape, mesh)
        args = steps.materialize(bundle, torch.Generator().manual_seed(0), "cpu")
        for arg, places in zip(args, bundle.in_placements):
            for (path, a), (_, p) in zip(leaves_with_paths(arg), shd._spec_leaves(places), strict=True):
                assert isinstance(a, DTensor) and a.placements == p, path
        assert bundle.in_placements[1]["tokens"][0].is_shard(0)     # the batch over 'data'
    finally:
        dist.destroy_process_group()


# --------------------------------------------------------------------------
# bf16: gradients and AdamW
# --------------------------------------------------------------------------
def _rel(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30))


def _bf16_batch(cfg, ref_cfg):
    """A seeded batch of 2 x 24 (past gemma3-1b's reduced window): token
    ids from numpy; for the frontends the reference's ``batches_for_arch``
    batch, its bfloat16 embeddings carried across through float32."""
    if cfg.frontend == "none":
        rng = np.random.default_rng(1)
        return {k: rng.integers(0, cfg.vocab_size, (2, 24), dtype=np.int32) for k in ("tokens", "labels")}
    batch = next(ref_pipeline.batches_for_arch(ref_cfg, 2, 24, seed=1))
    return {k: np.array(a) if np.issubdtype(np.asarray(a).dtype, np.integer) else np.array(a, dtype=np.float32)
            for k, a in batch.items()}


def _recording_top_k(calls: list):
    """``jax.lax.top_k`` that also hands each call's chosen indices, as the
    computation runs them (inside scans and remat too), to ``calls``."""
    top_k = jax.lax.top_k

    def record(x, k):
        vals, idx = top_k(x, k)
        jax.debug.callback(lambda i: calls.append(torch.from_numpy(np.array(i)).long()), idx)
        return vals, idx

    return record


def _replayed_route(choices: list):
    """The port's ``moe.route`` taking each call's top-k experts from
    ``choices`` in call order: gates are this side's router probabilities
    at those experts, renormalised as ``route`` renormalises them; slots
    and drops follow from the choice."""
    route = port_moe.route
    it = iter(choices)

    def replay(xg, router, k, C):
        _, _, _, _, probs = route(xg, router, k, C)
        fixed = torch.zeros_like(probs).scatter_(-1, next(it).reshape(*probs.shape[:-1], k), 1.0)
        chosen = probs * fixed
        slot = torch.cumsum(fixed, dim=1) - fixed
        return chosen / chosen.sum(-1, keepdim=True).clamp_min(1e-9), fixed, (fixed > 0) & (slot < C), slot.long(), probs

    return replay


@pytest.mark.parametrize("name", list(ARCHS))
def test_bf16_gradient_equals_the_references(monkeypatch, name):
    """Reduced, bfloat16 parameters (the reference's ``init_params`` in its
    default dtype) and a seeded batch (``_bf16_batch``): each leaf of the
    port's gradient within BF16_GRAD_TOL of its norm from ``jax.grad`` of
    the reference's loss, and from the reference's float32 gradient of the
    same parameters.  Where the reference's own bf16 gradient of a leaf is
    farther than BF16_GRAD_TOL from its float32 gradient, the port's may be
    as far plus BF16_GRAD_TOL: in grok-1 (0.13-0.29 of each leaf's norm)
    bfloat16 rounding of the router's input flips some tokens' top-k
    experts against the float32 run, and a flipped token takes another
    expert's weights.  The port's bf16 run takes the reference's bf16
    routing (recorded from ``jax.lax.top_k``, replayed through the port's
    ``moe.route``, without remat so that each layer routes once): their
    rounding differs, and one token near a tie of llama4's top-1 takes
    another expert on one side alone.  The audio frontend never reads
    ``embed``: its gradient is none, the reference's zero."""
    ref_cfg, cfg = REF_ARCHS[name].reduced(), ARCHS[name].reduced()
    ref_params = ref_tf.init_params(ref_cfg, jax.random.PRNGKey(1))
    assert all(a.dtype == jnp.bfloat16 for path, a in jax.tree_util.tree_leaves_with_path(ref_params)
               if a.ndim >= 2 and not jax.tree_util.keystr(path).endswith(FLOAT32_LEAVES))
    batch = _bf16_batch(cfg, ref_cfg)
    jbatch = {k: jnp.asarray(a).astype(jnp.bfloat16) if a.dtype == np.float32 else jnp.asarray(a)
              for k, a in batch.items()}

    def ref_grad(p):
        (loss, _), g = jax.value_and_grad(lambda q: ref_tf.forward_loss(ref_cfg, q, jbatch), has_aux=True)(p)
        return float(loss), dict(leaves_with_paths(params_from_jax(cfg, g)))

    choices = []
    with monkeypatch.context() as m:
        m.setattr(jax.lax, "top_k", _recording_top_k(choices))
        ref_loss, want = ref_grad(ref_params)
    _, exact = ref_grad(jax.tree.map(lambda a: a.astype(jnp.float32), ref_params))
    n_moe = sum(cfg.layer_is_moe(i) for i in range(cfg.n_layers)) if cfg.is_moe else 0
    assert len(choices) >= n_moe
    monkeypatch.setattr(port_moe, "route", _replayed_route(choices[:n_moe]))
    params = params_from_jax(cfg, ref_params)
    flat = leaves_with_paths(params)
    live = [p.detach().requires_grad_(True) for _, p in flat]
    tbatch = {k: torch.from_numpy(a).bfloat16() if a.dtype == np.float32 else torch.from_numpy(a).long()
              for k, a in batch.items()}
    loss, _ = forward_loss(cfg, tree_unflatten(params, live), tbatch, remat=not cfg.is_moe)
    grads = dict(zip([p for p, _ in flat], torch.autograd.grad(loss, live, allow_unused=True)))
    unread = {"['embed']"} if cfg.frontend == "audio" else set()
    assert {path for path, g in grads.items() if g is None} == unread
    assert float(loss.detach()) == pytest.approx(ref_loss, rel=BF16_EPS)
    for path, g in grads.items():
        if g is None:
            assert not bool(want[path].float().abs().max() > 0), path
            continue
        assert g.dtype == dict(flat)[path].dtype, path
        assert _rel(g, want[path]) <= BF16_GRAD_TOL, (path, _rel(g, want[path]))
        ref_off = _rel(want[path], exact[path])
        limit = BF16_GRAD_TOL if ref_off <= BF16_GRAD_TOL else ref_off + BF16_GRAD_TOL
        assert _rel(g, exact[path]) <= limit, (path, _rel(g, exact[path]), ref_off)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_bf16_adamw_equals_the_references(moments):
    """Three updates of reduced gemma3-1b's bfloat16 parameters from the same
    seeded bfloat16 gradients: new parameters within one bfloat16 rounding
    of the reference's, moments within float32 (or one bfloat16) rounding."""
    cfg, ref_cfg = ARCHS["gemma3-1b"].reduced(), REF_ARCHS["gemma3-1b"].reduced()
    jparams = ref_tf.init_params(ref_cfg, jax.random.PRNGKey(2))
    rng = np.random.default_rng(3)
    jparams = jax.tree.map(lambda a: (a.astype(jnp.float32) + 0.1 * rng.standard_normal(a.shape, dtype=np.float32))
                           .astype(a.dtype), jparams)
    ref_c = ref_opt.AdamWConfig(lr=1e-2, moments_dtype=getattr(jnp, moments))
    port_c = AdamWConfig(lr=1e-2, moments_dtype=getattr(torch, moments))
    params, ref_state = params_from_jax(cfg, jparams), ref_opt.adamw_init(jparams, ref_c)
    state = adamw_init(params, port_c)
    for step in range(3):
        g = jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(a.shape, dtype=np.float32)).astype(a.dtype), jparams)
        jparams, ref_state = ref_opt.adamw_update(g, ref_state, jparams, ref_c, 1.0)
        params, state = adamw_update(params_from_jax(cfg, g), state, params, port_c, 1.0)
    assert int(state["step"]) == 3
    mom_tol = BF16_EPS if moments == "bfloat16" else 1e-6
    for tree, want, tol in ((params, jparams, BF16_EPS), (state["m"], ref_state["m"], mom_tol),
                            (state["v"], ref_state["v"], mom_tol)):
        for (path, got), (_, w) in zip(leaves_with_paths(tree), leaves_with_paths(params_from_jax(cfg, want)),
                                       strict=True):
            assert got.dtype == w.dtype, path
            torch.testing.assert_close(got.float(), w.float(), rtol=tol, atol=1e-7, msg=path)
