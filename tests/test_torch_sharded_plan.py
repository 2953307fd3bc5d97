"""Sharded plans that keep sharded what the reference keeps sharded.

* Outputs: rank 0's ``output_bytes`` of every reduced arch's train,
  prefill and decode step on fake 2 x 4 and 4 x 2 meshes equal the
  per-device shard bytes of the reference's outputs under its
  ``out_shardings`` (``NamedSharding.shard_shape`` on a JAX
  ``AbstractMesh``), as ``tests/test_torch_dryrun.py`` holds the
  arguments.  The prefill caches among them take the reference's cache
  layout (the sequence over 'model').
* The loss: ``vocab_parallel_nll`` and its gradient equal ``log_softmax`` +
  ``nll_loss`` on the whole rows within 1e-6 relative, on a four-rank
  in-process group (``multi_threaded_pg``), even and uneven vocabularies;
  on a fake 1 x 4 mesh no collective of a train step carries the
  vocabulary.
* The MoE: the dispatched tokens' local shape is the reference's shard
  shape with and without ``weight_gather``, and the layer's output and
  gradients equal the unsharded layer's, on a 2 x 2 in-process group.
* Prefill and decode on a 2 x 2 in-process group equal the unsharded
  steps, with the caches split over the sequence.
* hymba's sequential scan: counted with its multiplicity, the FLOPs and
  bytes equal the whole loop's.
"""
import dataclasses
import math
import threading

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as JP
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication
from torch.testing._internal.distributed import multi_threaded_pg
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import ARCHS as REF_ARCHS
from repro.launch import steps as ref_steps
from repro_torch.configs import ARCHS, INPUT_SHAPES
from repro_torch.launch import dryrun, steps
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import MeshView
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.frontend import make_train_batch
from repro_torch.models.sharding_utils import vocab_parallel_nll
from repro_torch.models.transformer import decode_step, init_params, prefill_step
from repro_torch.roofline import counter
from repro_torch.training.tree import leaves_with_paths

ONE = MeshView({"data": 1, "model": 1}, ("data", "model"))
AXES = ("data", "model")
REL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def fake_group():
    """Starts a fake process group of the asked size; destroys it after the
    test, and checks that none is left."""
    started = []

    def start(n):
        assert not dist.is_initialized()
        started.append(dryrun.start_fake_group(n))

    yield start
    if started:
        dist.destroy_process_group()
    assert not dist.is_initialized()


def run_ranks(world: int, fn):
    """``fn(rank)`` on ``world`` threads, each a rank of an in-process
    group (``multi_threaded_pg``); returns the results by rank.  The group
    is destroyed afterwards."""
    assert not dist.is_initialized()
    torch._C._distributed_c10d._set_thread_isolation_mode(True)
    multi_threaded_pg._install_threaded_pg()
    store = dist.HashStore()
    results, errors = [None] * world, []

    def rank_main(rank):
        dist.init_process_group("threaded", rank=rank, world_size=world, store=store)
        try:
            results[rank] = fn(rank)
        except BaseException as e:      # noqa: BLE001 -- reported below, after every thread ends
            errors.append(e)
            multi_threaded_pg.ProcessLocalGroup.exception_handle(e)
        finally:
            dist.destroy_process_group()

    threads = [threading.Thread(target=rank_main, args=(r,)) for r in range(world)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
    finally:
        multi_threaded_pg.ProcessLocalGroup.reset()
        multi_threaded_pg._uninstall_threaded_pg()
        torch._C._distributed_c10d._set_thread_isolation_mode(False)
    if errors:
        raise errors[0]
    return results


def _close(got: torch.Tensor, want: torch.Tensor, rel: float = REL) -> None:
    err = (got.double() - want.double()).abs().max().item()
    assert err <= rel * want.double().abs().max().item(), err


# --------------------------------------------------------------------------
# Outputs: rank 0's bytes are the reference's shard bytes
# --------------------------------------------------------------------------
def _small(shape_name: str):
    return dataclasses.replace(INPUT_SHAPES[shape_name], seq_len=32, global_batch=4)


def _reference_output_bytes(name: str, shape_name: str, dims) -> int:
    bundle = ref_steps.build_step(REF_ARCHS[name].reduced(), _small(shape_name), AbstractMesh(dims, AXES))
    outs = jax.tree.leaves(jax.eval_shape(bundle.fn, *bundle.args))
    shardings = jax.tree.leaves(bundle.out_shardings, is_leaf=lambda s: hasattr(s, "shard_shape"))
    assert len(outs) == len(shardings)
    return sum(math.prod(s.shard_shape(a.shape)) * a.dtype.itemsize for a, s in zip(outs, shardings))


@pytest.mark.parametrize("dims", [(2, 4), (4, 2)], ids=["2x4", "4x2"])
@pytest.mark.parametrize("name", list(ARCHS))
def test_output_bytes_are_the_references_shard_bytes(fake_group, name, dims):
    fake_group(math.prod(dims))
    mesh = dryrun.dryrun_mesh(dims, AXES)
    for shape_name in ("train_4k", "prefill_32k", "decode_32k"):
        _, memory = counter.count(steps.build_step(ARCHS[name].reduced(), _small(shape_name), mesh))
        assert memory["output_bytes"] == _reference_output_bytes(name, shape_name, dims), shape_name


# --------------------------------------------------------------------------
# The vocabulary-parallel loss
# --------------------------------------------------------------------------
@pytest.mark.parametrize("vocab", [48, 50])
@pytest.mark.parametrize("dims", [(2, 2), (1, 4)], ids=["2x2", "1x4"])
def test_vocab_parallel_loss_and_gradient_are_the_whole_rows(dims, vocab):
    """Logits (B, S, V) split over the batch on 'data' and the vocabulary
    on 'model' (unevenly for V = 50 over 4): each rank's loss and its
    gradient shard equal ``log_softmax`` + ``nll_loss`` on the whole
    tensor, and the gradient keeps the logits' layout."""
    b, s = 4, 6
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.standard_normal((b, s, vocab)).astype(np.float32) * 4)
    labels = torch.from_numpy(rng.integers(0, vocab, (b, s)))
    whole = logits.clone().requires_grad_(True)
    want = F.nll_loss(torch.log_softmax(whole, -1).reshape(-1, vocab), labels.reshape(-1),
                      reduction="none").reshape(b, s)
    want.sum().backward()

    def rank(_):
        mesh = init_device_mesh("cpu", dims, mesh_dim_names=AXES)
        x = distribute_tensor(logits, mesh, [Shard(0), Shard(2)]).detach().requires_grad_(True)
        nll = vocab_parallel_nll(x, distribute_tensor(labels, mesh, [Shard(0), Replicate()]))
        nll.sum().backward()
        assert x.grad.placements == x.placements
        return nll.full_tensor(), x.grad.full_tensor()

    for nll, grad in run_ranks(math.prod(dims), rank):
        _close(nll, want.detach())
        _close(grad, whole.grad)


def test_other_logits_take_the_whole_rows():
    """Plain tensors, and DTensors whose vocabulary is whole, are not the
    vocabulary-parallel loss's."""
    assert vocab_parallel_nll(torch.zeros(2, 3, 8), torch.zeros(2, 3, dtype=torch.long)) is None


class _Collectives(TorchDispatchMode):
    """The shapes of every functional collective rank 0 issues (ops on
    DTensors pass to DTensor, whose collectives come back here)."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if func.namespace == "_c10d_functional" and func.__name__.split(".")[0] != "wait_tensor":
            self.shapes.append(tuple(out.shape))
        return out


def test_no_collective_of_a_train_step_carries_the_vocabulary(fake_group):
    """Reduced qwen1.5-0.5b with a vocabulary of 1000 (250 a rank) on a
    fake 1 x 4 mesh: a train step's collectives (forward and backward)
    carry no dimension of 1000 or 250; the whole-row softmax gathered the
    logits (B, S, 1000)."""
    cfg = dataclasses.replace(ARCHS["qwen1.5-0.5b"].reduced(), vocab_size=1000)
    fake_group(4)
    mesh = dryrun.dryrun_mesh((1, 4), AXES)
    bundle = steps.build_step(cfg, _small("train_4k"), mesh)
    spy = _Collectives()
    with mesh, implicit_replication(), steps.fake_mode(bundle.args), spy:
        bundle.fn(*counter.placed_args(bundle))
    assert spy.shapes
    assert not [s for s in spy.shapes if 1000 in s or 250 in s], spy.shapes


# --------------------------------------------------------------------------
# A whole train step's gradients on a 2 x 2 mesh
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["qwen1.5-0.5b", "rwkv6-7b"])
def test_train_step_gradients_on_a_mesh_are_the_unsharded_steps(monkeypatch, name):
    """One train step (two microbatches, remat) of the reduced arch,
    float32, with its parameters in the rules' layout on a 2 x 2 mesh
    and the batch split over 'data': the loss, the gradient norm, every
    gradient leaf handed to AdamW and every updated parameter equal the
    unsharded step's on every rank (AdamW's first update, about
    ``lr * sign(g)``, would magnify rounding where g is near its eps, so
    the updated parameters are only held to be DTensors).  Parameters
    replicated over 'data' whose gradient each rank builds from its own batch shard only (the
    vocabulary-split embedding, rwkv6's low-rank decay and bonus ``u`` on
    local shards) must come out summed over 'data'."""
    from repro_torch.training import train_loop

    cfg = ARCHS[name].reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu", dtype=torch.float32)
    batch = make_train_batch(cfg, 4, 16, seed=5, device="cpu")
    tcfg = train_loop.TrainConfig(n_microbatches=2)
    grads_seen = {}           # by thread: each rank runs on its own
    update = train_loop.adamw_update

    def spy(grads, *a, **k):
        grads_seen[threading.get_ident()] = grads
        return update(grads, *a, **k)

    monkeypatch.setattr(train_loop, "adamw_update", spy)

    def run(params, batch):
        step = train_loop.make_train_step(cfg, tcfg)
        new_params, _, metrics = step(params, train_loop.init_train_state(cfg, tcfg, params), batch)
        return new_params, metrics, grads_seen.pop(threading.get_ident())

    want_params, want_metrics, want_grads = run(params, batch)

    def rank(_):
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=AXES)
        with mesh, implicit_replication():
            pd = shd.distribute(params, mesh, shd.param_shardings(cfg, mesh, params))
            bd = shd.distribute(batch, mesh, shd.batch_shardings(cfg, mesh, batch))
            new_params, metrics, grads = run(pd, bd)
            whole = lambda tree: {p: t.full_tensor() for p, t in leaves_with_paths(tree)}
            assert all(isinstance(t, DTensor) for _, t in leaves_with_paths(new_params))
            return {k: v.full_tensor() for k, v in metrics.items()}, whole(grads)

    want_grads = dict(leaves_with_paths(want_grads))
    for metrics, grads in run_ranks(4, rank):
        for k in ("loss", "grad_norm"):
            _close(metrics[k], want_metrics[k], 1e-5)
        assert grads.keys() == want_grads.keys()
        for path, g in grads.items():
            _close(g, want_grads[path], 1e-4)


# --------------------------------------------------------------------------
# Moving a split between dimensions
# --------------------------------------------------------------------------
def test_relayout_is_redistribute_on_a_host_mesh():
    """On a 2 x 2 host mesh, moving 'model''s split of x (4, 6, 8) from
    dimension 1 to 2 by ``relayout``'s all-to-all gives every rank the
    shard ``redistribute`` gives it, bit for bit, and x's gradient back
    in x's layout; likewise beside a pending sum over 'data', whose
    gradient comes back whole on every rank."""
    from torch.distributed.tensor import Partial

    from repro_torch.models.sharding_utils import relayout

    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((4, 6, 8)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((4, 6, 8)).astype(np.float32))

    def rank(_):
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=AXES)
        xd = distribute_tensor(x, mesh, [Shard(0), Shard(1)]).requires_grad_(True)
        want = xd.detach().redistribute(mesh, [Shard(0), Shard(2)])
        got = relayout(xd, [Shard(0), Shard(2)])
        assert got.placements == want.placements and torch.equal(got.to_local(), want.to_local())
        (got * distribute_tensor(w, mesh, [Shard(0), Shard(2)])).sum().backward()
        assert xd.grad.placements == xd.placements
        local = xd.detach().to_local().clone().requires_grad_(True)
        pending = DTensor.from_local(local, mesh, [Partial(), Shard(1)], run_check=False)
        moved = relayout(pending, [Partial(), Shard(2)])
        assert moved.placements == (Partial(), Shard(2))
        assert torch.equal(moved.to_local(), pending.redistribute(mesh, [Partial(), Shard(2)]).to_local())
        (moved * distribute_tensor(w[:2], mesh, [Replicate(), Shard(2)])).sum().backward()
        return xd.grad.full_tensor(), local.grad

    for r, (grad, pending_grad) in enumerate(run_ranks(4, rank)):
        assert torch.equal(grad, w)
        assert torch.equal(pending_grad, w[:2, 3 * (r % 2):3 * (r % 2) + 3])


def test_counter_files_a_card_meshs_shard_move_as_the_host_all_to_all(fake_group):
    """The dry run counts on a host mesh, where ``relayout`` issues the
    all-to-all itself; on a card mesh DTensor issues
    ``_dtensor.shard_dim_alltoall`` for the same move.  The counter files
    both as one all-to-all of the same bytes."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed import _functional_collectives as funcol

    from repro_torch.models.sharding_utils import relayout

    fake_group(2)
    mesh = dryrun.dryrun_mesh((2,), ("model",))
    counts = []
    with FakeTensorMode():
        x = torch.empty(4, 6)
        for move in (
            lambda: relayout(DTensor.from_local(x, mesh, [Shard(0)], run_check=False), [Shard(1)]),
            lambda: torch.ops._dtensor.shard_dim_alltoall(x, 0, 1, funcol._resolve_group_name((mesh, 0))),
        ):
            spy = counter._Counter(True)
            with spy:
                move()
            counts.append((spy.collective_ops, spy.collective_bytes))
    assert counts[0] == counts[1]
    assert counts[0][0]["all-to-all"] == 1 and counts[0][1]["all-to-all"] == 4 * 6 * 4
    assert sum(counts[0][0].values()) == 1


# --------------------------------------------------------------------------
# Expert-parallel MoE dispatch
# --------------------------------------------------------------------------
MOE_LAYOUTS = {
    # case -> (experts, weight_gather, the reference's spec of xe (G, E, C, D))
    "experts-over-data": (4, False, JP(None, "data", None, None)),
    "d_ff-inside-experts": (3, False, JP("data", None, None, None)),
    "weight-gather": (4, True, JP(None, "model", "data", None)),
}


@pytest.mark.parametrize("case", list(MOE_LAYOUTS))
def test_moe_dispatch_keeps_the_reference_layout(monkeypatch, case):
    """Reduced llama4's MoE layer on a 2 x 2 mesh, tokens split over 'data',
    two experts a token (with one, the renormalised gate is 1 and the
    router's gradient is rounding noise), its 8 groups in chunks of 2
    (each chunk takes its groups from every rank's own), in each of the
    rules' layouts:
    4 experts split over 'data' as llama4's; 3, which no axis divides, so
    each expert splits d_model over 'data' and d_ff over 'model' (grok-1's
    layout on 16 x 16); and ``weight_gather``.  The dispatched tokens (G,
    E, C, D) hold the reference's shard shape on every rank (the expert
    stack's split of E, the groups' split otherwise, or the pinned
    ``(None, "model", "data", None)``), and the layer's output and
    gradients equal the unsharded layer's."""
    n_experts, weight_gather, spec = MOE_LAYOUTS[case]
    cfg = dataclasses.replace(ARCHS["llama4-maverick-400b-a17b"].reduced(), n_experts=n_experts)
    d, f, e, k = cfg.d_model, cfg.d_ff, cfg.n_experts, 2
    p = moe_mod.moe_init(torch.Generator().manual_seed(0), d, f, e, torch.float32, "cpu")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((4, 64, d)).astype(np.float32))
    kw = dict(k=k, capacity_factor=1.0, group_size=32, scan_group_chunk=2, weight_gather=weight_gather)
    xw = x.clone().requires_grad_(True)
    pw = {n: t.clone().requires_grad_(True) for n, t in p.items()}
    want = moe_mod.moe_ffn(xw, pw, **kw).y
    want.square().sum().backward()
    seen = []
    layout = moe_mod._expert_layout
    monkeypatch.setattr(moe_mod, "_expert_layout", lambda *a: seen.append(layout(*a)) or seen[-1])
    specs = shd.param_specs(cfg, MeshView({"data": 2, "model": 2}, AXES), {"layers": [{}, {"moe": p}]})

    def rank(_):
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=AXES)
        with mesh, implicit_replication():
            pd = {n: distribute_tensor(t, mesh, list(shd.placements(specs["layers"][1]["moe"][n], mesh)))
                  .detach().requires_grad_(True) for n, t in p.items()}
            xd = distribute_tensor(x, mesh, [Shard(0), Replicate()]).detach().requires_grad_(True)
            y = moe_mod.moe_ffn(xd, pd, **kw).y
            y.square().sum().backward()
            return (y.full_tensor(), xd.grad.full_tensor(),
                    {n: t.grad.full_tensor() for n, t in pd.items()})

    results = run_ranks(4, rank)
    want_shape = NamedSharding(AbstractMesh((2, 2), AXES), spec).shard_shape(tuple(seen[0].shape))
    assert len(seen) == 4 * 4 and all(tuple(t.to_local().shape) == want_shape for t in seen)   # ranks x chunks
    for y, gx, gp in results:
        _close(y, want.detach(), 1e-5)
        _close(gx, xw.grad, 1e-5)
        for n in p:
            _close(gp[n], pw[n].grad, 1e-5)


# --------------------------------------------------------------------------
# Prefill caches in the reference's layout; decode on them
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["qwen1.5-0.5b", "gemma3-1b"])
def test_prefill_and_decode_on_split_caches_are_the_unsharded_steps(name):
    """A prompt of 24 positions into caches of 32 slots (gemma3-1b's
    windowed layers: rings of 16, seeded from the prompt's last 16), then
    two decode steps, float32, on a 2 x 2 mesh: every full-size cache is
    split over the sequence on 'model', and the logits and caches equal
    the unsharded steps'."""
    cfg = ARCHS[name].reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu", dtype=torch.float32)
    batch = make_train_batch(cfg, 2, 24, seed=3, device="cpu")
    batch.pop("labels")
    tokens = [torch.tensor([[5], [7]]), torch.tensor([[11], [13]])]

    def run(params, batch, lift=lambda t: t):
        logits, caches = prefill_step(cfg, params, batch, max_len=32)
        outs = [logits]
        for i, tok in enumerate(tokens):
            logits, caches = decode_step(cfg, params, caches, lift(tok), 24 + i)
            outs.append(logits)
        return outs, caches

    want, want_caches = run(params, batch)

    def rank(_):
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=AXES)
        with mesh, implicit_replication():
            pd = shd.distribute(params, mesh, shd.param_shardings(cfg, mesh, params))
            bd = shd.distribute(batch, mesh, shd.batch_shardings(cfg, mesh, batch))
            outs, caches = run(pd, bd, lambda t: distribute_tensor(t, mesh, [Shard(0), Replicate()]))
            split = [c["k"].placements for c in caches]
            return [o.full_tensor() for o in outs], [{n: t.full_tensor() for n, t in c.items()} for c in caches], split

    for outs, caches, split in run_ranks(4, rank):
        assert all(pl[1] == Shard(1) for pl in split), split
        for got, w in zip(outs, want):
            _close(got, w, 1e-5)
        for got, w in zip(caches, want_caches):
            for n in w:
                _close(got[n], w[n], 1e-5)


# --------------------------------------------------------------------------
# hymba's scan, counted with a multiplicity
# --------------------------------------------------------------------------
@pytest.mark.parametrize("shape_name", ["train_4k", "prefill_32k"])
def test_hymba_scan_counts_as_its_whole_loop(monkeypatch, shape_name):
    """Reduced hymba at S = 64: the counter's FLOPs, bytes and collectives
    with the scan's middle step repeated equal those of the whole
    token-by-token loop, and the repeated regions are reported as
    trip-counted loops (forward, recomputed forward and backward of each
    layer in training)."""
    cfg = ARCHS["hymba-1.5b"].reduced()
    assert not cfg.use_chunked_scan
    shape = dataclasses.replace(INPUT_SHAPES[shape_name], seq_len=64, global_batch=2)
    bundle = steps.build_step(cfg, shape, ONE)
    got, got_memory = counter.count(bundle)
    monkeypatch.setattr(ssm_mod, "is_fake", lambda t: False)
    want, want_memory = counter.count(bundle)
    assert (got.flops, got.bytes_accessed, got.collective_bytes) == (
        want.flops, want.bytes_accessed, want.collective_bytes)
    assert got.flops > 0 and want.trip_counted_whiles == 0
    regions_per_layer = 3 * bundle.train_config.n_microbatches if shape_name == "train_4k" else 1
    assert got.trip_counted_whiles == cfg.n_layers * regions_per_layer
    assert got_memory["output_bytes"] == want_memory["output_bytes"]


@pytest.mark.parametrize("shape_name", ["train_4k", "prefill_32k"])
def test_hymba_scan_peak_is_its_whole_loops(monkeypatch, shape_name):
    """Reduced hymba at S = 64: the counted scan's peak holds what the
    token-by-token loop holds (every step's saved states and outputs), not
    less and within 1% more."""
    cfg = ARCHS["hymba-1.5b"].reduced()
    shape = dataclasses.replace(INPUT_SHAPES[shape_name], seq_len=64, global_batch=2)
    bundle = steps.build_step(cfg, shape, ONE)
    _, got = counter.count(bundle)
    monkeypatch.setattr(ssm_mod, "is_fake", lambda t: False)
    _, want = counter.count(bundle)
    assert want["peak_bytes"] <= got["peak_bytes"] <= 1.01 * want["peak_bytes"], (got, want)


@pytest.mark.parametrize("kept", [True, False])
def test_repeated_region_charges_what_it_keeps_n_times(kept):
    """A storage allocated inside ``repeated(5)`` and kept past it is
    charged 5 times; one freed inside it once; a carry once, and 5 times
    only if it outlives ``settle``."""
    c = counter._Counter(sharded=False)
    n = 4 * 256                                      # bytes of one tensor below
    with c:
        base = c.live
        with counter.repeated(5) as region:
            tmp = torch.ones(256)
            out = tmp * 2
            carry = out + 1
            del tmp
            region.carry(carry)
            assert c.peak - base == 3 * n
        assert c.live - base == (5 + 1) * n          # out 5 times, the carry once
        peak = c.peak
        if not kept:
            del carry
        region.settle()
        assert c.live - base == (5 + (5 if kept else 0)) * n
        assert c.peak == (peak if not kept else base + 10 * n)
        del out
        assert c.live - base == (5 if kept else 0) * n
    assert counter.open_regions() == 0


def test_scan_region_out_of_order_raises():
    """The backward region's markers refuse a bracket the engine did not
    make: a close with no open region, and a region opened twice."""
    h = torch.ones(2, 3, requires_grad=True)
    with pytest.raises(RuntimeError, match="out of order"):
        ssm_mod._Close.apply(ssm_mod._Region(5), h).sum().backward()
    region = ssm_mod._Region(5)
    a, _ = ssm_mod._Open.apply(region, h, h)
    b, _ = ssm_mod._Open.apply(region, a, h)
    with pytest.raises(RuntimeError, match="opens twice"):
        b.sum().backward()
    del counter._REPEATS[1:]
