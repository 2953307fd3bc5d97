"""The port's meshes, sharding rules and activation constraints against the
JAX package's.

* C6: the package surfaces import in a fresh interpreter without JAX.
* Spec parity: for every architecture at full size, every leaf of the
  port's parameter and optimizer trees (fake tensors) gets the spec the
  reference's ``param_shardings`` / ``opt_state_shardings`` give the
  matching leaf of its stacked tree (``jax.eval_shape``), with the stacked
  axis's entry dropped; on 16x16 and 2x16x16 meshes (and grok-1's 32x8,
  which takes its experts over 'model'), under tensor parallelism and,
  for rwkv6-7b, FSDP as the reference's dry run sets it.  The reference
  runs on a JAX ``AbstractMesh``, the port on the stand-in mesh of
  ``tests/test_sharding_rules.py``.  Batch and decode-cache specs likewise.
* ``placements`` on a 512-rank ``DeviceMesh`` over a fake process group.
* ``constrain`` with and without a mesh.
* A forward and its gradient with every parameter and the batch as
  DTensors on a 1x1 gloo mesh (``make_host_mesh``, over an in-process
  store) against the unsharded port and the reference's ``forward_loss``,
  for the archs of the reference's ``test_forward_under_mesh``.

Each test that starts a process group destroys it.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

from repro.configs import ARCHS as REF_ARCHS
from repro.launch import sharding as ref_shd
from repro.models import transformer as ref_tf
from repro.models.frontend import train_input_specs as ref_train_input_specs
from repro.training.optimizer import AdamWConfig as RefAdamWConfig
from repro.training.optimizer import adamw_init as ref_adamw_init
from repro_torch.configs import ARCHS
from repro_torch.launch import sharding as shd
from repro_torch.launch import steps
from repro_torch.launch.mesh import batch_axes, make_host_mesh, make_production_mesh, mesh_view
from repro_torch.models.frontend import train_input_specs
from repro_torch.models.sharding_utils import constrain
from repro_torch.models.transformer import forward_loss, init_decode_caches, params_from_jax
from repro_torch.training.optimizer import AdamWConfig, adamw_init
from repro_torch.training.tree import leaves_with_paths, tree_unflatten
from tests.test_sharding_rules import FakeMesh

B, S = 2, 24
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4      # tests/test_torch_forward_loss.py's
MESH_TOL = 1e-6                      # DTensor forward against the unsharded port

MESHES = {
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
    "32x8": {"data": 32, "model": 8},      # grok-1's experts over 'model' (the dry run's mesh)
}


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
    """A 1x1 mesh over a one-rank gloo group, destroyed afterwards."""
    assert not dist.is_initialized()
    mesh = make_host_mesh(1, 1, device="cpu")
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


def _env():
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ)
    env["PYTHONPATH"] = src + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return env


def test_package_surfaces_import_without_jax():
    """C6: ``forward_loss`` from ``repro_torch.models``, the profiler's names
    from ``repro_torch.profiler``, and this slice's modules, in a fresh
    interpreter with neither JAX nor the reference loaded."""
    code = (
        "import sys\n"
        "from repro_torch.models import forward_loss\n"
        "from repro_torch.profiler import SyntheticModelSpec, build_profile\n"
        "from repro_torch.launch import batch_axes, make_host_mesh, make_production_mesh\n"
        "import repro_torch.launch.sharding, repro_torch.launch.steps\n"
        "import repro_torch.models.sharding_utils\n"
        "from repro_torch.roofline import analyze_compiled, model_flops\n"
        "import repro_torch.roofline.counter, repro_torch.roofline.report\n"
        "from repro_torch.hw import TPU_V5E, TPU_V5E_SERVING_PLATFORM, TPUChipSpec\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro'))\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, env=_env(), timeout=120)


# --------------------------------------------------------------------------
# Spec parity
# --------------------------------------------------------------------------
def _abstract_mesh(shape: dict) -> AbstractMesh:
    return AbstractMesh(tuple(shape.values()), tuple(shape))


def _norm(spec) -> tuple:
    """A spec as a tuple, one-name tuples as the name (JAX writes either)."""
    out = []
    for entry in spec:
        if isinstance(entry, tuple) and len(entry) == 1:
            entry = entry[0]
        out.append(entry if entry != () else None)
    return tuple(out)


def _ref_specs(tree) -> dict:
    """keystr -> spec of a tree of the reference's NamedShardings."""
    return {jax.tree_util.keystr(p): _norm(s.spec)
            for p, s in jax.tree_util.tree_leaves_with_path(tree)}


def _ref_path(path: str, cfg) -> tuple[str, bool]:
    """The reference's path of the port's leaf at ``path``: layer i is
    position i % group_size of its stacked groups."""
    if "['layers'][" not in path:
        return path, False
    head, rest = path.split("['layers'][", 1)
    i, tail = rest.split("]", 1)
    return f"{head}['groups'][{int(i) % cfg.group_size}]{tail}", True


def _expect(ref: dict, path: str, cfg) -> tuple:
    ref_path, stacked = _ref_path(path, cfg)
    spec = ref[ref_path]
    if stacked:
        assert spec[0] is None, (ref_path, spec)
        spec = spec[1:]
    return spec


SPEC_CASES = [(name, "tp", mesh) for name in ARCHS for mesh in ("16x16", "2x16x16")] + [
    ("rwkv6-7b", "fsdp", mesh) for mesh in ("16x16", "2x16x16")
] + [("grok-1-314b", "tp", "32x8")]


def _cfgs(name, parallelism):
    import dataclasses

    return (dataclasses.replace(REF_ARCHS[name], parallelism=parallelism),
            dataclasses.replace(ARCHS[name], parallelism=parallelism))


@pytest.mark.parametrize("name,parallelism,mesh_name", SPEC_CASES)
def test_param_and_moment_specs_are_the_references(name, parallelism, mesh_name):
    ref_cfg, cfg = _cfgs(name, parallelism)
    shape = MESHES[mesh_name]
    ref_params = jax.eval_shape(lambda: ref_tf.init_params(ref_cfg, jax.random.PRNGKey(0)))
    ref_opt = jax.eval_shape(lambda: ref_adamw_init(ref_params, RefAdamWConfig()))
    ref_p = _ref_specs(ref_shd.param_shardings(ref_cfg, _abstract_mesh(shape), ref_params))
    ref_o = _ref_specs(ref_shd.opt_state_shardings(ref_cfg, _abstract_mesh(shape), ref_opt))

    params = steps._abstract_params(cfg)
    with steps.fake_mode(params):
        opt = adamw_init(params, AdamWConfig())
    mesh = FakeMesh(dict(shape))
    got_p = dict(shd._spec_leaves(shd.param_specs(cfg, mesh, params)))
    got_o = dict(shd._spec_leaves(shd.opt_state_specs(cfg, mesh, opt)))
    assert len(got_p) == len(leaves_with_paths(params))
    for path, spec in got_p.items():
        assert _norm(spec) == _expect(ref_p, path, cfg), path
    for path, spec in got_o.items():
        assert _norm(spec) == _expect(ref_o, path, cfg), path
    # The rules took both of the reference's MoE splits where they apply.
    if name == "llama4-maverick-400b-a17b" and mesh_name == "16x16":
        assert got_p["['layers'][1]['moe']['w_in']"] == (("data", None, "model"))
    if name == "grok-1-314b":
        want = {"16x16": (None, "data", "model"), "32x8": ("model", None, "data")}.get(mesh_name)
        if want:
            assert got_p["['layers'][0]['moe']['w_in']"] == want


@pytest.mark.parametrize("name", list(ARCHS))
@pytest.mark.parametrize("mesh_name", ["16x16", "2x16x16"])
def test_batch_and_cache_specs_are_the_references(name, mesh_name):
    """Train batches of several sizes (the fallback of ``_best_batch_axes``:
    16 divides the 16 ranks of 'data' but not the 32 of ('pod', 'data'); 3
    divides neither) and decode caches (the sequence over 'model' where it
    divides)."""
    ref_cfg, cfg = REF_ARCHS[name], ARCHS[name]
    shape = MESHES[mesh_name]
    mesh = FakeMesh(dict(shape))
    for batch, seq in ((256, 4096), (16, 1024), (3, 512)):
        ref = _ref_specs(ref_shd.batch_shardings(ref_cfg, _abstract_mesh(shape),
                                                 ref_train_input_specs(ref_cfg, batch, seq)))
        got = dict(shd._spec_leaves(shd.batch_specs(cfg, mesh, train_input_specs(cfg, batch, seq))))
        assert {k: _norm(v) for k, v in got.items()} == ref, (batch, seq)
    for batch, max_len in ((128, 32768), (16, 1000), (3, 1000)):
        ref_caches = jax.eval_shape(lambda: ref_tf.init_decode_caches(ref_cfg, batch, max_len))
        ref = _ref_specs(ref_shd.cache_shardings(ref_cfg, _abstract_mesh(shape), ref_caches))
        params = steps._abstract_params(cfg)
        with steps.fake_mode(params):
            caches = init_decode_caches(cfg, batch, max_len, device="cpu")
        got = dict(shd._spec_leaves(shd.cache_specs(cfg, mesh, caches)))
        assert {k: _norm(v) for k, v in got.items()} == ref, (batch, max_len)


def test_batch_axes_and_batch_axes_for():
    single, multi = FakeMesh(dict(MESHES["16x16"])), FakeMesh(dict(MESHES["2x16x16"]))
    assert batch_axes(single) == ("data",)
    assert batch_axes(multi) == ("pod", "data")
    import dataclasses

    fsdp = dataclasses.replace(ARCHS["rwkv6-7b"], parallelism="fsdp")
    ref_fsdp = dataclasses.replace(REF_ARCHS["rwkv6-7b"], parallelism="fsdp")
    for mesh in (single, multi):
        assert shd.batch_axes_for(fsdp, mesh) == ref_shd.batch_axes_for(ref_fsdp, mesh)
        assert shd.batch_axes_for(ARCHS["qwen1.5-0.5b"], mesh) == ref_shd.batch_axes_for(
            REF_ARCHS["qwen1.5-0.5b"], mesh)


# --------------------------------------------------------------------------
# Meshes and placements
# --------------------------------------------------------------------------
def test_placements_on_a_512_rank_mesh():
    """The multi-pod mesh over a fake 512-rank group: its view, and a spec's
    placements, one per mesh axis in mesh order."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=512)
    try:
        mesh = make_production_mesh(multi_pod=True, device="cpu")
        view = mesh_view(mesh)
        assert view.shape == {"pod": 2, "data": 16, "model": 16}
        assert view.axis_names == ("pod", "data", "model")
        assert batch_axes(mesh) == ("pod", "data")
        assert shd.placements((("pod", "data"), None, "model"), mesh) == (Shard(0), Shard(0), Shard(2))
        assert shd.placements((None, "model"), mesh) == (Replicate(), Replicate(), Shard(1))
        assert shd.placements(("data", None), mesh) == (Replicate(), Shard(0), Replicate())
        assert shd.placements((("pod", "data", "model"),), mesh) == (Shard(0),) * 3
        assert shd.replicated(mesh) == (Replicate(),) * 3
        with pytest.raises(ValueError):
            shd.placements(("model", "model"), mesh)
    finally:
        dist.destroy_process_group()


def test_host_mesh(host_mesh):
    assert mesh_view(host_mesh).shape == {"data": 1, "model": 1}
    assert dist.get_world_size() == 1


def test_constrain_without_and_with_a_mesh(host_mesh):
    x = torch.randn(2, 3, 4)
    assert constrain(x, "batch", None, "model") is x          # no active mesh
    d = distribute_tensor(x, host_mesh, [Replicate(), Replicate()])
    assert constrain(d, "batch", None, "model") is d
    with host_mesh:
        assert constrain(x, "batch", None, "model") is x      # a plain tensor
        got = constrain(d, "batch", None, "model")
        assert got.placements == (Shard(0), Shard(2))
        assert constrain(d, "batch_full", None, None).placements == (Shard(0), Shard(0))
        assert constrain(d, None, "pod", None).placements == (Replicate(), Replicate())
    torch.testing.assert_close(got.full_tensor(), x, rtol=0, atol=0)


# --------------------------------------------------------------------------
# A forward under a mesh
# --------------------------------------------------------------------------
def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    return {
        "tokens": rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32),
        "labels": rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32),
    }


def _grads(cfg, params, batch):
    flat = leaves_with_paths(params)
    live = [p.detach().requires_grad_(True) for _, p in flat]
    loss, _ = forward_loss(cfg, tree_unflatten(params, live), batch)
    return loss, dict(zip([path for path, _ in flat], torch.autograd.grad(loss, live)))


@pytest.mark.parametrize("name", ["qwen1.5-0.5b", "grok-1-314b", "rwkv6-7b"])
def test_forward_under_a_host_mesh(host_mesh, name):
    """Reduced, float32: parameters and batch distributed under the rules'
    placements on the 1x1 mesh; the loss and every gradient leaf equal the
    unsharded port's (1e-6) and the reference's (its forward-loss test's
    tolerances)."""
    ref_cfg, cfg = REF_ARCHS[name].reduced(), ARCHS[name].reduced()
    ref_params = ref_tf.init_params(ref_cfg, jax.random.PRNGKey(7), dtype=jnp.float32)
    batch = _batch(cfg, seed=3)
    (ref_loss, _), ref_grads = jax.value_and_grad(
        lambda p: ref_tf.forward_loss(ref_cfg, p, {k: jnp.asarray(a) for k, a in batch.items()}), has_aux=True
    )(ref_params)
    ref_grads = dict(leaves_with_paths(params_from_jax(cfg, ref_grads)))
    params = params_from_jax(cfg, ref_params)
    tbatch = {k: torch.from_numpy(a).long() for k, a in batch.items()}
    loss, grads = _grads(cfg, params, tbatch)

    dparams = shd.distribute(params, host_mesh, shd.param_shardings(cfg, host_mesh, params))
    dbatch = shd.distribute(tbatch, host_mesh, shd.batch_shardings(cfg, host_mesh, tbatch))
    assert dparams["embed"].placements == (Replicate(), Shard(0))      # vocab on 'model'
    with host_mesh, implicit_replication():
        dloss, dgrads = _grads(cfg, dparams, dbatch)
    assert isinstance(dloss, DTensor)
    dloss = float(dloss.full_tensor().detach())
    assert dloss == pytest.approx(float(loss.detach()), rel=MESH_TOL)
    assert dloss == pytest.approx(float(ref_loss), rel=LOSS_TOL)
    for path, g in grads.items():
        got = dgrads[path].full_tensor()
        torch.testing.assert_close(got, g, rtol=MESH_TOL, atol=MESH_TOL * float(g.abs().max()), msg=path)
        want = ref_grads[path]
        assert float((got - want).norm() / want.norm().clamp_min(1e-30)) <= GRAD_TOL, path
