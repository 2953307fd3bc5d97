"""Step builders: (step_fn, abstract inputs, in/out placements) per
(arch x input-shape), shared by the roofline counter, the chip smoke run
and the launchers.

Port of the JAX package's ``launch/steps.py``.  ``train_config_for`` is the
reference's production training setup: parameters in ``DEFAULT_DTYPE``
(bfloat16), Adam moments in bfloat16 above ``BIG_MODEL_PARAMS``, one
microbatch per batch shard, remat with the arch's policy.

The abstract arguments are fake tensors (``FakeTensorMode``), the
counterpart of ``jax.eval_shape``: shapes and dtypes, no storage, so a
full-size grok-1 or llama4 bundle allocates nothing.  They are on the card
for a ``DeviceMesh`` of type ``"cuda"`` and on the host for any other mesh
(a ``"cpu"`` one, or a stand-in with ``.shape`` and ``.axis_names``).  All
the fake tensors of one arch and device share one mode, which ``fake_mode``
returns; code that runs a bundle's ``fn`` on them enters it.  Token ids
are ``TOKEN_DTYPE`` (int64, torch's index type) where the reference's are
int32.  ``materialize`` makes concrete arguments of the same shapes and
dtypes.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.device import resolve_device
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import batch_axes, mesh_view
from repro_torch.models.frontend import EMBED_DTYPE, decode_token_specs, train_input_specs
from repro_torch.models.transformer import (
    DEFAULT_DTYPE,
    decode_step,
    init_decode_caches,
    init_params,
    prefill_step,
)
from repro_torch.training.optimizer import AdamWConfig, adamw_init
from repro_torch.training.train_loop import TrainConfig, make_train_step
from repro_torch.training.tree import leaves_with_paths, tree_unflatten

BIG_MODEL_PARAMS = 50e9  # above this, keep Adam moments in bf16


@dataclasses.dataclass
class StepBundle:
    """Everything needed to run or count one step: the reference's fields
    (placements in place of shardings), then what ``materialize`` needs."""

    fn: Callable
    args: tuple            # abstract (fake tensor) arguments
    in_placements: tuple
    out_placements: Any
    donate_argnums: tuple = ()
    description: str = ""
    cfg: ArchConfig | None = None
    shape: InputShape | None = None
    mesh: Any = None
    train_config: TrainConfig | None = None


def _fake_device(mesh) -> str:
    """Where a bundle on ``mesh`` keeps its abstract arguments."""
    return "cuda" if isinstance(mesh, DeviceMesh) and mesh.device_type == "cuda" else "cpu"


def _on(tree: Any, device: str) -> Any:
    """Fake tensors of ``tree``'s shapes and dtypes on ``device``, made
    afresh (a fake tensor cannot be moved to a device that the running
    torch was built without, as a host build lacks the card)."""
    if device == "cpu":
        return tree
    return tree_unflatten(tree, [
        torch.empty(t.shape, dtype=t.dtype, device=device) for _, t in leaves_with_paths(tree)
    ])


@functools.cache
def _abstract_params(cfg: ArchConfig, device: str = "cpu"):
    """The parameters of ``cfg`` as fake tensors on ``device``, in a mode
    of their own that the arch's other abstract arguments share."""
    with FakeTensorMode():
        return _on(init_params(cfg, torch.Generator().manual_seed(0), device="cpu"), device)


def fake_mode(tree: Any) -> FakeTensorMode:
    """The mode of the fake tensors in ``tree``."""
    for _, leaf in leaves_with_paths(tree):
        if isinstance(leaf, FakeTensor):
            return leaf.fake_mode
    raise ValueError("no fake tensor in the tree")


def _abstract(mode: FakeTensorMode, specs: Any, device: str) -> Any:
    """Fake tensors of ``specs``' shapes and dtypes on ``device``."""
    with mode:
        return tree_unflatten(specs, [
            torch.empty(s.shape, dtype=s.dtype, device=device) for _, s in leaves_with_paths(specs)
        ])


def _n_batch_shards(mesh, cfg: ArchConfig | None = None) -> int:
    mesh = mesh_view(mesh)
    axes = shd.batch_axes_for(cfg, mesh) if cfg is not None else batch_axes(mesh)
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def train_config_for(cfg: ArchConfig, shape: InputShape, mesh) -> TrainConfig:
    n_shards = _n_batch_shards(mesh, cfg)
    n_micro = max(shape.global_batch // n_shards, 1)
    moments = (
        torch.bfloat16 if cfg.param_count() > BIG_MODEL_PARAMS else torch.float32
    )
    return TrainConfig(
        optimizer=AdamWConfig(moments_dtype=moments),
        n_microbatches=n_micro,
        remat=True,
        remat_policy=cfg.remat_policy,
    )


def build_train(cfg: ArchConfig, shape: InputShape, mesh) -> StepBundle:
    tcfg = train_config_for(cfg, shape, mesh)
    # The parameters and state are donated (``donate_argnums``): as XLA
    # aliases the reference's donated buffers to its outputs, the step
    # writes the new values into the tensors it is given.
    step = make_train_step(cfg, tcfg, donate=True)

    device = _fake_device(mesh)
    params_sds = _abstract_params(cfg, device)
    mode = fake_mode(params_sds)
    with mode:
        opt_sds = adamw_init(params_sds, tcfg.optimizer)
    batch_sds = _abstract(mode, train_input_specs(cfg, shape.global_batch, shape.seq_len), device)

    p_shard = shd.param_shardings(cfg, mesh, params_sds)
    o_shard = shd.opt_state_shardings(cfg, mesh, opt_sds)
    b_shard = shd.batch_shardings(cfg, mesh, batch_sds)
    metrics_shard = {
        "loss": shd.replicated(mesh),
        "grad_norm": shd.replicated(mesh),
    }
    out_shard = (p_shard, o_shard, metrics_shard)

    def fn(params, opt_state, batch, lr_scale=1.0):
        return shd.lay_out(step(params, opt_state, batch, lr_scale), out_shard)

    return StepBundle(
        fn=fn,
        args=(params_sds, opt_sds, batch_sds),
        in_placements=(p_shard, o_shard, b_shard),
        out_placements=out_shard,
        donate_argnums=(0, 1),
        description=f"train_step[{cfg.name} x {shape.name}] "
        f"(micro={tcfg.n_microbatches})",
        cfg=cfg, shape=shape, mesh=mesh, train_config=tcfg,
    )


def build_prefill(cfg: ArchConfig, shape: InputShape, mesh) -> StepBundle:
    device = _fake_device(mesh)
    params_sds = _abstract_params(cfg, device)
    mode = fake_mode(params_sds)
    specs = train_input_specs(cfg, shape.global_batch, shape.seq_len)
    specs.pop("labels")
    batch_sds = _abstract(mode, specs, device)

    with mode:
        caches_sds = _on(init_decode_caches(cfg, shape.global_batch, shape.seq_len, device="cpu"), device)
    p_shard = shd.param_shardings(cfg, mesh, params_sds)
    b_shard = shd.batch_shardings(cfg, mesh, batch_sds)
    c_shard = shd.cache_shardings(cfg, mesh, caches_sds)
    logits_shape = (shape.global_batch, 1, cfg.vocab_size)
    vocab_ax = None if cfg.parallelism == "fsdp" else "model"
    logits_shard = shd.placements(
        shd._sanitize(
            shd.P(shd.batch_axes_for(cfg, mesh), None, vocab_ax), logits_shape, mesh_view(mesh)
        ),
        mesh,
    )

    def fn(params, batch):
        out = prefill_step(cfg, params, batch, max_len=shape.seq_len)
        return shd.lay_out(out, (logits_shard, c_shard))

    return StepBundle(
        fn=fn,
        args=(params_sds, batch_sds),
        in_placements=(p_shard, b_shard),
        out_placements=(logits_shard, c_shard),
        description=f"prefill_step[{cfg.name} x {shape.name}]",
        cfg=cfg, shape=shape, mesh=mesh,
    )


def build_decode(cfg: ArchConfig, shape: InputShape, mesh) -> StepBundle:
    device = _fake_device(mesh)
    params_sds = _abstract_params(cfg, device)
    mode = fake_mode(params_sds)
    with mode:
        caches_sds = _on(init_decode_caches(cfg, shape.global_batch, shape.seq_len, device="cpu"), device)
        len_sds = torch.empty((), dtype=torch.int32, device=device)
    tok_sds = _abstract(mode, {"tokens": decode_token_specs(cfg, shape.global_batch)}, device)["tokens"]

    view = mesh_view(mesh)
    p_shard = shd.param_shardings(cfg, mesh, params_sds)
    c_shard = shd.cache_shardings(cfg, mesh, caches_sds)
    b = shape.global_batch
    baxes = shd.batch_axes_for(cfg, mesh)
    t_spec = (
        shd.P(baxes, None)
        if b % _n_batch_shards(mesh, cfg) == 0
        else shd.P(None, None)
    )
    if cfg.frontend == "audio":
        t_spec = shd.P(*t_spec, None)
    t_shard = shd.placements(t_spec, mesh)
    l_shard = shd.replicated(mesh)
    vocab_ax = None if cfg.parallelism == "fsdp" else "model"
    logits_spec = (
        shd.P(baxes, None, vocab_ax)
        if b % _n_batch_shards(mesh, cfg) == 0
        else shd.P(None, None, vocab_ax)
    )
    logits_spec = shd._sanitize(logits_spec, (b, 1, cfg.vocab_size), view)
    out_shard = (shd.placements(logits_spec, mesh), c_shard)

    def fn(params, caches, tokens, cur_len):
        return shd.lay_out(decode_step(cfg, params, caches, tokens, int(cur_len)), out_shard)

    return StepBundle(
        fn=fn,
        args=(params_sds, caches_sds, tok_sds, len_sds),
        in_placements=(p_shard, c_shard, t_shard, l_shard),
        out_placements=out_shard,
        donate_argnums=(1,),
        description=f"decode_step[{cfg.name} x {shape.name}]",
        cfg=cfg, shape=shape, mesh=mesh,
    )


def build_step(cfg: ArchConfig, shape: InputShape, mesh) -> StepBundle:
    if shape.kind == "train":
        return build_train(cfg, shape, mesh)
    if shape.kind == "prefill":
        return build_prefill(cfg, shape, mesh)
    if shape.kind == "decode":
        return build_decode(cfg, shape, mesh)
    raise ValueError(shape.kind)


# --------------------------------------------------------------------------
# Concrete arguments
# --------------------------------------------------------------------------
def _draw(cfg: ArchConfig, like: torch.Tensor, generator: torch.Generator, dev: torch.device) -> torch.Tensor:
    """Random inputs of ``like``'s shape and dtype on ``dev``, drawn on the
    generator's device: embeddings standard normal, token ids uniform over
    the vocabulary."""
    if like.dtype == EMBED_DTYPE:
        x = torch.randn(like.shape, generator=generator, device=generator.device)
        return x.to(device=dev, dtype=EMBED_DTYPE)
    x = torch.randint(0, cfg.vocab_size, like.shape, generator=generator, device=generator.device, dtype=like.dtype)
    return x.to(dev)


def materialize(bundle: StepBundle, generator: torch.Generator, device: "str | torch.device" = "cuda") -> tuple:
    """Concrete arguments for ``bundle.fn`` on ``device``, of the abstract
    arguments' shapes and dtypes: parameters from ``init_params``, the
    optimizer state from ``adamw_init``, random batches and tokens, empty
    decode caches at position 0, all drawn from ``generator``.  They are
    plain tensors when every mesh axis has size 1, and DTensors under the
    bundle's placements on its ``DeviceMesh`` otherwise."""
    cfg, shape, dev = bundle.cfg, bundle.shape, resolve_device(device)
    params = init_params(cfg, generator, device=dev, dtype=DEFAULT_DTYPE)
    if shape.kind == "train":
        batch = {k: _draw(cfg, v, generator, dev) for k, v in bundle.args[2].items()}
        args = (params, adamw_init(params, bundle.train_config.optimizer), batch)
    elif shape.kind == "prefill":
        args = (params, {k: _draw(cfg, v, generator, dev) for k, v in bundle.args[1].items()})
    else:
        caches = init_decode_caches(cfg, shape.global_batch, shape.seq_len, device=dev)
        tokens = _draw(cfg, bundle.args[2], generator, dev)
        args = (params, caches, tokens, torch.zeros((), dtype=torch.int32, device=dev))
    for got, want in zip(leaves_with_paths(args), leaves_with_paths(bundle.args), strict=True):
        if got[1].shape != want[1].shape or got[1].dtype != want[1].dtype:
            raise AssertionError(f"{got[0]}: {tuple(got[1].shape)} {got[1].dtype} for "
                                 f"{tuple(want[1].shape)} {want[1].dtype}")
    if all(n == 1 for n in mesh_view(bundle.mesh).shape.values()):
        return args
    return tuple(shd.distribute(a, bundle.mesh, p) for a, p in zip(args, bundle.in_placements))
