"""Sharding rules: parameter/optimizer/batch/cache specs and their DTensor
placements.

Port of the JAX package's ``launch/sharding.py``.  Baseline placement, as
the reference's:

* batch axes -> ('pod','data') [multi-pod] or ('data',);
* attention / MLP / RWKV / SSM matrices: column-shard the wide output dim on
  'model', row-shard the contraction dim of output projections on 'model';
* embeddings / lm_head: vocab on 'model';
* MoE expert tensors: expert axis on 'data' when divisible (expert
  parallelism -- llama4's 128 experts / 16), otherwise shard d_model on
  'data' and d_ff on 'model' (grok's 8 experts);
* KV caches: batch on the batch axes, the sequence on 'model' when it
  divides;
* optimizer moments follow their parameter's spec.

The rule bodies (``batch_axes_for``, ``_fsdp_spec``, ``_spec_for_param``,
``_sanitize``, ``_best_batch_axes`` and the cache rule) are the
reference's, line for line: they match substrings of tree-path strings
(``jax.tree_util.keystr``'s form), quirks included.  A spec is the
reference's ``PartitionSpec`` as a plain tuple, one entry per tensor
dimension: a mesh axis name, a tuple of names, or ``None``.

The reference's rules read paths of its *stacked* tree, where layer ``i``
is slice ``i // group_size`` of ``['groups'][i % group_size]...`` (leaf
shape ``(n_groups, ...)``); the port keeps one dict per layer under
``['layers'][i]``.  So each per-layer leaf is given to the rules under the
reference's path and stacked shape, and the stacked axis's entry (always
``None``) is dropped.  ``placements`` turns a spec into one DTensor
placement per mesh dimension, and ``distribute`` makes DTensors of a tree.

A mesh is anything with ``.shape`` (axis name -> size) and
``.axis_names``; a ``DeviceMesh`` is read through ``mesh_view``.
"""
from __future__ import annotations

import re
from typing import Any

from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.mesh import batch_axes, mesh_view
from repro_torch.training.tree import leaves_with_paths, tree_unflatten

Mesh = Any   # a DeviceMesh or any object with .shape and .axis_names


def P(*entries) -> tuple:
    """The reference's ``PartitionSpec(*entries)`` as a tuple."""
    return tuple(entries)


def _data_size(mesh: Mesh) -> int:
    return mesh.shape["data"]


def batch_axes_for(cfg: ArchConfig, mesh: Mesh) -> tuple[str, ...]:
    """FSDP shards the batch over every mesh axis; zero3/TP over pod/data."""
    mesh = mesh_view(mesh)
    if cfg.parallelism == "fsdp":
        return tuple(mesh.axis_names)
    return batch_axes(mesh)


def _fsdp_spec(path: str, leaf, mesh: Mesh) -> tuple:
    """ZeRO-3: shard each tensor's largest dim over ALL mesh axes."""
    stacked = "groups" in path
    shape = leaf.shape
    start = 1 if stacked else 0
    if leaf.ndim - start < 1:
        return P(*([None] * leaf.ndim))
    all_axes = tuple(mesh.axis_names)
    extent = 1
    for a in all_axes:
        extent *= mesh.shape[a]
    # Pick the largest divisible dim (prefer later dims on ties -- weight
    # matrices put d_model/d_ff there).
    best = None
    for i in range(start, leaf.ndim):
        if shape[i] % extent == 0 and (best is None or shape[i] >= shape[best]):
            best = i
    spec = [None] * leaf.ndim
    if best is not None:
        spec[best] = all_axes
    return P(*spec)


def _spec_for_param(path: str, leaf, cfg: ArchConfig, mesh: Mesh) -> tuple:
    """PartitionSpec for one parameter leaf (path = jax keystr)."""
    stacked = "groups" in path          # leading (n_groups,) axis
    lead: tuple = (None,) if stacked else ()

    def p(*axes):
        return P(*lead, *axes)

    nd = leaf.ndim - (1 if stacked else 0)

    # --- top-level ---------------------------------------------------------
    if "embed" in path:
        return P("model", None)
    if "lm_head" in path:
        return P(None, "model")
    if "frontend_proj" in path:
        return P(None, "model")
    if "final_norm" in path:
        return P(None)

    # --- MoE ---------------------------------------------------------------
    if "moe" in path:
        if "router" in path:
            return p(None, None)
        E = cfg.n_experts
        model_size = mesh.shape["model"]
        if E % _data_size(mesh) == 0:
            # Expert parallel over 'data' + d_ff over 'model' (llama4: 128e).
            if "w_out" in path:  # (E, F, D)
                return p("data", "model", None)
            return p("data", None, "model")
        if E % model_size == 0:
            # Expert parallel over 'model' + d_ff over 'data' -- reachable by
            # refactoring the logical mesh (grok: 8e on a 32x8 mesh).  The
            # contraction dim stays unsharded so the expert matmuls produce
            # no partial sums (no (G,E,C,F) all-reduce).
            if "w_out" in path:
                return p("model", "data", None)
            return p("model", None, "data")
        # Tensor-parallel fallback: shard inside each expert.
        if "w_out" in path:
            return p(None, "model", "data")
        return p(None, "data", "model")

    # --- attention -----------------------------------------------------------
    if "attn" in path:
        if path.endswith("['wo']"):
            return p("model", None)
        if "wq" in path or "wk" in path or "wv" in path:
            return p(None, "model")
        if "bq" in path or "bk" in path or "bv" in path:
            return p("model")
        return p(*([None] * nd))

    # --- RWKV ----------------------------------------------------------------
    if "rwkv" in path:
        if any(k in path for k in ("['wr']", "['wk']", "['wv']", "['wg']", "['ck']")):
            return p(None, "model")
        if "['wo']" in path or "['cv']" in path:
            return p("model", None)
        if "['cr']" in path:
            return p(None, "model")
        if "w_lora_a" in path:
            return p(None, None)
        if "w_lora_b" in path:
            return p(None, "model")
        return p(*([None] * nd))

    # --- SSM (hymba) -----------------------------------------------------------
    if "ssm" in path:
        if any(k in path for k in ("w_in", "w_gate", "w_dt")):
            return p(None, "model")
        if "w_out" in path:
            return p("model", None)
        return p(*([None] * nd))

    # --- dense MLP ---------------------------------------------------------------
    if "mlp" in path:
        if "w_out" in path:
            return p("model", None)
        return p(None, "model")

    # --- norms & anything else: replicate -------------------------------------
    return p(*([None] * nd))


def _sanitize(spec: tuple, shape: tuple[int, ...], mesh: Mesh) -> tuple:
    """Drop spec axes whose mesh extent doesn't divide the dim (jax requires
    divisible input shardings; e.g. hymba's vocab of 32001)."""
    out = []
    for i, entry in enumerate(spec):
        if entry is None or i >= len(shape):
            out.append(None if i >= len(shape) else entry)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        extent = 1
        for a in axes:
            extent *= mesh.shape[a]
        out.append(entry if shape[i] % extent == 0 else None)
    return P(*out)


def _best_batch_axes(
    preferred: tuple[str, ...], batch_dim: int, mesh: Mesh
) -> tuple[str, ...] | None:
    """Longest divisible suffix fallback: full axes, then drop leading axes
    until the batch dim divides (e.g. global_batch=32 on a 2x32x8 mesh:
    ('pod','data')=64 fails -> ('data',)=32 works).  Prevents the sanitizer
    from silently replicating the whole batch."""
    for start in range(len(preferred)):
        cand = preferred[start:]
        extent = 1
        for a in cand:
            extent *= mesh.shape[a]
        if extent and batch_dim % extent == 0:
            return cand
    return None


# --------------------------------------------------------------------------
# The port's trees under the reference's paths
# --------------------------------------------------------------------------
class _Leaf:
    """A leaf's shape as the rules read it (``.shape``, ``.ndim``)."""

    def __init__(self, shape):
        self.shape = tuple(shape)
        self.ndim = len(self.shape)


_LAYER = re.compile(r"\['layers'\]\[(\d+)\]")


def _reference_leaf(path: str, shape, cfg: ArchConfig) -> tuple[str, _Leaf, bool]:
    """The reference's path and leaf shape for the port's leaf at ``path``:
    ``['layers'][i]`` becomes ``['groups'][i % group_size]`` with a leading
    ``n_groups`` axis; returns (path, leaf, stacked)."""
    m = _LAYER.search(path)
    if m is None:
        return path, _Leaf(shape), False
    j = int(m.group(1)) % cfg.group_size
    ref = path[: m.start()] + f"['groups'][{j}]" + path[m.end():]
    return ref, _Leaf((cfg.n_groups, *shape)), True


def _unstack(spec: tuple, stacked: bool) -> tuple:
    if not stacked:
        return spec
    if spec[0] is not None:
        raise AssertionError(f"a stacked leaf's spec shards its layer axis: {spec}")
    return spec[1:]


def _param_spec(ref_path: str, leaf: _Leaf, cfg: ArchConfig, mesh: Mesh) -> tuple:
    if cfg.parallelism in ("fsdp", "zero3"):
        spec = _fsdp_spec(ref_path, leaf, mesh)
    else:
        spec = _spec_for_param(ref_path, leaf, cfg, mesh)
    return _sanitize(spec, leaf.shape, mesh)


def param_specs(cfg: ArchConfig, mesh: Mesh, params_like: Any) -> Any:
    """The spec of every leaf of the port's parameter tree (tensors, fake
    or real), as a tree of the same structure."""
    mesh = mesh_view(mesh)
    specs = []
    for path, leaf in leaves_with_paths(params_like):
        ref_path, ref_leaf, stacked = _reference_leaf(path, leaf.shape, cfg)
        specs.append(_unstack(_param_spec(ref_path, ref_leaf, cfg, mesh), stacked))
    return tree_unflatten(params_like, specs)


def opt_state_specs(cfg: ArchConfig, mesh: Mesh, opt_like: Any) -> Any:
    """Moments follow their parameter's spec; step is replicated."""
    mesh = mesh_view(mesh)
    specs = []
    for path, leaf in leaves_with_paths(opt_like):
        ref_path, ref_leaf, stacked = _reference_leaf(path, leaf.shape, cfg)
        if "step" in ref_path:
            specs.append(P())
            continue
        # the leading ['m'] / ['v'] container key stays in the path
        specs.append(_unstack(_param_spec(ref_path, ref_leaf, cfg, mesh), stacked))
    return tree_unflatten(opt_like, specs)


def batch_specs(cfg: ArchConfig, mesh: Mesh, batch_like: Any) -> Any:
    mesh = mesh_view(mesh)
    axes = batch_axes_for(cfg, mesh)

    def assign(leaf):
        best = _best_batch_axes(axes, leaf.shape[0], mesh)
        rest = (None,) * (leaf.ndim - 1)
        spec = P(best, *rest) if best else P(None, *rest)
        return _sanitize(spec, leaf.shape, mesh)

    return tree_unflatten(batch_like, [assign(leaf) for _, leaf in leaves_with_paths(batch_like)])


def cache_specs(cfg: ArchConfig, mesh: Mesh, caches_like: Any) -> Any:
    """Decode caches.

    KV caches (B, S, KV, hd): batch over the batch axes when divisible, and
    the *sequence* dim over 'model' when divisible -- KV-head counts rarely
    divide the model axis (grok kv=8 vs model=16), but the 32k/500k sequence
    always does, and seq-sharding is what keeps a 1 TB cache at ~4 GB/chip.
    Attention over a seq-sharded cache costs an all-gather of per-position
    logits (small at decode).  SSM/RWKV states: batch only.
    """
    mesh = mesh_view(mesh)
    axes = batch_axes_for(cfg, mesh)
    model_size = mesh.shape["model"]

    def assign(key, leaf):
        b = leaf.shape[0]
        batch_spec = _best_batch_axes(axes, b, mesh)
        is_kv = key.endswith("['k']") or key.endswith("['v']")
        if is_kv and leaf.ndim == 4:
            s = leaf.shape[1]
            seq_spec = "model" if s % model_size == 0 else None
            return _sanitize(P(batch_spec, seq_spec, None, None), leaf.shape, mesh)
        rest = (None,) * (leaf.ndim - 1)
        return _sanitize(P(batch_spec, *rest), leaf.shape, mesh)

    return tree_unflatten(caches_like, [assign(k, leaf) for k, leaf in leaves_with_paths(caches_like)])


# --------------------------------------------------------------------------
# DTensor placements
# --------------------------------------------------------------------------
def placements(spec: tuple, mesh: Mesh) -> tuple:
    """One DTensor placement per mesh axis: ``Shard(d)`` where tensor
    dimension d's entry names the axis, ``Replicate()`` otherwise.  A
    dimension split over several axes (``("pod", "data")``) is split in
    mesh order, major to minor, as JAX splits it for an entry in that
    order."""
    out = []
    for name in mesh_view(mesh).axis_names:
        dims = [d for d, entry in enumerate(spec)
                if entry == name or (isinstance(entry, tuple) and name in entry)]
        if len(dims) > 1:
            raise ValueError(f"mesh axis {name!r} shards dimensions {dims} of spec {spec}")
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def _spec_leaves(tree: Any, prefix: str = "") -> list[tuple[str, tuple]]:
    """``leaves_with_paths`` over a tree of specs or placements, whose
    leaves are tuples (the port's trees hold no tuples themselves)."""
    if isinstance(tree, dict):
        return [kv for key in sorted(tree) for kv in _spec_leaves(tree[key], f"{prefix}[{key!r}]")]
    if isinstance(tree, list):
        return [kv for i, sub in enumerate(tree) for kv in _spec_leaves(sub, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def _placements_like(like: Any, specs: Any, mesh: Mesh) -> Any:
    return tree_unflatten(like, [placements(s, mesh) for _, s in _spec_leaves(specs)])


def param_shardings(cfg: ArchConfig, mesh: Mesh, params_like: Any) -> Any:
    """Placements for every parameter leaf, as a tree of the port's."""
    return _placements_like(params_like, param_specs(cfg, mesh, params_like), mesh)


def opt_state_shardings(cfg: ArchConfig, mesh: Mesh, opt_like: Any) -> Any:
    """Moments follow their parameter's placements; step is replicated."""
    return _placements_like(opt_like, opt_state_specs(cfg, mesh, opt_like), mesh)


def batch_shardings(cfg: ArchConfig, mesh: Mesh, batch_like: Any) -> Any:
    return _placements_like(batch_like, batch_specs(cfg, mesh, batch_like), mesh)


def cache_shardings(cfg: ArchConfig, mesh: Mesh, caches_like: Any) -> Any:
    return _placements_like(caches_like, cache_specs(cfg, mesh, caches_like), mesh)


def replicated(mesh: Mesh) -> tuple:
    return placements(P(), mesh)


def distribute(tree: Any, mesh, placements_tree: Any) -> Any:
    """DTensors of ``tree``'s tensors on the ``DeviceMesh`` ``mesh``, each
    under its placements in ``placements_tree`` (a tree of the same
    structure)."""
    flat = leaves_with_paths(tree)
    places = [p for _, p in _spec_leaves(placements_tree)]
    if len(places) != len(flat):
        raise ValueError(f"{len(flat)} tensors but {len(places)} placements")
    return tree_unflatten(tree, [
        distribute_tensor(t, mesh, list(pl)) for (_, t), pl in zip(flat, places)
    ])


def lay_out(outputs: tuple, placements_trees: tuple) -> tuple:
    """A step's ``outputs`` with each DTensor leaf under its placements in
    ``placements_trees`` (one tree per output, of the output's structure),
    as the reference's ``jit`` lays out a step's outputs under
    ``out_shardings``; plain tensors pass as they are."""
    from repro_torch.models.sharding_utils import _is_dtensor, relayout

    out = []
    for tree, placements_tree in zip(outputs, placements_trees, strict=True):
        flat = leaves_with_paths(tree)
        places = [p for _, p in _spec_leaves(placements_tree)]
        if len(places) != len(flat):
            raise ValueError(f"{len(flat)} tensors but {len(places)} placements")
        out.append(tree_unflatten(tree, [
            relayout(t, pl) if _is_dtensor(t) else t for (_, t), pl in zip(flat, places)
        ]))
    return tuple(out)
