"""Activation sharding constraints inside model code.

Port of the JAX package's ``models/sharding_utils.py``.  ``constrain`` pins
an activation to a batch-sharded layout whenever a mesh is active (entered
with ``with mesh:``), and is a no-op otherwise: with no mesh, or on a
plain tensor, it returns its input itself.  On a DTensor it redistributes
to the placements its spec tokens resolve to.

Spec tokens: 'batch' expands to the mesh's batch axes (('pod','data') on
the multi-pod mesh), 'batch_full' to every mesh axis (FSDP), 'model'
passes through, None replicates.

``replica`` serves the few ops whose output shape depends on the data
(the MoE dispatch's ``nonzero``), which DTensor cannot propagate: they run
on the full local value of a DTensor, and their results are lifted back
as replicated DTensors.

``on_shards`` hands a hand kernel the local shards of its DTensor operands
(the kernels take plain tensors): each operand is first laid out with its
batch and head dimensions sharded as the caller names them, everything
else replicated, and the kernel's outputs are lifted back as DTensors of
their own placements.  On plain tensors it calls the kernel as it is.
"""
from __future__ import annotations

import math
import sys
from typing import Callable

import torch


def _active_mesh():
    """The innermost ``DeviceMesh`` entered with ``with mesh:``, or None.
    No mesh can be active before ``torch.distributed.device_mesh`` is
    imported, so the check costs no import."""
    device_mesh = sys.modules.get("torch.distributed.device_mesh")
    if device_mesh is None:
        return None
    stack = device_mesh._mesh_resources.mesh_stack
    return stack[-1] if stack else None


def _is_dtensor(x) -> bool:
    tensor_mod = sys.modules.get("torch.distributed.tensor")
    return tensor_mod is not None and isinstance(x, tensor_mod.DTensor)


def resolve(mesh, *spec_tokens) -> tuple:
    """The spec (one entry per tensor dimension) that ``spec_tokens`` name
    on ``mesh`` (anything with ``.axis_names``), as the reference resolves
    them."""
    names = set(mesh.axis_names)
    resolved = []
    for tok in spec_tokens:
        if tok == "batch":
            axes = tuple(a for a in ("pod", "data") if a in names)
            resolved.append(axes if axes else None)
        elif tok == "batch_full":
            # FSDP: batch spans every mesh axis.
            resolved.append(tuple(mesh.axis_names))
        elif tok is None:
            resolved.append(None)
        elif isinstance(tok, str):
            resolved.append(tok if tok in names else None)
        else:
            resolved.append(tok)
    return tuple(resolved)


def constrain(x: torch.Tensor, *spec_tokens) -> torch.Tensor:
    """``x`` redistributed to the spec tokens' placements on the active
    mesh; ``x`` itself with no active mesh or when ``x`` is no DTensor."""
    mesh = _active_mesh()
    if mesh is None or not _is_dtensor(x):
        return x
    # Imported here: ``launch.sharding`` imports the training package,
    # which imports the models.
    from torch.distributed.tensor import Replicate

    from repro_torch.launch.mesh import mesh_view
    from repro_torch.launch.sharding import placements

    spec = resolve(mesh_view(mesh), *spec_tokens)
    # A dimension of one element stays whole (replicated), which leaves it
    # free to be squeezed by a reshape.
    pl = [Replicate() if p.is_shard() and x.shape[p.dim] == 1 else p for p in placements(spec, x.device_mesh)]
    return x.redistribute(x.device_mesh, pl)


def replica(x: torch.Tensor) -> tuple[torch.Tensor, Callable[[torch.Tensor], torch.Tensor]]:
    """``(value, lift)``: a DTensor's full value as a plain tensor and a
    function that makes a tensor computed from it a replicated DTensor on
    the same mesh; for a plain tensor, ``x`` itself and the identity."""
    if not _is_dtensor(x):
        return x, lambda t: t
    return x.full_tensor(), lifter(x)


def lifter(x: torch.Tensor) -> Callable[[torch.Tensor], torch.Tensor]:
    """A function that makes a plain tensor a replicated DTensor on a
    DTensor ``x``'s mesh; for a plain ``x``, the identity."""
    if not _is_dtensor(x):
        return lambda t: t
    from torch.distributed.tensor import DTensor, Replicate

    mesh = x.device_mesh
    return lambda t: DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim)


def is_fake(x: torch.Tensor) -> bool:
    """Whether ``x`` holds no values: a fake tensor, or a DTensor whose
    shards are fake."""
    from repro_torch.kernels.build import is_fake as fake

    return fake(x._local_tensor if _is_dtensor(x) else x)


def head_placements(x, batch_dim: int, head_dim: int, n_heads: tuple[int, ...]) -> tuple:
    """The placements on ``x``'s mesh that keep ``x``'s shards of
    ``batch_dim`` and, on a mesh dimension whose size divides every count
    in ``n_heads`` (query and KV heads), of ``head_dim``; every other mesh
    dimension replicated (a sequence shard or a pending sum is gathered)."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = x.device_mesh
    out = []
    for i, p in enumerate(x.placements):
        if p.is_shard(batch_dim):
            out.append(Shard(batch_dim))
        elif p.is_shard(head_dim) and all(n % mesh.size(i) == 0 for n in n_heads):
            out.append(Shard(head_dim))
        else:
            out.append(Replicate())
    return tuple(out)


def like(placements: tuple, dims: dict[int, int]) -> tuple:
    """``placements`` with each ``Shard(d)`` moved to dimension ``dims[d]``
    (``Replicate()`` where ``d`` has no entry): the same mesh dimensions
    sharding another tensor's batch or heads."""
    from torch.distributed.tensor import Replicate, Shard

    return tuple(Shard(dims[p.dim]) if p.is_shard() and p.dim in dims else Replicate() for p in placements)


def _contiguous_stride(shape) -> tuple[int, ...]:
    stride, n = [], 1
    for size in reversed(shape):
        stride.append(n)
        n *= size
    return tuple(reversed(stride))


def on_shards(kernel: Callable, operands: list, placements: list, out_placements: list):
    """``kernel(*local operands)`` on the shards that ``placements`` (one
    per operand) lay out; its outputs (a tensor or a tuple) lifted back as
    DTensors under ``out_placements`` (one per output), of the global
    shapes that those shards make up.  A plain tensor operand counts as
    replicated and None passes as None.  With no DTensor operand this is
    ``kernel(*operands)``."""
    mesh = next((t.device_mesh for t in operands if _is_dtensor(t)), None)
    if mesh is None:
        return kernel(*operands)
    from torch.distributed.tensor import DTensor, Replicate

    local = []
    for t, pl in zip(operands, placements, strict=True):
        if t is None:
            local.append(None)
            continue
        if not _is_dtensor(t):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
        local.append(t.redistribute(mesh, pl).to_local().contiguous())
    out = kernel(*local)
    outs = out if isinstance(out, tuple) else (out,)
    lifted = []
    for o, pl in zip(outs, out_placements, strict=True):
        o = o.contiguous()          # the plain versions may return a permuted view
        shape = list(o.shape)
        for size, p in zip(mesh.shape, pl):
            if p.is_shard():
                shape[p.dim] *= size
        lifted.append(DTensor.from_local(o, mesh, pl, run_check=False, shape=torch.Size(shape),
                                         stride=_contiguous_stride(shape)))
    return tuple(lifted) if isinstance(out, tuple) else lifted[0]


def split_rows(x: torch.Tensor, n: int) -> list[torch.Tensor]:
    """``x`` as ``n`` consecutive slices of its leading axis.  For a DTensor
    sharded along that axis, each rank's shard is cut into ``n`` slices and
    slice i of every shard makes up piece i (under ``x``'s placements):
    each piece stays sharded, where slicing the global axis would gather
    it.  The pieces then hold other rows than the global slices, in the
    same numbers."""
    if not (_is_dtensor(x) and any(p.is_shard(0) for p in x.placements)):
        m = x.shape[0] // n
        return [x[i * m:(i + 1) * m] for i in range(n)]
    from torch.distributed.tensor import DTensor

    local = x.to_local()
    m = local.shape[0] // n
    shape = (x.shape[0] // n, *x.shape[1:])
    return [DTensor.from_local(local[i * m:(i + 1) * m], x.device_mesh, x.placements, run_check=False,
                               shape=torch.Size(shape), stride=_contiguous_stride(shape))
            for i in range(n)]


def unflatten(x: torch.Tensor, dim: int, sizes: tuple[int, ...]) -> torch.Tensor:
    """``x`` with dimension ``dim`` split into ``sizes`` (a reshape).  On a
    DTensor whose ``dim`` is sharded over mesh dimensions whose ranks do not
    divide ``sizes[0]`` (heads over a wider model axis), that dimension is
    gathered first: a slice of the leading size cannot straddle two ranks,
    and the reference's GSPMD reshards the same way."""
    dim %= x.ndim
    if _is_dtensor(x):
        from torch.distributed.tensor import Replicate

        mesh = x.device_mesh
        cut = [i for i, p in enumerate(x.placements) if p.is_shard() and p.dim % x.ndim == dim]
        if sizes[0] % math.prod(mesh.size(i) for i in cut):
            x = x.redistribute(mesh, [Replicate() if i in cut else p for i, p in enumerate(x.placements)])
    return x.reshape(*x.shape[:dim], *sizes, *x.shape[dim + 1:])


def match(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``x`` laid out as the DTensor ``like`` (the source of an in-place op
    on ``like``, which DTensor would otherwise leave inconsistent); ``x``
    itself when either is a plain tensor."""
    if _is_dtensor(x) and _is_dtensor(like) and x.placements != like.placements:
        return x.redistribute(like.device_mesh, like.placements)
    return x


def whole_dim0(x: torch.Tensor) -> torch.Tensor:
    """A DTensor ``x`` with its leading dimension gathered whole and its
    other shards kept; ``x`` itself when that dimension is not sharded or
    ``x`` is a plain tensor."""
    if not (_is_dtensor(x) and any(p.is_shard(0) for p in x.placements)):
        return x
    from torch.distributed.tensor import Replicate

    return x.redistribute(x.device_mesh, [Replicate() if p.is_shard(0) else p for p in x.placements])


def even(x: torch.Tensor, dims: tuple[int, ...]) -> torch.Tensor:
    """A DTensor ``x`` with every shard of ``dims`` that its mesh
    dimension's ranks do not divide gathered, so that a reshape may merge
    them (DTensor merges even shards only); ``x`` itself otherwise."""
    if not _is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate

    mesh = x.device_mesh
    pl = [Replicate() if p.is_shard() and p.dim % x.ndim in dims and x.shape[p.dim] % mesh.size(i) else p
          for i, p in enumerate(x.placements)]
    return x if pl == list(x.placements) else x.redistribute(mesh, pl)
