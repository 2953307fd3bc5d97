"""Activation sharding constraints inside model code.

Port of the JAX package's ``models/sharding_utils.py``.  ``constrain`` pins
an activation to a batch-sharded layout whenever a mesh is active (entered
with ``with mesh:``), and is a no-op otherwise: with no mesh, or on a
plain tensor, it returns its input itself.  On a DTensor it redistributes
to the placements its spec tokens resolve to.

Spec tokens: 'batch' expands to the mesh's batch axes (('pod','data') on
the multi-pod mesh), 'batch_full' to every mesh axis (FSDP), 'model'
passes through, None replicates.

``relayout`` redistributes, moving a split from one dimension to
another on a host mesh by one all-to-all, as DTensor does on a card
mesh (on a host mesh DTensor gathers the whole dimension).
``vocab_parallel_embedding`` and ``vocab_parallel_nll`` look up
and score a vocabulary split over 'model' on each rank's shard, and
``write_position`` writes a decode position into the shard that holds it.

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
    return relayout(x, pl)


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` of equal blocks along dim 0 over one mesh
    dimension; its gradient is the same exchange of the gradient."""

    @staticmethod
    def forward(ctx, t, mesh, dim):
        from torch.distributed import _functional_collectives as funcol

        ctx.group = (mesh, dim)
        out = funcol.all_to_all_single(t.contiguous(), None, None, (mesh, dim))
        return out.wait() if isinstance(out, funcol.AsyncCollectiveTensor) else out

    @staticmethod
    def backward(ctx, grad):
        return _AllToAll.apply(grad, *ctx.group), None, None


def _move_shard(x: torch.Tensor, mesh_dim: int, dst: int) -> torch.Tensor:
    """DTensor ``x``, split along ``src`` over mesh dimension ``mesh_dim``
    and along no other dimension there, split along ``dst`` instead, by
    one all-to-all.  (DTensor's own move falls back to an all-gather of
    the whole dimension on a host mesh.)"""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh, n = x.device_mesh, x.device_mesh.size(mesh_dim)
    src = x.placements[mesh_dim].dim % x.ndim
    # A pending sum's gradient is every rank's whole one (replicated).
    local = x.to_local(grad_placements=[Replicate() if p.is_partial() else p for p in x.placements])
    blocks = torch.stack(local.chunk(n, dim=dst))                 # (n, ...): block j goes to rank j
    got = _AllToAll.apply(blocks, mesh, mesh_dim)                 # block j came from rank j
    out = torch.cat(got.unbind(0), dim=src)
    pl = [Shard(dst) if i == mesh_dim else p for i, p in enumerate(x.placements)]
    return DTensor.from_local(out, mesh, pl, run_check=False, shape=x.shape, stride=x.stride())


def relayout(x: torch.Tensor, pl) -> torch.Tensor:
    """DTensor ``x`` under placements ``pl``, by ``redistribute``.  On a
    host mesh, where DTensor moves a split from one dimension to another
    by an all-gather of the whole dimension, such a move is one all-to-all
    instead, as DTensor issues it on a card mesh (where both dimensions
    divide evenly and no other mesh dimension splits them): the dry run,
    which counts on a host mesh, then counts the collective a card mesh
    runs."""
    pl = list(pl)
    if x.device_mesh.device_type == "cpu":
        for i, (cur, want) in enumerate(zip(x.placements, pl)):
            if not (cur.is_shard() and want.is_shard() and cur.dim % x.ndim != want.dim % x.ndim):
                continue
            a, b, n = cur.dim % x.ndim, want.dim % x.ndim, x.device_mesh.size(i)
            alone = all(not (p.is_shard() and p.dim % x.ndim in (a, b))
                        for j, p in enumerate(x.placements) if j != i)
            if alone and x.shape[a] % n == 0 and x.shape[b] % n == 0:
                x = _move_shard(x, i, b)
    return x if list(x.placements) == pl else x.redistribute(x.device_mesh, pl)


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
    ``kernel(*operands)``.

    An operand replicated over a mesh dimension of several ranks that
    splits an output feeds different outputs on each of its ranks, so its
    local gradient is that rank's addend: it is marked a pending sum
    there (``Partial``), which autograd all-reduces."""
    mesh = next((t.device_mesh for t in operands if _is_dtensor(t)), None)
    if mesh is None:
        return kernel(*operands)
    from torch.distributed.tensor import DTensor, Partial, Replicate

    split = {i for pl in out_placements for i, p in enumerate(pl) if p.is_shard() and mesh.size(i) > 1}
    local = []
    for t, pl in zip(operands, placements, strict=True):
        if t is None:
            local.append(None)
            continue
        if not _is_dtensor(t):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
        grad = [Partial() if i in split and p.is_replicate() else p for i, p in enumerate(pl)]
        local.append(t.redistribute(mesh, pl).to_local(grad_placements=grad).contiguous())
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


def _rows_split(x: torch.Tensor, n: int) -> bool:
    """Whether ``x`` is a DTensor whose leading axis is split, in shards
    that each cut into ``n`` equal slices."""
    return (_is_dtensor(x) and any(p.is_shard(0) for p in x.placements)
            and x.to_local().shape[0] % n == 0)


def split_rows(x: torch.Tensor, n: int) -> list[torch.Tensor]:
    """``x`` as ``n`` consecutive slices of its leading axis.  For a DTensor
    sharded along that axis, each rank's shard is cut into ``n`` slices and
    slice i of every shard makes up piece i (under ``x``'s placements):
    each piece stays sharded, where slicing the global axis would gather
    it.  The pieces then hold other rows than the global slices, in the
    same numbers; ``join_rows`` puts them back."""
    if not _rows_split(x, n):
        m = x.shape[0] // n
        return [x[i * m:(i + 1) * m] for i in range(n)]
    from torch.distributed.tensor import DTensor

    local = x.to_local()
    m = local.shape[0] // n
    shape = (x.shape[0] // n, *x.shape[1:])
    return [DTensor.from_local(local[i * m:(i + 1) * m], x.device_mesh, x.placements, run_check=False,
                               shape=torch.Size(shape), stride=_contiguous_stride(shape))
            for i in range(n)]


def join_rows(parts: list[torch.Tensor]) -> torch.Tensor:
    """The inverse of ``split_rows``: the pieces' rows put back in their
    order, each rank's shard the concatenation of its pieces' shards
    (``torch.cat`` for plain tensors or pieces whose leading axis is
    whole)."""
    x = parts[0]
    if not (_is_dtensor(x) and any(p.is_shard(0) for p in x.placements)):
        return torch.cat(parts)
    from torch.distributed.tensor import DTensor

    shape = (sum(p.shape[0] for p in parts), *x.shape[1:])
    return DTensor.from_local(torch.cat([p.to_local() for p in parts]), x.device_mesh, x.placements,
                              run_check=False, shape=torch.Size(shape), stride=_contiguous_stride(shape))


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


def _all_reduce(t: torch.Tensor, op: str, mesh, dim: int) -> torch.Tensor:
    """``t`` (a plain tensor) reduced with ``op`` over mesh dimension
    ``dim``, by a functional collective (the kind DTensor issues)."""
    from torch.distributed import _functional_collectives as funcol

    out = funcol.all_reduce(t, op, (mesh, dim))
    return out.wait() if isinstance(out, funcol.AsyncCollectiveTensor) else out


class _SumOverRanks(torch.autograd.Function):
    """A sum of one addend per rank of a mesh dimension.  Each addend's
    derivative is one, so every rank's gradient is the sum's own (which is
    the same on every rank): no collective in the backward pass."""

    @staticmethod
    def forward(ctx, t, mesh, dim):
        return _all_reduce(t, "sum", mesh, dim)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


def _vocab_split(table: torch.Tensor, dim: int) -> int | None:
    """The mesh dimension of several ranks that alone splits ``dim`` of
    DTensor ``table``, or None."""
    cut = [i for i, p in enumerate(table.placements) if p.is_shard() and p.dim % table.ndim == dim]
    return cut[0] if len(cut) == 1 and table.device_mesh.size(cut[0]) > 1 else None


def _first_row(n: int, mesh, mesh_dim: int) -> int:
    """The first of ``n`` rows that this rank holds along a dimension split
    over ``mesh_dim`` (``torch.chunk``'s split)."""
    return min(mesh.get_local_rank(mesh_dim) * -(-n // mesh.size(mesh_dim)), n)


def write_position(cache: torch.Tensor, pos: int, new: torch.Tensor) -> None:
    """``cache[:, pos] = new`` in place, for a cache (B, S, ...) and
    ``new`` (B, ...).  On a DTensor cache split along the sequence the
    write lands in the shard of the rank that holds ``pos`` (DTensor's own
    indexing of a split dimension would write into a gathered copy),
    ``new`` first laid out as the cache's other dimensions are."""
    if not _is_dtensor(cache):
        cache[:, pos] = new
        return
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = cache.device_mesh
    seq = [i for i, p in enumerate(cache.placements) if p.is_shard(1)]
    if len(seq) > 1:
        raise NotImplementedError("a cache whose sequence is split over several mesh dimensions")
    if not _is_dtensor(new):
        new = DTensor.from_local(new, mesh, [Replicate()] * mesh.ndim, run_check=False)
    pl = [Replicate() if not p.is_shard() or p.dim == 1 else Shard(p.dim - (p.dim > 1))
          for p in cache.placements]
    rows = relayout(new, pl).to_local()
    local = cache._local_tensor
    lo = _first_row(cache.shape[1], mesh, seq[0]) if seq else 0
    if lo <= pos < lo + local.shape[1]:
        local[:, pos - lo] = rows


def vocab_parallel_embedding(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The rows of ``table`` (V, D) at ``tokens`` (B, S).  For a DTensor
    table whose vocabulary is split over one mesh dimension of several
    ranks (and nothing else split), each rank looks up the tokens its shard
    owns, zero elsewhere, and the rows are summed over that mesh dimension,
    as the reference's GSPMD looks them up: no collective carries the
    vocabulary, and each rank's gradient is its own shard's.  The rows
    come back split as the tokens' batch is.  Anything else is
    ``table[tokens]``."""
    vd = _vocab_split(table, 0) if _is_dtensor(table) else None
    if vd is None or any(p.is_shard() and p.dim % 2 != 0 for p in table.placements):
        return table[tokens]
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = table.device_mesh
    rows = [Shard(0) if _is_dtensor(tokens) and p.is_shard(0) else Replicate() for p in
            (tokens.placements if _is_dtensor(tokens) else [Replicate()] * mesh.ndim)]
    if not _is_dtensor(tokens):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim, run_check=False)
    shape = (*tokens.shape, table.shape[1])
    tokens = tokens.redistribute(mesh, rows).to_local()
    # Over a batch axis each rank's gradient holds its own tokens' rows
    # only: a pending sum there, which autograd all-reduces.
    grad = [Partial() if r.is_shard() and mesh.size(i) > 1 else p
            for i, (r, p) in enumerate(zip(rows, table.placements))]
    local = table.to_local(grad_placements=grad)
    idx = tokens - _first_row(table.shape[0], mesh, vd)
    owned = (idx >= 0) & (idx < local.shape[0])
    picked = local[idx.clamp(0, local.shape[0] - 1)] * owned[..., None].to(local.dtype)
    out = _SumOverRanks.apply(picked, mesh, vd)
    return DTensor.from_local(out, mesh, rows, run_check=False, shape=torch.Size(shape), stride=_contiguous_stride(shape))


def vocab_parallel_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor | None:
    """``-log softmax(logits)[label]`` (B, S) for float32 ``logits`` (B, S, V)
    that are a DTensor with the vocabulary split over one mesh dimension of
    several ranks, computed where the reference's GSPMD computes it: on
    each rank's vocabulary shard.  The shard's maximum, its sum of
    ``exp(x - max)`` and the label's logit (on the shard that owns the
    label, zero elsewhere) are all-reduced over that mesh dimension; no
    collective carries the vocabulary, and autograd gives each rank the
    gradient of its own (B_local, S, V_local) shard.  The result is a
    DTensor sharded over the logits' batch shards.  None for any other
    logits (a plain tensor, a replicated or otherwise split vocabulary):
    the caller takes the whole-row ``log_softmax``."""
    if not _is_dtensor(logits):
        return None
    mesh, last = logits.device_mesh, logits.ndim - 1
    vd = _vocab_split(logits, last)
    if vd is None:
        return None
    from torch.distributed.tensor import DTensor, Replicate, Shard

    rows = [Shard(0) if p.is_shard(0) else Replicate() for p in logits.placements]
    pl = [Shard(last) if i == vd else p for i, p in enumerate(rows)]
    if list(logits.placements) != pl:      # a pending sum or a sequence shard: settled first
        logits = logits.redistribute(mesh, pl)
    if not _is_dtensor(labels):
        labels = DTensor.from_local(labels, mesh, [Replicate()] * mesh.ndim, run_check=False)
    shape = labels.shape
    labels = labels.redistribute(mesh, rows).to_local()
    local = logits.to_local()
    v_local = local.shape[-1]
    lo = _first_row(logits.shape[last], mesh, vd)
    with torch.no_grad():
        m = _all_reduce(local.amax(-1, keepdim=True), "max", mesh, vd)
    lse = _SumOverRanks.apply((local - m).exp().sum(-1), mesh, vd).log() + m[..., 0]
    idx = labels - lo
    owned = (idx >= 0) & (idx < v_local)
    picked = local.gather(-1, idx.clamp(0, v_local - 1)[..., None])[..., 0] * owned
    nll = lse - _SumOverRanks.apply(picked, mesh, vd)
    return DTensor.from_local(nll, mesh, rows, run_check=False, shape=shape, stride=_contiguous_stride(shape))


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
