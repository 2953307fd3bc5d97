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
"""
from __future__ import annotations

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
    from repro_torch.launch.mesh import mesh_view
    from repro_torch.launch.sharding import placements

    spec = resolve(mesh_view(mesh), *spec_tokens)
    return x.redistribute(x.device_mesh, placements(spec, x.device_mesh))


def replica(x: torch.Tensor) -> tuple[torch.Tensor, Callable[[torch.Tensor], torch.Tensor]]:
    """``(value, lift)``: a DTensor's full value as a plain tensor and a
    function that makes a tensor computed from it a replicated DTensor on
    the same mesh; for a plain tensor, ``x`` itself and the identity."""
    if not _is_dtensor(x):
        return x, lambda t: t
    from torch.distributed.tensor import DTensor, Replicate

    mesh = x.device_mesh
    return x.full_tensor(), lambda t: DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim)
