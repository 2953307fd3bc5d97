"""Device meshes: the reference's production mesh shapes and a small host
mesh, on ``torch.distributed.device_mesh``.

Port of the JAX package's ``launch/mesh.py``, with its axis names and
shapes: a pod is a 16 x 16 ``("data", "model")`` mesh and the multi-pod
mesh stacks two, ``("pod", "data", "model")``.  A ``DeviceMesh`` spans the
ranks of a process group, so these functions build meshes over the default
group; ``make_host_mesh`` starts a one-rank group itself where none exists
(over an in-process ``HashStore``, so it opens no TCP port), which the
caller ends with ``torch.distributed.destroy_process_group``.

The sharding rules read a mesh through ``.shape`` (axis name -> size) and
``.axis_names``, as the reference's rules read a JAX mesh; ``mesh_view``
gives a ``DeviceMesh`` that view, and any object that has those two
attributes (a test's stand-in mesh) drives the rules as it is.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class MeshView:
    """A mesh as the sharding rules read it: axis name -> size, in order."""

    shape: dict[str, int]
    axis_names: tuple[str, ...]


def mesh_view(mesh) -> MeshView:
    """``mesh`` as ``.shape`` (axis name -> size) and ``.axis_names``; a
    ``DeviceMesh`` is read through its dimension names, any other object is
    taken to have both attributes already."""
    if isinstance(mesh, DeviceMesh):
        names = tuple(mesh.mesh_dim_names or ())
        if len(names) != mesh.ndim:
            raise ValueError(f"the sharding rules need a mesh with named dimensions, got {mesh}")
        return MeshView(dict(zip(names, mesh.shape)), names)
    return mesh


def _mesh(device_type: str, shape: tuple[int, ...], axes: tuple[str, ...]) -> DeviceMesh:
    """A mesh of ``shape`` over the default process group, which must
    already hold ``prod(shape)`` ranks."""
    if not dist.is_initialized():
        raise RuntimeError(
            f"a {shape} mesh needs a process group of {math.prod(shape)} ranks; none is initialized"
        )
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device: "str | torch.device" = "cuda") -> DeviceMesh:
    """16x16 = 256 ranks per pod; multi_pod stacks 2 pods (512 ranks).  The
    default process group must hold that many ranks (a fake group on the
    host, for a dry run)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(resolve_device(device).type, shape, axes)


def make_host_mesh(data: int = 1, model: int = 1, *, device: "str | torch.device" = "cuda") -> DeviceMesh:
    """A ``(data, model)`` mesh over the default process group on
    ``device`` (the card unless the caller asks for ``"cpu"``).  Where no
    group exists, a one-rank group is started first: NCCL on the card,
    gloo on the host, over an in-process store."""
    device_type = resolve_device(device).type
    if not dist.is_initialized():
        if data * model != 1:
            raise RuntimeError(f"a {data}x{model} mesh needs a process group of {data * model} ranks")
        backend = "nccl" if device_type == "cuda" else "gloo"
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
        if device_type == "cuda":
            # The one rank's card is the current one, set before the mesh
            # would pick one by its own heuristic.
            torch.cuda.set_device(torch.cuda.current_device())
    return _mesh(device_type, (data, model), ("data", "model"))


def batch_axes(mesh) -> tuple[str, ...]:
    """Mesh axes the global batch shards over."""
    if "pod" in mesh_view(mesh).axis_names:
        return ("pod", "data")
    return ("data",)
