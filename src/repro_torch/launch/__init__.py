"""Command-line entry points (``serve``, ``train``), device meshes
(``mesh``), sharding rules (``sharding``) and step bundles (``steps``)."""
from repro_torch.launch.mesh import batch_axes, make_host_mesh, make_production_mesh

__all__ = ["batch_axes", "make_host_mesh", "make_production_mesh"]
