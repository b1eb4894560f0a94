"""Launchers (the port of ``repro.launch``): the training and serving
launchers, fault tolerance, the production meshes and cells, and the dry
run. Importing this package touches no CUDA state."""

from repro_torch.launch import ft, mesh, shapes
from repro_torch.launch.mesh import make_mesh, make_production_mesh

__all__ = ["ft", "mesh", "shapes", "make_mesh", "make_production_mesh"]
