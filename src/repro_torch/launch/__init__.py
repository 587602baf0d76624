"""Meshes (`mesh`) and the (arch x shape x mesh) cells with their
partition specs (`specs`, imported on its own: it pulls in the model and
the train step)."""
from .mesh import (
    batch_axes, make_host_mesh, make_production_mesh, mesh_shape, set_mesh,
)

__all__ = ["batch_axes", "make_host_mesh", "make_production_mesh",
           "mesh_shape", "set_mesh"]
