"""Meshes over the ranks of a `torch.distributed` process group, with
the reference's dim names (`launch/mesh.py` there).

* `make_production_mesh` — (16, 16) as ("data", "model"), or
  (2, 16, 16) as ("pod", "data", "model") with ``multi_pod``;
* `make_host_mesh(data, model)` — a small ("data", "model") mesh;
* `batch_axes(mesh)` — the data-parallel dims (every dim but "model");
* `set_mesh(mesh)` — the mesh in context (`models.layers.current_mesh`
  reads it): under it the model's entry points run sharded when called
  with `dp=`;
* `mesh_shape(mesh)` — {dim name: size} of a `DeviceMesh` or of a plain
  name-to-size mapping, which stands in for a mesh where nothing runs
  (specs and abstract cells are built without a process group).

The meshes are built with `init_device_mesh` over the default process
group, which the caller has initialised with the backend of its choice
(gloo, NCCL); nothing here picks one.  The mesh's device type is the
card's unless "cpu" is asked for.
"""
from __future__ import annotations

import contextlib
import contextvars
from collections.abc import Mapping

import torch.distributed as dist

__all__ = ["make_production_mesh", "make_host_mesh", "batch_axes",
           "set_mesh", "mesh_shape", "active_mesh"]

_MESH: contextvars.ContextVar = contextvars.ContextVar("mesh", default=None)


@contextlib.contextmanager
def set_mesh(mesh):
    """``with set_mesh(mesh):`` makes `mesh` the mesh in context."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def active_mesh():
    """The mesh that `set_mesh` put in context, or None."""
    return _MESH.get()


def mesh_shape(mesh) -> dict:
    """{dim name: size} in the mesh's dim order; `mesh` is a
    `DeviceMesh` with named dims or a mapping of name to size."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    names = mesh.mesh_dim_names
    if not names:
        raise ValueError("the mesh's dims have no names")
    return {n: mesh.size(i) for i, n in enumerate(names)}


def _mesh(shape: tuple, names: tuple, device_type: str):
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: initialise torch.distributed (with the "
            "backend of your choice) before building a mesh")
    n = 1
    for s in shape:
        n *= s
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"a {shape} mesh {names} needs {n} ranks; the "
                         f"process group has {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """(16, 16) ("data", "model"), or (2, 16, 16) ("pod", "data",
    "model"); raises ValueError unless the world size is 256 or 512."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, names, device_type)


def make_host_mesh(data: int = 1, model: int = 1,
                   device_type: str = "cuda"):
    """A (data, model) mesh over the process group's ranks."""
    return _mesh((data, model), ("data", "model"), device_type)


def batch_axes(mesh) -> tuple[str, ...]:
    """The data-parallel dims of a mesh (everything except "model")."""
    return tuple(n for n in mesh_shape(mesh) if n != "model")
