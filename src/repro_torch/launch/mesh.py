"""Device meshes — port of ``repro/launch/mesh.py``.

Functions, never module-level constants: importing this module touches
no process group.  A mesh is a ``torch.distributed`` ``DeviceMesh`` with
JAX's axis names.

* :func:`make_production_mesh` lays the production shapes, (16, 16)
  ``("data", "model")`` or (2, 16, 16) ``("pod", "data", "model")``, over
  the default process group, which the caller has set up with that many
  ranks (``torch.distributed.init_process_group``; nothing on a machine
  tells a program of its cluster).
* :func:`make_local_mesh` is a small mesh for one process and its tests:
  where no process group exists and the mesh has one rank, it sets up a
  group of one over an in-process store (NCCL on the card, gloo on the
  CPU), which opens no socket.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

__all__ = ["make_production_mesh", "make_local_mesh", "data_axes", "MESH_AXES"]

MESH_AXES = ("pod", "data", "model")


def _mesh(device: str, shape: tuple, axes: tuple) -> DeviceMesh:
    return init_device_mesh(torch.device(device).type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda") -> DeviceMesh:
    """Single-pod 16×16 = 256 ranks, or 2-pod 2×16×16 = 512 ranks, over
    the default process group of exactly that world size."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    want = 1
    for n in shape:
        want *= n
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != want:
        raise ValueError(f"the production mesh {shape} needs a default process group "
                         f"of {want} ranks; this one has {world}")
    return _mesh(device, shape, axes)


def make_local_mesh(data: int = 1, model: int = 1, device: str = "cuda") -> DeviceMesh:
    """A (data, model) mesh over the local ranks; with no process group
    and one rank, over a group of one that this call sets up."""
    if not dist.is_initialized() and data * model == 1:
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("a CUDA mesh needs a card; pass device='cpu' for the CPU")
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if dev.type == "cuda":
            torch.cuda.set_device(dev.index or 0)
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    return _mesh(device, (data, model), ("data", "model"))


def data_axes(mesh) -> tuple[str, ...]:
    """Axes that shard the batch: ('pod', 'data') when present."""
    names = mesh.mesh_dim_names
    return tuple(a for a in ("pod", "data") if a in names)
