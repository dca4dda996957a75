"""Mesh builders (counterpart of ``repro/launch/mesh.py``).

``make_production_mesh`` is the reference's production mesh: single pod
(16, 16) = 256 devices, axes ("data", "model"); multi-pod (2, 16, 16) =
512, axes ("pod", "data", "model"). It serves a real job of 256 or 512
cards and the dry run's fake process group (``launch/dryrun.py``) alike.
``make_debug_mesh`` is a ``DeviceMesh`` over the processes of an
initialized process group (``torch.distributed.init_process_group`` with
its address, world size and rank given), axes ``("data", "model")`` or,
with ``pod``, ``("pod", "data", "model")``. ``AbstractMesh`` (names and
sizes, no processes) serves the specs of any mesh size, the reference's
single-pod (16, 16) and multi-pod (2, 16, 16) included.
"""
from __future__ import annotations

from ..models.runtime import AbstractMesh

__all__ = ["AbstractMesh", "make_debug_mesh", "make_production_mesh"]

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The production ``DeviceMesh`` over the initialized process group,
    whose world size must be the mesh's (256, or 512 with ``multi_pod``)."""
    import math

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = PRODUCTION_SHAPES[multi_pod]
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world != math.prod(shape):
        raise ValueError(f"the production mesh {shape} needs a process group of "
                         f"{math.prod(shape)}, got {world or 'none'}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_debug_mesh(data: int = 2, model: int = 2, pod: int = 0, *, device_type: str = "cuda"):
    """A (data, model) or (pod, data, model) ``DeviceMesh`` on
    ``device_type`` ("cuda" unless asked for the CPU); the process group's
    world size must be the mesh's size."""
    from torch.distributed.device_mesh import init_device_mesh

    if pod:
        return init_device_mesh(device_type, (pod, data, model),
                                mesh_dim_names=("pod", "data", "model"))
    return init_device_mesh(device_type, (data, model), mesh_dim_names=("data", "model"))
