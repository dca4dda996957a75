"""Debug mesh builder (counterpart of ``repro/launch/mesh.py``).

``make_debug_mesh`` is a ``DeviceMesh`` over the processes of an
initialized process group (``torch.distributed.init_process_group`` with
its address, world size and rank given), axes ``("data", "model")`` or,
with ``pod``, ``("pod", "data", "model")``. ``AbstractMesh`` (names and
sizes, no processes) serves the specs of any mesh size, the reference's
single-pod (16, 16) and multi-pod (2, 16, 16) included.
"""
from __future__ import annotations

from ..models.runtime import AbstractMesh

__all__ = ["AbstractMesh", "make_debug_mesh"]


def make_debug_mesh(data: int = 2, model: int = 2, pod: int = 0, *, device_type: str = "cuda"):
    """A (data, model) or (pod, data, model) ``DeviceMesh`` on
    ``device_type`` ("cuda" unless asked for the CPU); the process group's
    world size must be the mesh's size."""
    from torch.distributed.device_mesh import init_device_mesh

    if pod:
        return init_device_mesh(device_type, (pod, data, model),
                                mesh_dim_names=("pod", "data", "model"))
    return init_device_mesh(device_type, (data, model), mesh_dim_names=("data", "model"))
