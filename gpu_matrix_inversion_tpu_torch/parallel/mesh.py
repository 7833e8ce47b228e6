"""Device meshes over the initialized ``torch.distributed`` world.

Port of ``gpu_matrix_inversion_tpu/parallel/mesh.py``. A JAX mesh is an
array of the process's devices; here it is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the
initialized process group, one rank per device (NCCL on cards, gloo on
the CPU). The world is what the caller set up (``torchrun``, or
:func:`~gpu_matrix_inversion_tpu_torch.parallel.launch.spawn_ranks`);
nothing here starts a process or falls back to the CPU or to one device:
a mesh the world cannot hold raises.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def world_size() -> int:
    """Ranks of the initialized process group; 0 when there is none (the
    counterpart of the reference's ``len(default_platform_devices())``)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 0


def require_world() -> int:
    """:func:`world_size`, or a ``ValueError`` saying what to initialize."""
    size = world_size()
    if size == 0:
        raise ValueError(
            "no torch.distributed process group: pass mesh=, or initialize "
            "one first (torch.distributed.init_process_group under torchrun,"
            " or parallel.launch.spawn_ranks)")
    return size


# The device each backend serves on the sharded route: NCCL the cards,
# gloo the CPU (gloo's CUDA collectives are not used).
_SERVES = {"nccl": "cuda", "gloo": "cpu"}


def world_serves(device_type: str) -> bool:
    """Whether the initialized world's backend serves tensors of
    ``device_type`` (``"cuda"`` over NCCL, ``"cpu"`` over gloo); False with
    no world. A group with a backend for each device type
    (``"cpu:gloo,cuda:nccl"``) serves both."""
    if world_size() == 0:
        return False
    config = (dist.get_backend_config() if hasattr(dist, "get_backend_config")
              else str(dist.get_backend()))
    for entry in str(config).split(","):
        dev, _, backend = entry.rpartition(":")
        if _SERVES.get(backend) == device_type and dev in ("", device_type):
            return True
    return False


def default_platform() -> str:
    """The device type of the initialized world: ``"cuda"`` where its
    backend serves the cards (NCCL), else ``"cpu"`` (gloo)."""
    require_world()
    return "cuda" if world_serves("cuda") else "cpu"


def make_device_mesh(shape: Sequence[int] | int,
                     axis_names: Tuple[str, ...] = ("x",),
                     platform: Optional[str] = None) -> DeviceMesh:
    """A ``DeviceMesh`` of the requested shape over every rank of the
    initialized world.

    Args:
      shape: total ranks (int) or per-axis sizes; their product must be
        the world size.
      axis_names: mesh axis names (e.g. ``("dp", "tp")``).
      platform: ``"cuda"`` (the default) or ``"cpu"`` (gloo ranks).
    """
    if isinstance(shape, int):
        shape = (shape,)
    shape = tuple(int(s) for s in shape)
    if len(axis_names) != len(shape):
        raise ValueError(f"{len(shape)} mesh dims need {len(shape)} axis "
                         f"names, got {axis_names}")
    n = math.prod(shape)
    size = require_world()
    if size != n:
        raise ValueError(f"mesh of {n} ranks requested but the world has "
                         f"{size} (platform={platform or 'cuda'})")
    return init_device_mesh(platform or "cuda", shape,
                            mesh_dim_names=tuple(axis_names))
