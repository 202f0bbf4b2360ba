"""Mesh construction, the counterpart of ``repro/launch/mesh.py``.

Functions, not module-level constants: importing this module touches no
process group. The production mesh is an :class:`~repro_torch.parallel.mesh.AbstractMesh`
unless the process's default group spans exactly its ranks (the dry run
initialises a ``fake`` group of 256 or 512 ranks for that, in its own
process only: ``launch/dryrun.py``, the counterpart of the reference's
``XLA_FLAGS`` device count).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.parallel.mesh import AbstractMesh


def _device_mesh(device_type: str, shape, names):
    from torch.distributed.device_mesh import DeviceMesh
    n = 1
    for s in shape:
        n *= s
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False):
    """(16,16) single pod (256 chips) or (2,16,16) two pods (512 chips):
    a ``DeviceMesh`` over the default group when that group has exactly
    as many ranks, else abstract."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    mesh = AbstractMesh(shape, axes)
    if dist.is_initialized() and dist.get_world_size() == mesh.size:
        return _device_mesh("cpu", shape, axes)
    return mesh


def make_host_mesh(model_parallel: int = 1):
    """(world // model_parallel, model_parallel) over the ``torch.distributed``
    world, on its backend's device (``cuda`` for NCCL, ``cpu`` else).
    Without an initialised group it covers the one device: an abstract
    (1, 1) mesh, whose every layout is the identity."""
    if not dist.is_initialized():
        if model_parallel != 1:
            raise ValueError(f"model_parallel={model_parallel} needs an "
                             f"initialised torch.distributed group of a "
                             f"multiple of {model_parallel} ranks")
        return AbstractMesh((1, 1), ("data", "model"))
    n = dist.get_world_size()
    if n % model_parallel:
        raise ValueError(f"world size {n} does not divide into "
                         f"model_parallel={model_parallel}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return _device_mesh(device_type, (n // model_parallel, model_parallel),
                        ("data", "model"))
