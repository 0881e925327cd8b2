"""Mesh construction (port of ``repro.launch.mesh``).

``make_production_mesh`` is a FUNCTION (importing this module touches no
process group).  Single-pod: (16, 16) = 256 ranks, axes (data, model).
Multi-pod: (2, 16, 16) = 512 ranks, axes (pod, data, model); the pod
axis is data-parallel across pods.

A mesh here is a ``torch.distributed`` ``DeviceMesh`` over the
initialised default process group, one rank per device: ``cuda`` where
the group's backend is NCCL, else ``cpu`` (gloo, and the fake group of
``launch/dryrun.py``).  A mesh smaller than the world takes its first
ranks, so the dry run builds both meshes in one world of 512.
"""
from __future__ import annotations

import math

import torch


def _world() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 0


def mesh_device_type() -> str:
    """``cuda`` over an NCCL group, else ``cpu``."""
    import torch.distributed as dist

    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def build_mesh(shape, axes):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the first
    ``prod(shape)`` ranks of the initialised process group."""
    from torch.distributed.device_mesh import DeviceMesh

    shape = tuple(int(n) for n in shape)
    need = math.prod(shape)
    have = _world()
    if have < need:
        raise RuntimeError(
            f"mesh {shape} needs {need} ranks but the process group has "
            f"{have} (initialise torch.distributed with a world size of at "
            f"least {need} first; launch/dryrun.py uses a fake group)")
    return DeviceMesh(mesh_device_type(),
                      torch.arange(need).reshape(shape),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return build_mesh(shape, axes)


def make_test_mesh(shape=(2, 2), axes=("data", "model")):
    """Small mesh for tests (a process group of >= prod(shape) ranks)."""
    return build_mesh(shape, axes)
