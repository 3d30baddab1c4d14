"""Meshes (the JAX package's ``launch/mesh.py``).

A test mesh is a torch ``DeviceMesh`` over the ranks of the default
process group, which the caller starts first
(``torch.distributed.init_process_group`` with its own address, world
size and rank: nothing here reads a cluster's environment). A
``DeviceMesh`` exists only where its ranks do, and one process cannot
build the production meshes' 256 or 512 ranks, so `make_production_mesh`
returns a `MeshShape`: axis names and shape alone. The spec functions
(`launch.sharding`) read names and sizes only, through `data_axes` and
`axis_size`, so they take either.

The production shapes are the reference's, so that the port's specs can
be held to its specs leaf for leaf: (16, 16) ``("data", "model")`` and
(2, 16, 16) ``("pod", "data", "model")``, the reference's TPU v5e pods of
256 chips in a 16 x 16 torus, two of them across the slower links between
pods. They say nothing about how H100s are wired.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.models.meshctx import axis_sizes


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and shape, without ranks."""

    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """The reference's single-pod (16, 16) ``("data", "model")`` mesh, or
    with `multi_pod` its (2, 16, 16) ``("pod", "data", "model")`` one, as
    a `MeshShape`."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_test_mesh(shape=(1, 1), axes=("data", "model"), *,
                   device_type=None):
    """A ``DeviceMesh`` of `shape` named `axes` over the default process
    group's ranks (its world size must be the product of `shape`), for
    tensors on `device_type` (None: ``cuda``, which raises without one)."""
    if not dist.is_initialized():
        raise RuntimeError("make_test_mesh needs the default process group: "
                           "call torch.distributed.init_process_group first")
    device_type = resolve_device(device_type).type
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def data_axes(mesh) -> tuple:
    """The mesh's data axes ("pod", "data"), in mesh order."""
    return tuple(a for a in axis_sizes(mesh) if a in ("pod", "data"))


def model_axis(mesh) -> str:
    """The tensor- and expert-parallel axis: ``"model"``."""
    return "model"


def axis_size(mesh, name) -> int:
    """The size of axis `name` of `mesh`."""
    return axis_sizes(mesh)[name]

