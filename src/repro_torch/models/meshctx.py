"""Ambient mesh for model code that runs a parallel path (the JAX
package's ``models/meshctx.py``).

A caller installs a mesh with ``with mesh_context(mesh):`` around the
model calls that should run on it; the model functions that have a
parallel form (context-parallel attention, the expert-parallel MoE, the
row-parallel matmul) fetch it here. `current_mesh` is None where no mesh is
installed, and the model runs on one process as before.

The mesh is a torch ``DeviceMesh`` of ``torch.distributed`` ranks, or,
where only its names and shape are wanted (the dry run's production
meshes), a `launch.mesh.MeshShape`. `axis_sizes` reads either;
`model_group` needs the ranks, so only a ``DeviceMesh`` runs a parallel
path.
"""
from __future__ import annotations

import contextlib
import contextvars

_MESH = contextvars.ContextVar("repro_torch_mesh", default=None)


@contextlib.contextmanager
def mesh_context(mesh):
    """Install `mesh` as the current mesh for the block."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def current_mesh():
    """The mesh installed by the innermost `mesh_context`, or None."""
    return _MESH.get()


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` or a `launch.mesh.MeshShape`,
    in the mesh's axis order."""
    names = getattr(mesh, "mesh_dim_names", None) or mesh.axis_names
    return dict(zip(names, tuple(mesh.shape)))


def model_size(mesh) -> int:
    """Ranks on `mesh`'s "model" axis: 1 without a mesh or that axis."""
    if mesh is None:
        return 1
    return axis_sizes(mesh).get("model", 1)


def model_group(mesh):
    """(process group, this rank's index, size) of `mesh`'s "model" axis.
    Raises TypeError for a mesh that has no ranks (a `MeshShape`)."""
    if not hasattr(mesh, "get_group"):
        raise TypeError(f"a parallel path runs on a DeviceMesh of ranks, "
                        f"not on {mesh!r}")
    return (mesh.get_group("model"), mesh.get_local_rank("model"),
            model_size(mesh))


def data_groups(mesh) -> list:
    """The process groups of `mesh`'s data axes ("pod", "data"), in mesh
    order."""
    return [mesh.get_group(a) for a in axis_sizes(mesh)
            if a in ("pod", "data")]
