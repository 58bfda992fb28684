"""Device meshes and grid-axis sharding on ``torch.distributed``.

PyTorch port of ``sdfs_via_autodiff_tpu/parallel/mesh.py``.  The iterate
w lives on a tensor-product grid and every operator is a chain of
per-axis contractions, so the parallelism is *grid sharding*: w is laid
out over a mesh of devices on one or two grid axes.  A mesh is a
:class:`torch.distributed.device_mesh.DeviceMesh` with two axes named
``dp`` (the leading, current-state grid axis) and ``tp`` (a second grid
axis) by convention; a sharded field is a
:class:`torch.distributed.tensor.DTensor`, the counterpart of a
``jax.Array`` with a ``NamedSharding``, and a sharding is the tuple of
its ``Shard``/``Replicate`` placements, one per mesh axis.

JAX has one controller over every device; here each device is driven by
its own process (a rank of the default process group, which the caller
initializes: ``torchrun`` sets its environment, a test spawns its
ranks), and every rank calls these functions with the same arguments.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import resolve_device

__all__ = ["make_mesh", "grid_sharding", "shard_grid_array",
           "replicated_sharding", "mesh_device"]


def mesh_device(mesh) -> torch.device:
    """The torch device this rank's shard of ``mesh`` lives on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Tuple[str, str] = ("dp", "tp"),
              shape: Optional[Tuple[int, int]] = None, *,
              device="cuda"):
    """A 2-D mesh over the first ``n_devices`` ranks of the default
    process group (all of them by default), on ``device``'s type.

    ``shape`` fixes the (dp, tp) factorization; the default is the
    most-square one with dp the larger axis (8 -> 4x2, 4 -> 2x2, 2 ->
    2x1, 1 -> 1x1).  Raises ``ValueError`` for more devices than ranks
    or a shape that does not multiply to the count, and
    ``RuntimeError`` when no process group is initialized.  On CUDA each
    rank must have selected its card (``torch.cuda.set_device``).
    """
    from torch.distributed.device_mesh import DeviceMesh
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_mesh needs an initialized torch.distributed process "
            "group (torchrun's environment, or init_process_group with an "
            "address, a world size and a rank)")
    dev_type = resolve_device(device).type
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n > world:
        raise ValueError(f"requested {n} devices, have {world}")
    if shape is None:
        tp = 1
        for cand in range(int(np.sqrt(n)), 0, -1):
            if n % cand == 0:
                tp = cand
                break
        shape = (n // tp, tp)
    if shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {tuple(shape)} != device count {n}")
    return DeviceMesh(dev_type, torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axis_names))


def grid_sharding(mesh, ndim: int, axis_map: Optional[dict] = None):
    """The placements that put mesh axes onto grid axes of a rank-``ndim``
    field (one per mesh axis: ``Shard(grid axis)`` or ``Replicate()``).

    ``axis_map`` maps a grid axis to a mesh axis name, or to a tuple of
    names (that grid axis is split over them in mesh order); the default
    puts ``dp`` on axis 0 and ``tp`` (if the mesh has more than one
    device on it) on axis 1.
    """
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    if axis_map is None:
        axis_map = {0: names[0]}
        if len(names) > 1 and mesh.size(1) > 1:
            axis_map[1] = names[1]
    placements = [Replicate()] * mesh.ndim
    for axis, mesh_axes in axis_map.items():
        if mesh_axes is None:
            continue
        if not 0 <= axis < ndim:
            raise ValueError(f"grid axis {axis} out of range for ndim {ndim}")
        if isinstance(mesh_axes, str):
            mesh_axes = (mesh_axes,)
        for name in mesh_axes:
            d = names.index(name)
            if not isinstance(placements[d], Replicate):
                raise ValueError(f"mesh axis {name!r} mapped twice")
            placements[d] = Shard(axis)
    return tuple(placements)


def replicated_sharding(mesh):
    from torch.distributed.tensor import Replicate
    return (Replicate(),) * mesh.ndim


def shard_grid_array(w, mesh, axis_map: Optional[dict] = None):
    """``w`` as a DTensor on ``mesh`` with :func:`grid_sharding` (pads
    nothing: grid axes must be divisible by the mesh axes they map to).
    Every rank passes the same full field."""
    from torch.distributed.tensor import distribute_tensor
    w = torch.as_tensor(w).to(mesh_device(mesh))
    return distribute_tensor(w, mesh, grid_sharding(mesh, w.dim(), axis_map))
