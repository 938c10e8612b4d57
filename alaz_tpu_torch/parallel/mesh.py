"""Mesh construction over ``torch.distributed``.

Axes (SURVEY §2.3): ``dp`` data-parallel over window batches, ``tp``
tensor-parallel over hidden dims, ``ep`` expert-parallel over edge-type
experts, ``sp`` sequence/temporal-parallel over node shards (halo layer).
All four axes always exist (size 1 collapses harmlessly), so the
partition specs are stable across topologies. A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the initialized
default process group, one rank per device; each axis's process group
(``axis_group``) carries that axis's collectives.

The JAX package's ``shard_map`` shim has no counterpart: the port's
parallel code is written per rank (each rank runs the function on its
own shard and calls the collectives of ``collectives.py`` itself), so
there is no program to map over the mesh.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from alaz_tpu_torch.config import MeshConfig
from alaz_tpu_torch.device import resolve_device

AXES = ("dp", "tp", "ep", "sp")


def mesh_shape_for(n_devices: int, tp: int = 1, ep: int = 1, sp: int = 1) -> MeshConfig:
    """Fill dp with whatever the other axes leave over."""
    rest = tp * ep * sp
    assert n_devices % rest == 0, f"{n_devices} devices not divisible by tp*ep*sp={rest}"
    return MeshConfig(dp=n_devices // rest, tp=tp, ep=ep, sp=sp)


def _device_type(device) -> str:
    """The mesh's device type: ``cuda`` unless the caller asks for the
    CPU; a ``cuda`` request without a card raises."""
    return resolve_device(device).type


def make_mesh(cfg: MeshConfig | None = None, device=None):
    """The ``(dp, tp, ep, sp)`` mesh over every rank of the initialized
    default group, on ``device`` (default ``cuda``; ``cpu`` on request).
    The mesh's size must equal the world size."""
    from torch.distributed.device_mesh import init_device_mesh

    device_type = _device_type(device)
    n = dist.get_world_size()
    if cfg is None:
        cfg = mesh_shape_for(n)
    shape = (cfg.dp, cfg.tp, cfg.ep, cfg.sp)
    assert int(torch.tensor(shape).prod()) == n, f"mesh {shape} != {n} devices"
    return init_device_mesh(device_type, shape, mesh_dim_names=AXES)


def axis_group(mesh, axis: str):
    """The process group of the mesh axis ``axis``: the ranks that share
    every other coordinate with this one."""
    return mesh.get_group(axis)


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of a mesh (``jax.sharding.Mesh.shape``)."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))
