"""Device mesh construction and canonical shardings.

Port of ``fastmatch_tpu/dist/mesh.py`` on ``torch.distributed``: one
process (rank) per device, and the ranks laid out as a (data, bank)
``DeviceMesh``.

Axes:
- ``data``: independent image pairs or frames (data parallelism);
- ``bank``: descriptor-bank and map-block shards. The ring matcher
  (``dist/sharded_match.py``) passes bank shards round this axis.

A JAX ``NamedSharding`` places an array's rows on the devices; here each
rank holds the whole tensor or its slice, so a sharding is the rank's row
slice along one axis (``RowSharding.shard``) and the all-gather that
undoes it (``RowSharding.gather``), or with no axis (``replicated``) the
whole tensor on every rank.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

AXES = ("data", "bank")


def make_mesh(n_data: int = 1, n_bank: int | None = None, device_type: str | None = None):
    """A (data, bank) ``DeviceMesh`` over the ranks of the default process
    group (``dist/bootstrap.initialize_distributed``): ``n_bank`` defaults
    to the ranks left over by ``n_data``; ``device_type`` to the group's
    (``cuda`` under NCCL, ``cpu`` under gloo)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("no process group: call dist.bootstrap.initialize_distributed first")
    n = dist.get_world_size()
    if n_bank is None:
        n_bank = n // n_data
    if n_data * n_bank != n:
        raise ValueError(f"mesh {n_data}x{n_bank} != {n} devices")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n_data, n_bank), mesh_dim_names=AXES)


def axis_size(mesh, axis: str) -> int:
    """The number of ranks along ``axis`` (JAX's ``mesh.shape[axis]``)."""
    return mesh[axis].size()


def axis_rank(mesh, axis: str) -> int:
    """This rank's index along ``axis`` (JAX's ``lax.axis_index``)."""
    return mesh.get_local_rank(axis)


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The group's slices of ``x`` stacked along dim 0 in group-rank order
    (one collective; JAX's tiled ``all_gather``)."""
    x = x.contiguous()
    out = torch.empty((group.size() * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.all_gather_into_tensor(out, x, group=group)
    return out


class RowSharding(NamedTuple):
    """Rows split evenly along one mesh axis, or (``axis`` None) whole on
    every rank."""

    mesh: object
    axis: str | None

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's contiguous row slice of ``x`` (whose row count must
        divide by the axis size)."""
        if self.axis is None:
            return x
        n = axis_size(self.mesh, self.axis)
        if x.shape[0] % n:
            raise ValueError(f"{x.shape[0]} rows do not divide by the {self.axis} axis "
                             f"size {n}")
        rows = x.shape[0] // n
        i = axis_rank(self.mesh, self.axis)
        return x[i * rows:(i + 1) * rows]

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The whole tensor back from every rank's slice."""
        if self.axis is None:
            return x
        return all_gather_rows(x, self.mesh.get_group(self.axis))


def bank_sharding(mesh) -> RowSharding:
    """Descriptor banks and map blocks: rows split over ``bank``."""
    return RowSharding(mesh, "bank")


def batch_sharding(mesh) -> RowSharding:
    """Leading batch axis split over ``data`` (independent pairs)."""
    return RowSharding(mesh, "data")


def replicated(mesh) -> RowSharding:
    """Every rank holds the whole tensor (JAX's ``P()``)."""
    return RowSharding(mesh, None)

