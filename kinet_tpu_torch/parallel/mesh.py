"""The ("data", "model") process mesh (port of
``kinet_tpu/parallel/mesh.py``).

The JAX package lays a ``jax.sharding.Mesh`` over its devices and lets
GSPMD place the collectives. PyTorch has no GSPMD, so the port's mesh is
a grid of processes of the initialised ``torch.distributed`` group
(``utils/dist.py``) with a subgroup for each axis:

- a **model group** is ``n_model`` consecutive ranks: they hold the shards
  of one tensor-parallel model (``parallel/tp.py``), step the same
  samples and average the replicated parameters' gradients;
- a **data group** is the ranks with the same position in their model
  group: they hold the same shards and average their gradients
  (``utils/dist.py::all_reduce_grads``).

Without a process group the mesh is 1 x 1: its groups are None and every
collective over it is skipped, so a run with that mesh is the run with
no mesh, bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch.distributed as tdist

from ..utils import dist


@dataclass(frozen=True)
class Mesh:
    """A rank's view of the mesh: the axis sizes, its coordinates, and the
    two subgroups it belongs to (None where the axis has one process)."""

    data: int
    model: int
    data_rank: int
    model_rank: int
    data_group: Optional[object] = None
    model_group: Optional[object] = None
    axis_names: tuple = ("data", "model")

    @property
    def data_world(self) -> int:
        return self.data

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.model}


def make_mesh(n_data: int = -1, n_model: int = 1) -> Mesh:
    """The mesh over the initialised process group (1 x 1 without one).

    ``n_data = -1`` means ``world // n_model``. Model groups are
    consecutive ranks: rank = data_rank * n_model + model_rank. Every rank
    of the group must call this, in the same order as every other group
    creation (``torch.distributed.new_group`` is collective)."""
    world, rank = dist.get_world_size(), dist.get_rank()
    n_model = int(n_model)
    if n_model < 1:
        raise ValueError(f"mesh.model {n_model} must be at least 1")
    asked = int(n_data)
    n_data = world // n_model if asked == -1 else asked
    if n_data * n_model != world:
        raise ValueError(f"mesh.data {asked} x mesh.model {n_model} != "
                         f"{world} processes")
    data_rank, model_rank = divmod(rank, n_model)
    data_group = model_group = None
    if world > 1:
        # every rank creates every group, in one order
        for d in range(n_data):
            ranks = list(range(d * n_model, (d + 1) * n_model))
            g = tdist.new_group(ranks) if n_model > 1 else None
            if d == data_rank:
                model_group = g
        for m in range(n_model):
            ranks = list(range(m, world, n_model))
            if n_data == 1:
                g = None
            elif n_model == 1:
                g = tdist.group.WORLD
            else:
                g = tdist.new_group(ranks)
            if m == model_rank:
                data_group = g
    return Mesh(n_data, n_model, data_rank, model_rank, data_group,
                model_group)


def mesh_of(model) -> Mesh:
    """The mesh that ``parallel/tp.py::shard_params_tp`` put on ``model``,
    else the data-parallel mesh over every process (its data group is the
    default group, no subgroup is created)."""
    mesh = getattr(model, "tp_mesh", None)
    if mesh is not None:
        return mesh
    world, rank = dist.get_world_size(), dist.get_rank()
    return Mesh(world, 1, rank, 0,
                tdist.group.WORLD if world > 1 else None, None)
