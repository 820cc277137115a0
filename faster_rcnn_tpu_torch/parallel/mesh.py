"""The process mesh: the world's ranks as a (data, model) grid.

Counterpart of faster_rcnn_tpu/parallel/mesh.py. The JAX package lays its
devices out as a ('data', 'model') mesh and lets XLA insert the
collectives; the port lays the ``torch.distributed`` ranks out the same way,
model-minor (``rank = data_index * model + model_index``, JAX's
``reshape(data, model)``), and its code calls the collectives over two
kinds of group:

  * a data column, the ranks with this rank's model index: they hold the
    same parameters (or the same shard of them) and different rows of the
    batch, so the gradients are averaged over it;
  * a model row, the ranks with this rank's data index: they hold the same
    rows of the batch and different shards of VGG16's fc head
    (parallel/sharding.py), so the head's partial sums are added over it.

Everything else is replicated.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from faster_rcnn_tpu_torch.parallel import multihost


@dataclasses.dataclass(frozen=True)
class Mesh:
    grid: np.ndarray     # (data, model) ranks
    data_index: int      # this rank's coordinates in the grid
    model_index: int
    data_group: object   # the process group of this rank's data column
    model_group: object  # ... of its model row; both None on a (world, 1)
                         # mesh: its data column is the default group, and
                         # a model row of one rank has nothing to sum

    @property
    def data(self) -> int:
        return int(self.grid.shape[0])

    @property
    def model(self) -> int:
        return int(self.grid.shape[1])


def create_mesh(data: Optional[int] = None, model: int = 1) -> Mesh:
    """The world's ranks as a (data, model) grid, with the group of each
    data column and each model row. Every rank creates every group, in the
    same order, as ``torch.distributed.new_group`` requires; so every rank
    must call this, with the same arguments. The data-parallel mesh
    (``model=1``, the default) makes no group: its collectives run over the
    default group, so that building it once a training step costs nothing.
    Needs an initialized process group (parallel/multihost.maybe_initialize),
    whose ranks the grid must hold exactly."""
    if not multihost.is_initialized():
        raise RuntimeError("create_mesh needs a process group: call "
                           "parallel.multihost.maybe_initialize() first")
    world, rank = dist.get_world_size(), dist.get_rank()
    data = world // model if data is None else data
    if data * model != world:
        raise ValueError(f"a {data}x{model} mesh over {world} ranks")
    grid = np.arange(world).reshape(data, model)
    d, m = divmod(rank, model)
    if model == 1:  # the data column is the world: its default group
        return Mesh(grid, d, m, None, None)
    groups = {}
    for mi in range(model):
        groups[("data", mi)] = dist.new_group(grid[:, mi].tolist())
    for di in range(data):
        groups[("model", di)] = dist.new_group(grid[di, :].tolist())
    return Mesh(grid, d, m, groups[("data", m)], groups[("model", d)])


def shard_batch(mesh: Mesh, batch: Dict) -> Dict:
    """This rank's rows of a global batch, a dict of (B, ...) arrays or
    tensors: rows ``[d * B/data, (d+1) * B/data)`` for data index ``d``."""
    b = len(next(iter(batch.values())))
    lb = multihost.local_batch_size(b, mesh.data)
    lo = mesh.data_index * lb
    return {k: v[lo:lo + lb] for k, v in batch.items()}


@torch.no_grad()
def replicated(mesh: Mesh, state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Rank 0's tensors on every rank of ``mesh``'s world: each tensor of
    ``state_dict`` (on the process group's device: the card for NCCL) is
    overwritten in place by rank 0's. A model's ``state_dict()`` shares its
    parameters' and buffers' storage, so this replicates the model. Returns
    the dict."""
    for t in state_dict.values():
        dist.broadcast(t, src=0)
    return state_dict
