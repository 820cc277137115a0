"""Tensor parallelism for VGG16's fc head, Megatron-style.

Counterpart of faster_rcnn_tpu/parallel/sharding.py, which places the
detector head's fc1 (25088x4096) and fc2 (4096x4096), 118M of VGG16's
parameters, on the mesh's 'model' axis and lets GSPMD insert the one
all-reduce. Here the split is explicit, over the model row of a
parallel/mesh.Mesh:

  * fc1 is column-parallel: each rank holds 4096/m of its outputs (rows of
    its (out, in) weight, and of its bias);
  * fc2 is row-parallel: each rank holds 4096/m of its inputs (columns of
    its weight); the partial products are summed over the model row and
    the whole bias is added once, after the sum.

Two operators carry the collectives: :class:`CopyToModel` (Megatron's *f*:
the identity forward, an all-reduce of the gradient backward) at fc1's
input, and :class:`ReduceFromModel` (*g*: an all-reduce forward, the
identity backward) at fc2's output. Everything else stays replicated.

No entry point splits the head yet: ``train_one_step``, ``train_cached``
and ``cli.train`` train on a data-parallel mesh, and their checkpoints
refuse a split one (train/trainer.save_state). The split runs in the tests
and in scripts/bench_multi_gpu_torch.py, as the JAX package's runs in its
tests and its multi-chip dry run.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from faster_rcnn_tpu_torch.models.heads import VggDetHead
from faster_rcnn_tpu_torch.models.layers import Dense


def split_dim(name: str) -> Optional[int]:
    """The dimension along which a parameter of the given state-dict name
    is split over the model row, None for a replicated one (JAX's
    ``_pspec_for`` in the port's (out, in) weight layout)."""
    keys = name.split(".")
    if "fc1" in keys:
        return 0  # column parallel: the outputs, weight rows and bias
    if "fc2" in keys and keys[-1] == "weight":
        return 1  # row parallel: the inputs; the bias is replicated
    return None


class CopyToModel(torch.autograd.Function):
    """Megatron's *f*: the identity forward; backward, the gradient summed
    over the model row (each rank's fc1 shard gives only its share of the
    input's gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class ReduceFromModel(torch.autograd.Function):
    """Megatron's *g*: forward, the partial products summed over the model
    row; the identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class ColumnParallelDense(Dense):
    """fc1's shard: ``Dense`` over this rank's outputs, its input passed
    through *f*."""

    def __init__(self, cin: int, cout: int, group, dtype: torch.dtype):
        super().__init__(cin, cout, dtype=dtype)
        self.group = group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(CopyToModel.apply(x, self.group))


class RowParallelDense(Dense):
    """fc2's shard: this rank's inputs' share of the product, summed over
    the model row by *g*, then the whole bias, once. Each partial product is
    rounded to the compute dtype before the sum, which adds in that dtype:
    in bf16 that is one rounding more a rank than ``Dense``'s one product
    rounding; in f32 the sums only run in another order."""

    def __init__(self, cin: int, cout: int, group, dtype: torch.dtype):
        super().__init__(cin, cout, dtype=dtype)
        self.group = group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        part = F.linear(x.to(dt), self.weight.to(dt))
        return ReduceFromModel.apply(part, self.group) + self.bias.to(dt)


def _shard(t: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    if t.shape[dim] % mesh.model:
        raise ValueError(f"{tuple(t.shape)} does not split {mesh.model} ways along {dim}")
    return t.chunk(mesh.model, dim)[mesh.model_index].contiguous()


def shard_params(state_dict: Dict[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """This rank's shards of a full state dict: the split parameters cut
    along :func:`split_dim`, the rest as they are."""
    out = {}
    for name, t in state_dict.items():
        dim = split_dim(name)
        out[name] = t if dim is None else _shard(t, dim, mesh)
    return out


@torch.no_grad()
def gather_params(state_dict: Dict[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """The full state dict from every rank's shards (an all-gather over the
    model row for each split parameter): for checkpoints and handoffs. The
    tensors are moved as raw bytes, whatever their dtype."""
    out = {}
    for name, t in state_dict.items():
        dim = split_dim(name)
        if dim is None or mesh.model == 1:
            out[name] = t
            continue
        t = t.contiguous()
        raw = t.view(torch.uint8) if t.dim() else t
        parts = [torch.empty_like(raw) for _ in range(mesh.model)]
        dist.all_gather(parts, raw, group=mesh.model_group)
        out[name] = torch.cat([p.view(t.dtype) for p in parts], dim)
    return out


def shard_vgg_head(model: nn.Module, mesh) -> nn.Module:
    """Swap the VGG16 detector head's ``fc1`` and ``fc2`` for their split
    forms, holding this rank's shards of their current weights; the model
    is changed in place and returned. Its state dict keeps the names, with
    the shards' shapes. Build the optimizer after this (it must see the new
    parameters)."""
    head = model.det_head
    if not isinstance(head, VggDetHead):
        raise ValueError(f"only VGG16's fc head splits; this is a {type(head).__name__}")
    if mesh.model == 1:
        raise ValueError("a mesh of one model rank does not split the fc head")
    for name, cls in (("fc1", ColumnParallelDense), ("fc2", RowParallelDense)):
        full: Dense = getattr(head, name)
        state = shard_params({f"{name}.{k}": v for k, v in full.state_dict().items()}, mesh)
        w = state[f"{name}.weight"]
        with torch.device(w.device):
            shard = cls(w.shape[1], w.shape[0], mesh.model_group, full.dtype)
        shard.load_state_dict({k.split(".", 1)[1]: v for k, v in state.items()})
        setattr(head, name, shard)
    return model
