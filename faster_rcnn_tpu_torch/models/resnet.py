"""ResNet-50 backbone and the post-RoI stage-5 head.

Counterpart of faster_rcnn_tpu/models/resnet.py (depth 50; the Caffe-style
ResNet-101 waits for a later slice). Module names are the Keras layer names
of the Flax tree (``conv1``, ``bn_conv1``, ``res2a.res2a_branch2a``,
``res2a.bn2a_branch2a``, ...), so weights map across by name
(utils/convert.py) and the freeze rules read the same names
(:func:`resnet_param_block`, :func:`is_norm_param`). Activations are NHWC.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from faster_rcnn_tpu_torch.models.layers import Conv2d, FrozenBatchNorm, lecun_normal_
from faster_rcnn_tpu_torch.ops.conv1_cuda import conv1 as conv1_kernel

_STAGES_50 = (
    (2, ("a", "b", "c"), (64, 64, 256), 1),
    (3, ("a", "b", "c", "d"), (128, 128, 512), 2),
    (4, ("a", "b", "c", "d", "e", "f"), (256, 256, 1024), 2),
)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 with frozen BN, and a projection shortcut on the
    first block of a stage. The stride sits on the first 1x1, as in Keras."""

    def __init__(self, cin: int, filters, stage: int, block: str, stride: int = 1,
                 project: bool = False, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        f1, f2, f3 = filters
        nb = f"res{stage}{block}_branch"
        bn = f"bn{stage}{block}_branch"
        self.names = (nb, bn)
        self.project = project
        self.add_module(nb + "2a", Conv2d(cin, f1, 1, stride, dtype=dtype))
        self.add_module(bn + "2a", FrozenBatchNorm(f1, dtype=dtype))
        self.add_module(nb + "2b", Conv2d(f1, f2, 3, 1, dtype=dtype))
        self.add_module(bn + "2b", FrozenBatchNorm(f2, dtype=dtype))
        self.add_module(nb + "2c", Conv2d(f2, f3, 1, 1, dtype=dtype))
        self.add_module(bn + "2c", FrozenBatchNorm(f3, dtype=dtype))
        if project:
            self.add_module(nb + "1", Conv2d(cin, f3, 1, stride, dtype=dtype))
            self.add_module(bn + "1", FrozenBatchNorm(f3, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        nb, bn = self.names
        m = self._modules
        y = F.relu(m[bn + "2a"](m[nb + "2a"](x)))
        y = F.relu(m[bn + "2b"](m[nb + "2b"](y)))
        y = m[bn + "2c"](m[nb + "2c"](y))
        sc = m[bn + "1"](m[nb + "1"](x)) if self.project else x
        return F.relu(y + sc)


def _stage(cin: int, stage: int, blocks, filters, first_stride: int, dtype) -> nn.Sequential:
    seq = nn.Sequential()
    for i, b in enumerate(blocks):
        seq.add_module(f"res{stage}{b}", Bottleneck(
            cin if i == 0 else filters[2], filters, stage, b,
            stride=first_stride if i == 0 else 1, project=(i == 0), dtype=dtype))
    return seq


class Conv1(nn.Module):
    """The 7x7/s2 SAME stem conv, 3 -> 64 channels, through the stem kernel
    (ops/conv1_cuda.py); the bias is added afterwards in the compute dtype."""

    def __init__(self, use_bias: bool = True, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(64, 3, 7, 7))
        self.bias = nn.Parameter(torch.zeros(64)) if use_bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            lecun_normal_(self.weight, 7 * 7 * 3, generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        w_hwio = self.weight.to(dt).permute(2, 3, 1, 0).contiguous()
        y = conv1_kernel(x.to(dt).contiguous(), w_hwio)
        if self.bias is not None:
            y = y + self.bias.to(dt)
        return y


class ResNetBackbone(nn.Module):
    """conv1 + stages 2-4: (B, H, W, 3) -> (B, H/16, W/16, 1024) for canvas
    dims that are multiples of 32. Stage 1 is conv1, its batch norm, the
    ReLU and the max-pool; stages 2-4 are the ``res{stage}*`` blocks."""

    def __init__(self, depth: int = 50, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if depth != 50:
            raise ValueError(f"only ResNet-50 is ported so far, not depth {depth}")
        self.dtype = dtype
        self.conv1 = Conv1(use_bias=True, dtype=dtype)
        self.bn_conv1 = FrozenBatchNorm(64, dtype=dtype)
        cin = 64
        for stage, blocks, filters, stride in _STAGES_50:
            for name, mod in _stage(cin, stage, blocks, filters, stride, dtype).named_children():
                self.add_module(name, mod)
            cin = filters[2]

    def _stage(self, x: torch.Tensor, stage: int) -> torch.Tensor:
        if stage == 1:
            x = F.relu(self.bn_conv1(self.conv1(x)))
            # 3x3/s2 VALID max-pool (resnet.py:413), on the channels_last NCHW view
            return F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2).permute(0, 2, 3, 1)
        for name, mod in self.named_children():
            if name.startswith(f"res{stage}"):
                x = mod(x)
        return x

    def run_stages(self, x: torch.Tensor, first: int, last: int,
                   stop_grad_stage: int = 0) -> torch.Tensor:
        """Stages ``first`` .. ``last`` on ``x``. A stage at or below
        ``stop_grad_stage`` runs without autograd: that is the JAX package's
        ``stop_gradient`` after stage k (resnet.py:134-144), the same update,
        and the frozen prefix keeps no activations for a backward."""
        grad = torch.is_grad_enabled()
        for stage in range(first, last + 1):
            with torch.set_grad_enabled(grad and stage > stop_grad_stage):
                x = self._stage(x, stage)
        return x

    def forward(self, x: torch.Tensor, stop_grad_stage: int = 0) -> torch.Tensor:
        return self.run_stages(x.to(self.dtype), 1, 4, stop_grad_stage)


class ResNetStage5(nn.Module):
    """(N, 7, 7, 1024) pooled ROIs -> (N, 2048): three stride-1 bottlenecks,
    then the 7x7 mean, taken in f32 and rounded to the compute dtype as
    ``jnp.mean`` over bf16 does."""

    def __init__(self, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        for name, mod in _stage(1024, 5, ("a", "b", "c"), (512, 512, 2048), 1,
                                dtype).named_children():
            self.add_module(name, mod)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for mod in self.children():
            x = mod(x)
        return x.float().mean(dim=(1, 2)).to(x.dtype)


def resnet_param_block(path: Sequence[str]) -> int | None:
    """The stage a parameter belongs to, for the freeze rules: conv1 and its
    batch norm are stage 1 (resnet.py:408-413 train1), ``res4b...`` stage
    4, ``res5a...`` in the detector head stage 5; None outside any stage.
    ``path`` is the parameter's name split at the dots."""
    for p in path:
        if p in ("conv1", "bn_conv1", "scale_conv1"):
            return 1
        for prefix in ("res", "bn", "scale"):
            if p.startswith(prefix):
                rest = p[len(prefix):]
                if rest and rest[0].isdigit():
                    return int(rest[0])
    return None


def is_norm_param(path: Sequence[str]) -> bool:
    """True for batch-norm and channel-scale parameters, which never train
    (resnet.py bn_training=False)."""
    return any(p.startswith("bn") or p.startswith("scale") for p in path)
