"""ResNet-50 / ResNet-101 backbones and the post-RoI stage-5 head.

Counterpart of faster_rcnn_tpu/models/resnet.py. ResNet-101 is the
Caffe-style model: bias-free convs, each batch norm followed by a channel
scale (``scale...``), and blocks ``a, b1..b3`` in stage 3 and ``a, b1..b22``
in stage 4. Module names are the Keras layer names of the Flax tree
(``conv1``, ``bn_conv1``, ``res2a.res2a_branch2a``, ``res2a.bn2a_branch2a``,
``res2a.scale2a_branch2a``, ...), so weights map across by name
(utils/convert.py) and the freeze rules read the same names
(:func:`resnet_param_block`, :func:`is_norm_param`). Activations are NHWC.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from faster_rcnn_tpu_torch import _build
from faster_rcnn_tpu_torch.models.layers import (ChannelScale, Conv2d, FrozenBatchNorm,
                                                  lecun_normal_)
from faster_rcnn_tpu_torch.ops.conv1_cuda import conv1 as conv1_kernel
from faster_rcnn_tpu_torch.ops.frozen_epilogue_cuda import frozen_epilogue

# (stage, blocks, filters, first stride) of stages 2-4, by depth
_STAGES = {
    50: ((2, ("a", "b", "c"), (64, 64, 256), 1),
         (3, ("a", "b", "c", "d"), (128, 128, 512), 2),
         (4, ("a", "b", "c", "d", "e", "f"), (256, 256, 1024), 2)),
    101: ((2, ("a", "b", "c"), (64, 64, 256), 1),
          (3, ("a", "b1", "b2", "b3"), (128, 128, 512), 2),
          (4, ("a",) + tuple(f"b{i}" for i in range(1, 23)), (256, 256, 1024), 2)),
}


def _autograd_runs(x: torch.Tensor, *modules: nn.Module) -> bool:
    return torch.is_grad_enabled() and (
        x.requires_grad or any(p.requires_grad for m in modules for p in m.parameters()))


def _epilogue(y: torch.Tensor, conv_bias, bn: FrozenBatchNorm, scale: ChannelScale | None,
              shortcut: torch.Tensor | None = None, relu: bool = False) -> torch.Tensor:
    """``bn``, ``scale`` (or None), ``+ shortcut`` and the ReLU on a conv's
    output ``y`` (and its bias first, unless None), in one frozen-epilogue
    pass: the plain modules' result bit for bit, without autograd."""
    _build.FROZEN_BRANCHES["fused"] += 1
    return frozen_epilogue(y, conv_bias, bn.mean, bn.inv(), bn.bias,
                           None if scale is None else scale.scale,
                           None if scale is None else scale.bias, shortcut, relu)


def _conv_for_epilogue(conv: Conv2d, x: torch.Tensor):
    """(the conv's output, the bias the epilogue still has to add). cuDNN
    adds a conv's bias in a pass of its own after the product, which the
    epilogue takes over; oneDNN on the CPU adds it inside the product,
    before the rounding, so there the conv keeps it."""
    if conv.bias is None or x.device.type == "cpu":
        return conv(x), None
    return conv.without_bias(x), conv.bias.to(conv.dtype)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 with frozen BN, and a projection shortcut on the
    first block of a stage. The stride sits on the first 1x1, as in Keras.
    ``caffe``: bias-free convs and a channel scale after each batch norm
    (ResNet-101). Where no autograd runs, each branch's bias, norms, the
    residual add and the ReLU go through the frozen epilogue."""

    def __init__(self, cin: int, filters, stage: int, block: str, stride: int = 1,
                 project: bool = False, caffe: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        f1, f2, f3 = filters
        self.names = tuple(f"{kind}{stage}{block}_branch" for kind in ("res", "bn", "scale"))
        self.project, self.caffe = project, caffe
        branches = [("2a", cin, f1, 1, stride), ("2b", f1, f2, 3, 1), ("2c", f2, f3, 1, 1)]
        if project:
            branches.append(("1", cin, f3, 1, stride))
        nb, bn, sc = self.names
        for suffix, ci, co, k, s in branches:
            self.add_module(nb + suffix, Conv2d(ci, co, k, s, bias=not caffe, dtype=dtype))
            self.add_module(bn + suffix, FrozenBatchNorm(co, dtype=dtype))
            if caffe:
                self.add_module(sc + suffix, ChannelScale(co, dtype=dtype))

    def _branch(self, x: torch.Tensor, suffix: str) -> torch.Tensor:
        _build.FROZEN_BRANCHES["plain"] += 1
        nb, bn, sc = self.names
        m = self._modules
        y = m[bn + suffix](m[nb + suffix](x))
        return m[sc + suffix](y) if self.caffe else y

    def _fused(self, x: torch.Tensor, suffix: str, shortcut=None, relu=True) -> torch.Tensor:
        nb, bn, sc = self.names
        m = self._modules
        y, bias = _conv_for_epilogue(m[nb + suffix], x)
        return _epilogue(y, bias, m[bn + suffix], m[sc + suffix] if self.caffe else None,
                         shortcut, relu)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not _autograd_runs(x, self):
            y = self._fused(self._fused(x, "2a"), "2b")
            sc = self._fused(x, "1", relu=False) if self.project else x
            return self._fused(y, "2c", shortcut=sc)
        y = F.relu(self._branch(x, "2a"))
        y = F.relu(self._branch(y, "2b"))
        y = self._branch(y, "2c")
        sc = self._branch(x, "1") if self.project else x
        return F.relu(y + sc)


def _stage(cin: int, stage: int, blocks, filters, first_stride: int, caffe: bool,
           dtype) -> nn.Sequential:
    seq = nn.Sequential()
    for i, b in enumerate(blocks):
        seq.add_module(f"res{stage}{b}", Bottleneck(
            cin if i == 0 else filters[2], filters, stage, b,
            stride=first_stride if i == 0 else 1, project=(i == 0), caffe=caffe, dtype=dtype))
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

    def without_bias(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        w_hwio = self.weight.to(dt).permute(2, 3, 1, 0).contiguous()
        return conv1_kernel(x.to(dt).contiguous(), w_hwio)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.without_bias(x)
        return y if self.bias is None else y + self.bias.to(self.dtype)


class ResNetBackbone(nn.Module):
    """conv1 + stages 2-4: (B, H, W, 3) -> (B, H/16, W/16, 1024) for canvas
    dims that are multiples of 32. Stage 1 is conv1, its batch norm (and
    channel scale at depth 101), the ReLU and the max-pool; stages 2-4 are
    the ``res{stage}*`` blocks."""

    last_stage = 4

    def __init__(self, depth: int = 50, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if depth not in _STAGES:
            raise ValueError(f"ResNet depth {depth}: 50 or 101")
        self.dtype, self.caffe = dtype, depth == 101
        self.conv1 = Conv1(use_bias=not self.caffe, dtype=dtype)
        self.bn_conv1 = FrozenBatchNorm(64, dtype=dtype)
        if self.caffe:
            self.scale_conv1 = ChannelScale(64, dtype=dtype)
        cin = 64
        for stage, blocks, filters, stride in _STAGES[depth]:
            for name, mod in _stage(cin, stage, blocks, filters, stride, self.caffe,
                                    dtype).named_children():
                self.add_module(name, mod)
            cin = filters[2]

    def _stage(self, x: torch.Tensor, stage: int) -> torch.Tensor:
        if stage == 1:
            scale = self.scale_conv1 if self.caffe else None
            stem = [m for m in (self.conv1, self.bn_conv1, scale) if m is not None]
            if _autograd_runs(x, *stem):
                _build.FROZEN_BRANCHES["plain"] += 1
                x = self.bn_conv1(self.conv1(x))
                x = F.relu(scale(x) if self.caffe else x)
            else:
                bias = self.conv1.bias
                x = _epilogue(self.conv1.without_bias(x), None if bias is None else
                              bias.to(self.dtype), self.bn_conv1, scale, relu=True)
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
        return self.run_stages(x.to(self.dtype), 1, self.last_stage, stop_grad_stage)


class ResNetStage5(nn.Module):
    """(N, 7, 7, 1024) pooled ROIs -> (N, 2048): three stride-1 bottlenecks,
    then the 7x7 mean, taken in f32 and rounded to the compute dtype as
    ``jnp.mean`` over bf16 does."""

    def __init__(self, depth: int = 50, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if depth not in _STAGES:
            raise ValueError(f"ResNet depth {depth}: 50 or 101")
        self.dtype = dtype
        for name, mod in _stage(1024, 5, ("a", "b", "c"), (512, 512, 2048), 1, depth == 101,
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
