"""Shared model building blocks.

Counterpart of faster_rcnn_tpu/models/layers.py plus the convolution and
dense layers that Flax provides there. The frozen batch norm and the channel
scale go through :class:`FrozenAffine`, the counterpart of the JAX
package's ``_frozen_affine`` custom VJP. Activations are NHWC, as in the JAX
package; a convolution hands PyTorch the NCHW view of an NHWC tensor, which
has channels_last strides, so no copy is made on the way in or out.
Parameters are float32 and cast to the layer's compute dtype at use, as
Flax's ``param_dtype=float32, dtype=...`` does.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

# Flax lecun_normal / truncated_normal draw from a normal truncated at two
# standard deviations, rescaled so the result has the nominal stddev.
_TRUNC_STD = 0.87962566103423978


def trunc_normal_(t: torch.Tensor, std: float, generator: torch.Generator) -> torch.Tensor:
    return nn.init.trunc_normal_(t, std=std, a=-2.0 * std, b=2.0 * std, generator=generator)


def lecun_normal_(t: torch.Tensor, fan_in: int, generator: torch.Generator) -> torch.Tensor:
    return trunc_normal_(t, math.sqrt(1.0 / fan_in) / _TRUNC_STD, generator)


class Conv2d(nn.Module):
    """``flax.linen.Conv`` with SAME padding for odd kernels at stride 1 and
    1x1 kernels at any stride (no padding there), on NHWC tensors. Weights
    are OIHW."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, bias: bool = True,
                 dtype: torch.dtype = torch.bfloat16, init_std: float | None = None):
        super().__init__()
        if k % 2 == 0 or (stride != 1 and k != 1):
            raise ValueError(f"SAME padding of a {k}x{k}/s{stride} conv is not symmetric")
        self.stride, self.padding, self.dtype = stride, (k - 1) // 2, dtype
        self.init_std = init_std  # None: lecun normal
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        fan_in = self.weight[0].numel()
        with torch.no_grad():
            if self.init_std is None:
                lecun_normal_(self.weight, fan_in, generator)
            else:
                trunc_normal_(self.weight, self.init_std, generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        bias = None if self.bias is None else self.bias.to(dt)
        y = F.conv2d(x.to(dt).permute(0, 3, 1, 2), self.weight.to(dt), bias,
                     self.stride, self.padding)
        return y.permute(0, 2, 3, 1)


class Dense(nn.Module):
    """``flax.linen.Dense`` in float32; weight stored (out, in)."""

    def __init__(self, cin: int, cout: int, init_std: float):
        super().__init__()
        self.init_std = init_std
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            trunc_normal_(self.weight, self.init_std, generator)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.float(), self.weight, self.bias)


class FrozenAffine(torch.autograd.Function):
    """``y = (f32(x) - mean) * inv + bias`` cast back to ``x``'s dtype, with
    the backward of faster_rcnn_tpu's ``_frozen_affine``: ``dx = cot *
    inv`` in the cotangent's dtype, and no gradient for ``mean``, ``inv`` or
    ``bias`` (their parameters are frozen by the freeze rules). PyTorch's
    own autograd of the forward would give ``dx`` in f32 behind an extra
    cast and reduce the per-channel gradients over every map. ``mean=None``
    is the zero mean of the channel scale."""

    @staticmethod
    def forward(ctx, x, mean, inv, bias):
        ctx.save_for_backward(inv)
        # x - mean promotes to f32 inside the one kernel, and addcmul computes
        # bias + centred * inv: three passes over the map instead of five
        centred = x.float() if mean is None else x - mean
        return torch.addcmul(bias, centred, inv).to(x.dtype)

    @staticmethod
    def backward(ctx, cot):
        (inv,) = ctx.saved_tensors
        return cot * inv.to(cot.dtype), None, None, None


class FrozenBatchNorm(nn.Module):
    """Inference-only batch norm over the last axis:
    ``((f32(x) - mean) * inv + bias)`` cast back to the working dtype, with
    ``inv = scale / sqrt(var + eps)``, in this order (not folded into the
    conv), as faster_rcnn_tpu's ``_frozen_affine`` computes it."""

    def __init__(self, c: int, epsilon: float = 1e-5, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.epsilon, self.dtype = epsilon, dtype
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()
            self.mean.zero_()
            self.var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = self.scale / torch.sqrt(self.var + self.epsilon)
        return FrozenAffine.apply(x.to(self.dtype), self.mean, inv, self.bias)


class ChannelScale(nn.Module):
    """Per-channel ``gamma * x + beta`` (the Caffe-style ResNet-101's Scale
    layer), computed as the frozen affine with zero mean."""

    def __init__(self, c: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return FrozenAffine.apply(x.to(self.dtype), None, self.scale, self.bias)
