"""The ResNet stem convolution (7x7, stride 2, SAME, 3 -> 64 channels, NHWC):
wrapper of the kernel in csrc/conv1.cu and its plain version.

Replaces faster_rcnn_tpu/ops/conv1_pallas.py ``conv1_pallas_v2`` (and the v1
``conv1_pallas``, the same function). :func:`conv1_plain` is the counterpart
of ``conv1_xla``. The backward is no kernel, in the JAX package either
(conv1_pallas.py:163-166 takes XLA's VJP of ``conv1_xla``): it is autograd
of :func:`conv1_plain`. The stem is frozen in every production schedule, so
the train step cuts the backward before it; the backward runs when
``freeze_blocks`` leaves the stem trainable.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from faster_rcnn_tpu_torch import _build

_ENTRY = {torch.bfloat16: "frcnn_conv1_bf16", torch.float32: "frcnn_conv1_f32"}


def conv1_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) x (7, 7, 3, 64) HWIO -> (B, H/2, W/2, 64), computed in
    f32 and cast to ``x``'s dtype. Flax SAME for 7x7/s2 on even H, W pads 2
    rows and columns before and 3 after, so the padding is explicit."""
    xn = F.pad(x.float().permute(0, 3, 1, 2), (2, 3, 2, 3))
    y = F.conv2d(xn, w.float().permute(3, 2, 0, 1), stride=2)
    return y.permute(0, 2, 3, 1).contiguous().to(x.dtype)


def _forward(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    b, h, wd, _ = x.shape
    if x.device.type == "cpu":
        return conv1_plain(x, w)
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"conv1: unsupported devices {x.device}, {w.device}")
    if x.dtype not in _ENTRY or w.dtype != x.dtype:
        raise TypeError(f"conv1 wants bf16 or f32 x and w of one dtype, got {x.dtype}, {w.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("conv1 wants contiguous NHWC x and HWIO w")
    out = torch.empty((b, h // 2, wd // 2, 64), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = _build.lib()
    err = getattr(lib, _ENTRY[x.dtype])(x.data_ptr(), w.data_ptr(), out.data_ptr(), b, h, wd,
                                        _build.stream_ptr(x))
    _build.check(err, "conv1")
    _build.count_launch("conv1")
    return out


class _Conv1(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _forward(x, w)

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        need = ctx.needs_input_grad
        xd, wd = x.detach().requires_grad_(need[0]), w.detach().requires_grad_(need[1])
        with torch.enable_grad():
            out = conv1_plain(xd, wd)
            wanted = [t for t, n in zip((xd, wd), need) if n]
            grads = iter(torch.autograd.grad(out, wanted, grad))
        return tuple(next(grads) if n else None for n in need)


def conv1(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Stem conv without bias, f32 accumulation, output in ``x``'s dtype,
    differentiable in ``x`` and ``w``. A CPU tensor takes the plain version;
    a CUDA tensor launches the kernel."""
    if x.dim() != 4 or x.shape[-1] != 3 or tuple(w.shape) != (7, 7, 3, 64):
        raise ValueError(f"want x (B, H, W, 3) and w (7, 7, 3, 64), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError(f"stem canvas dims must be even, got {x.shape[1]}x{x.shape[2]}")
    return _Conv1.apply(x, w)
