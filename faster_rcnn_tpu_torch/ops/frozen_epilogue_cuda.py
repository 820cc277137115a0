"""The frozen epilogue: a ResNet convolution's bias, frozen batch norm,
channel scale, residual add and ReLU in one pass (csrc/frozen_epilogue.cu),
and its plain version.

Replaces no ``pallas_call``: the JAX package's ``_frozen_affine``
(faster_rcnn_tpu/models/layers.py) is plain jnp, which XLA fuses with the
bias, the residual add and the ReLU on the TPU. Eager PyTorch runs each as a
pass of its own over the map; the kernel reads the conv's output once (and
the shortcut once) and writes once, with the same roundings. Its bound is
those bytes: 0.279 ms for stage 2's (16, 152, 376, 256) bf16 map, 0.863 ms
for stage 5's (4800, 7, 7, 2048) with its shortcut, at 3.35 TB/s. It has no
backward: models/resnet.py calls it only where no autograd runs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from faster_rcnn_tpu_torch import _build

_ENTRY = {torch.bfloat16: "frcnn_frozen_epilogue_bf16",
          torch.float32: "frcnn_frozen_epilogue_f32"}


def frozen_epilogue_plain(y, conv_bias, mean, inv, bn_bias, scale=None, scale_bias=None,
                          shortcut=None, relu=False):
    """The passes the kernel replaces, as the modules run them: ``y +
    conv_bias`` in ``y``'s dtype; FrozenAffine's batch norm and, where
    ``scale`` is given, its channel scale, each rounded to that dtype;
    ``+ shortcut``; ``F.relu``."""
    if conv_bias is not None:
        y = y + conv_bias
    y = torch.addcmul(bn_bias, y - mean, inv).to(y.dtype)
    if scale is not None:
        y = torch.addcmul(scale_bias, y.float(), scale).to(y.dtype)
    if shortcut is not None:
        y = y + shortcut
    return F.relu(y) if relu else y


def _check(y, conv_bias, consts, shortcut) -> None:
    if y.device.type != "cuda":
        raise ValueError(f"frozen_epilogue: unsupported device {y.device}")
    if y.dtype not in _ENTRY:
        raise TypeError(f"frozen_epilogue wants a bf16 or f32 map, got {y.dtype}")
    c = y.shape[-1] if y.dim() else 0
    if c == 0 or c % (16 // y.element_size()):
        raise ValueError(f"frozen_epilogue wants channels last in 16-byte vectors, got "
                         f"{tuple(y.shape)} {y.dtype}")
    for t in (y, shortcut):
        if t is not None and not (t.is_contiguous() and t.data_ptr() % 16 == 0):
            raise ValueError("frozen_epilogue wants contiguous 16-byte aligned maps")
    if shortcut is not None and (shortcut.shape != y.shape or shortcut.dtype != y.dtype
                                 or shortcut.device != y.device):
        raise ValueError(f"shortcut {tuple(shortcut.shape)} {shortcut.dtype} does not match "
                         f"{tuple(y.shape)} {y.dtype}")
    for t, dt in [(conv_bias, y.dtype)] + [(t, torch.float32) for t in consts]:
        if t is not None and (t.shape != (c,) or t.dtype != dt or t.device != y.device
                              or not t.is_contiguous()):
            raise ValueError(f"frozen_epilogue wants ({c},) per-channel {dt} on {y.device}, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (y, conv_bias, shortcut, *consts)):
        raise RuntimeError("frozen_epilogue has no backward: call it without autograd")


def frozen_epilogue(y: torch.Tensor, conv_bias, mean, inv, bn_bias, scale=None, scale_bias=None,
                    shortcut=None, relu: bool = False) -> torch.Tensor:
    """``y`` (..., C) NHWC conv output without its bias -> the same shape
    and dtype: :func:`frozen_epilogue_plain`, bit for bit. ``conv_bias``
    (C,) in ``y``'s dtype, or None; ``mean``, ``inv``, ``bn_bias`` and
    ``scale``, ``scale_bias`` (both or neither) (C,) f32; ``shortcut`` like
    ``y``, or None. A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel."""
    if (scale is None) != (scale_bias is None):
        raise ValueError("frozen_epilogue wants scale and scale_bias together")
    if y.device.type == "cpu":
        return frozen_epilogue_plain(y, conv_bias, mean, inv, bn_bias, scale, scale_bias,
                                     shortcut, relu)
    consts = [t for t in (mean, inv, bn_bias, scale, scale_bias) if t is not None]
    _check(y, conv_bias, consts, shortcut)
    out = torch.empty_like(y)
    if out.numel() == 0:
        return out

    def ptr(t):
        return None if t is None else t.data_ptr()

    _build.launch("frozen_epilogue", _ENTRY[y.dtype], y, y.data_ptr(), ptr(conv_bias),
                  mean.data_ptr(), inv.data_ptr(), bn_bias.data_ptr(), ptr(scale),
                  ptr(scale_bias), ptr(shortcut), out.data_ptr(), y.numel(), y.shape[-1],
                  int(relu))
    return out
