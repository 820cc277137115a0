"""Wrapper of the RoI-align kernels (csrc/roi_align.cu), forward and backward,
as one ``torch.autograd.Function``.

Replaces faster_rcnn_tpu/ops/roi_align_pallas.py ``roi_align_pallas`` and its
custom VJP. One launch pools every ROI of a batch; one launch scatters the
pooled cotangent of a batch back into the feature map. The ROIs take no
gradient: the train step computes them under ``no_grad``, as the JAX step
puts them under ``stop_gradient``.
"""

from __future__ import annotations

import torch

from faster_rcnn_tpu_torch import _build
from faster_rcnn_tpu_torch.ops.roi_align import roi_align_batched

_ENTRY = {torch.bfloat16: "frcnn_roi_align_bf16", torch.float32: "frcnn_roi_align_f32"}
_ENTRY_BWD = {torch.bfloat16: "frcnn_roi_align_bwd_bf16", torch.float32: "frcnn_roi_align_bwd_f32"}


def roi_align_plain(features: torch.Tensor, rois: torch.Tensor, pool_size: int = 7) -> torch.Tensor:
    """The forward kernel's plain version: the gather form computed in f32,
    cast to ``features``' dtype. Autograd through it is the backward's plain
    version."""
    return roi_align_batched(features.float(), rois, pool_size).to(features.dtype)


def roi_align_backward_plain(grad: torch.Tensor, rois: torch.Tensor, feature_shape,
                             dtype: torch.dtype, pool_size: int = 7) -> torch.Tensor:
    """The backward kernel's plain version: autograd of the f32 gather form
    (a scatter-add of the four taps), rounded once to ``dtype``. The map's
    values do not enter, since RoI align is linear in it."""
    feat = torch.zeros(feature_shape, dtype=torch.float32, device=grad.device, requires_grad=True)
    with torch.enable_grad():
        out = roi_align_batched(feat, rois, pool_size)
        (dfeat,) = torch.autograd.grad(out, feat, grad.float())
    return dfeat.to(dtype)


def _check_cuda(features: torch.Tensor, rois: torch.Tensor, name: str) -> None:
    if features.device.type != "cuda" or rois.device != features.device:
        raise ValueError(f"{name}: unsupported devices {features.device}, {rois.device}")
    if features.dtype not in _ENTRY or rois.dtype != torch.float32:
        raise TypeError(f"{name} wants bf16/f32 features and f32 rois, got "
                        f"{features.dtype}, {rois.dtype}")
    if features.shape[-1] % (16 // features.element_size()) != 0:
        raise ValueError(f"{name}: C={features.shape[-1]} must fill whole 16-byte vectors")
    if not (features.is_contiguous() and rois.is_contiguous()):
        raise ValueError(f"{name} wants contiguous NHWC tensors and ROIs")


def _forward(features: torch.Tensor, rois: torch.Tensor, pool_size: int) -> torch.Tensor:
    if features.device.type == "cpu":
        return roi_align_plain(features, rois, pool_size)
    _check_cuda(features, rois, "roi_align")
    b, h, w, c = features.shape
    r = rois.shape[1]
    out = torch.empty((b, r, pool_size, pool_size, c), dtype=features.dtype,
                      device=features.device)
    if out.numel() == 0:
        return out
    err = getattr(_build.lib(), _ENTRY[features.dtype])(
        features.data_ptr(), rois.data_ptr(), out.data_ptr(), b, h, w, c, r, pool_size,
        _build.stream_ptr(features))
    _build.check(err, "roi_align")
    _build.count_launch("roi_align")
    return out


def roi_align_backward(grad: torch.Tensor, rois: torch.Tensor, feature_shape,
                       pool_size: int = 7) -> torch.Tensor:
    """(B, R, P, P, C) cotangent of the pooled features -> (B, H, W, C)
    gradient of the map in ``grad``'s dtype, summed in f32. A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel."""
    b, h, w, c = feature_shape
    r = rois.shape[1]
    if tuple(grad.shape) != (b, r, pool_size, pool_size, c) or tuple(rois.shape) != (b, r, 4):
        raise ValueError(f"roi_align_backward: grad {tuple(grad.shape)} and rois "
                         f"{tuple(rois.shape)} do not fit a map of {tuple(feature_shape)}")
    if grad.device.type == "cpu":
        return roi_align_backward_plain(grad, rois, feature_shape, grad.dtype, pool_size)
    _check_cuda(grad, rois, "roi_align_backward")
    dfeat = torch.empty(tuple(feature_shape), dtype=grad.dtype, device=grad.device)
    if dfeat.numel() == 0 or grad.numel() == 0:
        return dfeat.zero_()
    # the f32 accumulator: the result itself in f32, a scratch copy in bf16
    acc = dfeat if grad.dtype == torch.float32 else torch.empty(
        tuple(feature_shape), dtype=torch.float32, device=grad.device)
    err = getattr(_build.lib(), _ENTRY_BWD[grad.dtype])(
        grad.data_ptr(), rois.data_ptr(), acc.data_ptr(), dfeat.data_ptr(), b, h, w, c, r,
        pool_size, _build.stream_ptr(grad))
    _build.check(err, "roi_align_bwd")
    _build.count_launch("roi_align_bwd")
    return dfeat


class _RoiAlign(torch.autograd.Function):
    @staticmethod
    def forward(ctx, features, rois, pool_size):
        ctx.save_for_backward(rois)
        ctx.feature_shape, ctx.pool_size = tuple(features.shape), pool_size
        return _forward(features, rois, pool_size)

    @staticmethod
    def backward(ctx, grad):
        (rois,) = ctx.saved_tensors
        dfeat = roi_align_backward(grad.contiguous(), rois, ctx.feature_shape, ctx.pool_size)
        return dfeat, None, None


def roi_align(features: torch.Tensor, rois: torch.Tensor, pool_size: int = 7) -> torch.Tensor:
    """(B, H, W, C) NHWC features x (B, R, 4) f32 integer-valued ROIs ->
    (B, R, P, P, C) in ``features``' dtype, differentiable in ``features``."""
    if features.dim() != 4 or rois.dim() != 3 or rois.shape[-1] != 4 \
            or rois.shape[0] != features.shape[0]:
        raise ValueError(f"want features (B, H, W, C) and rois (B, R, 4), got "
                         f"{tuple(features.shape)} and {tuple(rois.shape)}")
    return _RoiAlign.apply(features, rois.detach(), pool_size)
