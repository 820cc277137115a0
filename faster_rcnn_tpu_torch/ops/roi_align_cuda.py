"""Wrapper of the RoI-align kernel (csrc/roi_align.cu), forward only.

Replaces faster_rcnn_tpu/ops/roi_align_pallas.py ``roi_align_pallas``. One
launch pools every ROI of a batch.
"""

from __future__ import annotations

import torch

from faster_rcnn_tpu_torch import _build
from faster_rcnn_tpu_torch.ops.roi_align import roi_align_batched

_ENTRY = {torch.bfloat16: "frcnn_roi_align_bf16", torch.float32: "frcnn_roi_align_f32"}


def roi_align_plain(features: torch.Tensor, rois: torch.Tensor, pool_size: int = 7) -> torch.Tensor:
    """The kernel's plain version: the gather form computed in f32, cast to
    ``features``' dtype."""
    return roi_align_batched(features.float(), rois, pool_size).to(features.dtype)


def roi_align(features: torch.Tensor, rois: torch.Tensor, pool_size: int = 7) -> torch.Tensor:
    """(B, H, W, C) NHWC features x (B, R, 4) f32 integer-valued ROIs ->
    (B, R, P, P, C) in ``features``' dtype. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel."""
    if features.dim() != 4 or rois.dim() != 3 or rois.shape[-1] != 4 \
            or rois.shape[0] != features.shape[0]:
        raise ValueError(f"want features (B, H, W, C) and rois (B, R, 4), got "
                         f"{tuple(features.shape)} and {tuple(rois.shape)}")
    if features.device.type == "cpu":
        return roi_align_plain(features, rois, pool_size)
    if features.device.type != "cuda" or rois.device != features.device:
        raise ValueError(f"roi_align: unsupported devices {features.device}, {rois.device}")
    if features.dtype not in _ENTRY or rois.dtype != torch.float32:
        raise TypeError(f"roi_align wants bf16/f32 features and f32 rois, got "
                        f"{features.dtype}, {rois.dtype}")
    b, h, w, c = features.shape
    r = rois.shape[1]
    if c % (16 // features.element_size()) != 0:
        raise ValueError(f"roi_align: C={c} must fill whole 16-byte vectors")
    if not (features.is_contiguous() and rois.is_contiguous()):
        raise ValueError("roi_align wants contiguous NHWC features and ROIs")
    out = torch.empty((b, r, pool_size, pool_size, c), dtype=features.dtype,
                      device=features.device)
    if out.numel() == 0:
        return out
    lib = _build.lib()
    err = getattr(lib, _ENTRY[features.dtype])(
        features.data_ptr(), rois.data_ptr(), out.data_ptr(), b, h, w, c, r, pool_size,
        _build.stream_ptr(features))
    _build.check(err, "roi_align")
    _build.count_launch("roi_align")
    return out
