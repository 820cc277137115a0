"""RoI feature extraction: crop and TF1-bilinear resize, plain PyTorch.

Counterpart of faster_rcnn_tpu/ops/roi_align.py. ROI coords are integers in
feature-map space, ``[x1, y1, x2, y2]``, the crop being ``img[y1:y2, x1:x2]``
(custom_layers.py:40-52). The resize follows TF1 ``resize_images`` bilinear
defaults: the source coordinate of output cell ``i`` is ``i * (crop / P)``,
with taps ``floor(src)`` and ``min(floor(src) + 1, crop - 1)``.

The detection path and the train step run the CUDA kernels behind
:func:`faster_rcnn_tpu_torch.ops.roi_align_cuda.roi_align`; the functions
here are their plain version (:func:`roi_align_batched`, the gather form,
whose autograd is the plain backward) and a test oracle
(:func:`roi_align_einsum`).
"""

from __future__ import annotations

import torch


def roi_align(features: torch.Tensor, rois: torch.Tensor, pool_size: int = 7) -> torch.Tensor:
    """(H, W, C) x (R, 4) -> (R, P, P, C) by four tap gathers, interpolated
    in ``features``' dtype (call with f32 features for the f32 version)."""
    return roi_align_batched(features[None], rois[None], pool_size)[0]


def roi_align_batched(features: torch.Tensor, rois: torch.Tensor,
                      pool_size: int = 7) -> torch.Tensor:
    """(B, H, W, C) x (B, R, 4) -> (B, R, P, P, C), the gather form of
    faster_rcnn_tpu's ``roi_align`` written out over the batch."""
    b, h, w, c = features.shape
    r = rois.shape[1]
    p = pool_size
    rois = rois.float()
    x1, y1 = rois[..., 0], rois[..., 1]
    crop_w = rois[..., 2] - x1
    crop_h = rois[..., 3] - y1

    out_idx = torch.arange(p, dtype=torch.float32, device=features.device)
    src_y = out_idx * (crop_h[..., None] / p)                     # (B, R, P)
    src_x = out_idx * (crop_w[..., None] / p)
    y0 = torch.floor(src_y)
    x0 = torch.floor(src_x)
    fy = src_y - y0
    fx = src_x - x0
    y0 = y0 + y1[..., None]
    x0 = x0 + x1[..., None]
    ya = torch.clamp(y0, 0, h - 1).long()
    yb = torch.clamp(torch.minimum(y0 + 1, (y1 + crop_h - 1)[..., None]), 0, h - 1).long()
    xa = torch.clamp(x0, 0, w - 1).long()
    xb = torch.clamp(torch.minimum(x0 + 1, (x1 + crop_w - 1)[..., None]), 0, w - 1).long()

    flat = features.reshape(b, h * w, c)

    def gather(yy, xx):
        lin = (yy[:, :, :, None] * w + xx[:, :, None, :]).reshape(b, r * p * p)
        return torch.gather(flat, 1, lin[..., None].expand(-1, -1, c)).reshape(b, r, p, p, c)

    f00 = gather(ya, xa)
    f01 = gather(ya, xb)
    f10 = gather(yb, xa)
    f11 = gather(yb, xb)
    fy_ = fy[:, :, :, None, None].to(features.dtype)
    fx_ = fx[:, :, None, :, None].to(features.dtype)
    top = f00 + (f01 - f00) * fx_
    bot = f10 + (f11 - f10) * fx_
    return top + (bot - top) * fy_


def _tap_weights(starts: torch.Tensor, crops: torch.Tensor, limit: int, pool: int) -> torch.Tensor:
    """TF1 bilinear tap weight matrix (R, P, limit) along one axis; rows sum
    to 1 and coalesce when both taps coincide."""
    starts = starts.float()
    crops = crops.float()
    out_idx = torch.arange(pool, dtype=torch.float32, device=starts.device)
    src = out_idx[None, :] * (crops[:, None] / pool)
    lo = torch.floor(src)
    frac = src - lo
    lo_abs = torch.clamp(lo + starts[:, None], 0, limit - 1)
    hi_abs = torch.clamp(torch.minimum(lo + 1, crops[:, None] - 1) + starts[:, None], 0, limit - 1)
    grid = torch.arange(limit, dtype=torch.float32, device=starts.device)[None, None, :]
    return ((grid == lo_abs[:, :, None]) * (1.0 - frac[:, :, None])
            + (grid == hi_abs[:, :, None]) * frac[:, :, None])


def roi_align_einsum(features: torch.Tensor, rois: torch.Tensor, pool_size: int = 7) -> torch.Tensor:
    """RoI align as two separable contractions with the tap-weight matrices;
    the same taps as :func:`roi_align`. Kept as a test oracle."""
    h, w, c = features.shape
    rois = rois.float()
    wx = _tap_weights(rois[:, 0], rois[:, 2] - rois[:, 0], w, pool_size)
    wy = _tap_weights(rois[:, 1], rois[:, 3] - rois[:, 1], h, pool_size)
    f32 = features.float()
    tmp = torch.einsum("rjx,yxc->rjyc", wx, f32)
    out = torch.einsum("riy,rjyc->rijc", wy, tmp)
    return out.to(features.dtype)
