"""Box geometry on tensors: IoU matrices, bbox-regression encode/decode,
clipping. Counterpart of faster_rcnn_tpu/ops/boxes.py, same arithmetic in the
same order, always in float32.

Boxes are ``[x1, y1, x2, y2]`` corner format throughout.
"""

from __future__ import annotations

import torch


def area(boxes: torch.Tensor) -> torch.Tensor:
    """Plain ``(x2-x1)*(y2-y1)`` area (reference util.py:46-51)."""
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def area_plus_one(boxes: torch.Tensor) -> torch.Tensor:
    """``(x2-x1+1)*(y2-y1+1)`` area used by NMS and VOC evaluation."""
    return (boxes[..., 2] - boxes[..., 0] + 1.0) * (boxes[..., 3] - boxes[..., 1] + 1.0)


def iou_matrix(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """All-pairs IoU, result[..., i, j] = IoU(boxes1[..., i], boxes2[..., j])
    over (..., N, 4) x (..., M, 4) with broadcast leading axes; no +1
    convention, zero-area unions give 0."""
    b1 = boxes1.float()[..., :, None, :]
    b2 = boxes2.float()[..., None, :, :]
    inter_w = torch.clamp_min(
        torch.minimum(b1[..., 2], b2[..., 2]) - torch.maximum(b1[..., 0], b2[..., 0]), 0.0)
    inter_h = torch.clamp_min(
        torch.minimum(b1[..., 3], b2[..., 3]) - torch.maximum(b1[..., 1], b2[..., 1]), 0.0)
    inter = inter_w * inter_h
    union = area(boxes1.float())[..., :, None] + area(boxes2.float())[..., None, :] - inter
    pos = union > 0
    return torch.where(pos, inter / torch.where(pos, union, torch.ones_like(union)),
                       torch.zeros_like(union))


def encode(anchors: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Regression targets (tx, ty, tw, th) of ``gt`` against ``anchors``;
    degenerate rows give zeros."""
    anchors = anchors.float()
    gt = gt.float()
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    acx = (anchors[..., 0] + anchors[..., 2]) / 2.0
    acy = (anchors[..., 1] + anchors[..., 3]) / 2.0
    gw = gt[..., 2] - gt[..., 0]
    gh = gt[..., 3] - gt[..., 1]
    gcx = (gt[..., 0] + gt[..., 2]) / 2.0
    gcy = (gt[..., 1] + gt[..., 3]) / 2.0

    valid = (aw > 0) & (ah > 0) & (gw > 0) & (gh > 0)
    one = torch.ones_like(aw)
    saw = torch.where(valid, aw, one)
    sah = torch.where(valid, ah, one)
    sgw = torch.where(valid, gw, one)
    sgh = torch.where(valid, gh, one)
    t = torch.stack([(gcx - acx) / saw, (gcy - acy) / sah,
                     torch.log(sgw / saw), torch.log(sgh / sah)], dim=-1)
    return torch.where(valid[..., None], t, torch.zeros_like(t))


def decode(anchors: torch.Tensor, deltas: torch.Tensor, round_coords: bool = True) -> torch.Tensor:
    """Apply regression deltas to anchors. ``round_coords`` rounds x1, y1, w,
    h half to even (``torch.round``, like ``jnp.round``) before x2 = x1 + w."""
    anchors = anchors.float()
    deltas = deltas.float()
    w = anchors[..., 2] - anchors[..., 0]
    h = anchors[..., 3] - anchors[..., 1]
    cx = anchors[..., 0] + w / 2.0
    cy = anchors[..., 1] + h / 2.0
    cx = cx + deltas[..., 0] * w
    cy = cy + deltas[..., 1] * h
    nw = torch.exp(deltas[..., 2]) * w
    nh = torch.exp(deltas[..., 3]) * h
    x1 = cx - nw / 2.0
    y1 = cy - nh / 2.0
    if round_coords:
        x1, y1, nw, nh = torch.round(x1), torch.round(y1), torch.round(nw), torch.round(nh)
    return torch.stack([x1, y1, x1 + nw, y1 + nh], dim=-1)


def clip_to_grid(boxes: torch.Tensor, rows, cols) -> torch.Tensor:
    """Clip boxes to a feature grid: min width/height 1 first, then x1, y1 >=
    0 and x2 <= cols-1, y2 <= rows-1. ``rows``/``cols`` are numbers or
    tensors that broadcast against ``boxes[..., 0]``."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    x2 = torch.maximum(x1 + 1, x2)
    y2 = torch.maximum(y1 + 1, y2)
    x1 = torch.clamp_min(x1, 0)
    y1 = torch.clamp_min(y1, 0)
    x2 = torch.minimum(torch.as_tensor(cols - 1, dtype=x2.dtype, device=x2.device), x2)
    y2 = torch.minimum(torch.as_tensor(rows - 1, dtype=y2.dtype, device=y2.device), y2)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def valid_mask(boxes: torch.Tensor) -> torch.Tensor:
    """Positive width and height."""
    return (boxes[..., 2] > boxes[..., 0]) & (boxes[..., 3] > boxes[..., 1])
