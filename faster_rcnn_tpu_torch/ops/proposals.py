"""RPN output -> region proposals, batched over images.

Counterpart of faster_rcnn_tpu/ops/proposals.py: decode against the static
conv-space anchor grid with banker's rounding, clip to each image's actual
conv extent, mask anchors over canvas padding to NEG_INF, keep the top
``pre_nms`` by score, then exact greedy NMS to ``post_nms``.

The top-k is a stable descending ``torch.sort``: ties keep ascending index,
as ``lax.top_k`` does (``torch.topk`` does not promise that order).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from faster_rcnn_tpu_torch.ops import boxes as box_ops
from faster_rcnn_tpu_torch.ops import nms as nms_ops
from faster_rcnn_tpu_torch.ops.targets import BBREG_MULTIPLIERS


class Proposals(NamedTuple):
    boxes: torch.Tensor   # (B, post_nms, 4) float32, feature-map coords
    scores: torch.Tensor  # (B, post_nms)
    valid: torch.Tensor   # (B, post_nms) bool


def position_validity(conv_h: int, conv_w: int, num_anchors: int, device=None):
    """Returns fn(rows, cols) -> (B, conv_h*conv_w*A) bool marking anchors
    whose grid cell lies inside each image's (rows, cols) extent; ``rows``
    and ``cols`` are (B,) integer tensors."""
    ys = torch.as_tensor(np.repeat(np.arange(conv_h), conv_w * num_anchors), device=device)
    xs = torch.as_tensor(np.tile(np.repeat(np.arange(conv_w), num_anchors), conv_h),
                         device=device)

    def fn(rows, cols):
        return (ys[None, :] < rows[:, None]) & (xs[None, :] < cols[:, None])

    return fn


def generate_proposals(rpn_cls_prob: torch.Tensor, rpn_bbreg: torch.Tensor,
                       conv_anchors: torch.Tensor, pos_valid: torch.Tensor, rows: torch.Tensor,
                       cols: torch.Tensor, pre_nms: int, post_nms: int,
                       iou_thresh: float = 0.7, nms_tile: int = 256) -> Proposals:
    """Proposals of a batch.

    Args:
      rpn_cls_prob: (B, h, w, A) objectness probabilities.
      rpn_bbreg: (B, h, w, 4A) regression output (multiplier-scaled).
      conv_anchors: (h*w*A, 4) conv-space anchor grid.
      pos_valid: (B, h*w*A) bool, anchor cell inside the image's conv extent.
      rows, cols: (B,) actual conv dims of each image.
    """
    b = rpn_cls_prob.shape[0]
    n = conv_anchors.shape[0]
    probs = rpn_cls_prob.reshape(b, n).float()
    deltas = rpn_bbreg.reshape(b, n, 4).float()

    mult = BBREG_MULTIPLIERS.to(deltas.device)
    rois = box_ops.decode(conv_anchors[None], deltas / mult)
    rois = box_ops.clip_to_grid(rois, rows[:, None], cols[:, None])
    valid = box_ops.valid_mask(rois) & pos_valid

    pre_nms = min(pre_nms, n)
    masked = torch.where(valid, probs, torch.full_like(probs, nms_ops.NEG_INF))
    top_scores, top_idx = torch.sort(masked, dim=1, descending=True, stable=True)
    top_scores, top_idx = top_scores[:, :pre_nms], top_idx[:, :pre_nms]
    top_boxes = torch.gather(rois, 1, top_idx[..., None].expand(-1, -1, 4))
    top_valid = top_scores > nms_ops.NEG_INF / 2

    boxes, scores, ok = nms_ops.nms_topk(top_boxes, top_scores, top_valid, post_nms, iou_thresh,
                                         tile=nms_tile, presorted=True)
    return Proposals(boxes=boxes, scores=scores, valid=ok)
