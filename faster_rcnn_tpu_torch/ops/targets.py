"""Training-target assignment for the RPN and the detector head, batched
over images.

Counterpart of faster_rcnn_tpu/ops/targets.py: ``rpn_targets``
(rpn_util.py:54-140) gives flat per-anchor masks and targets;
``det_targets`` (det_util.py:310-366) gives a class id and four regression
values per proposal. Dynamic-count operations become boolean masks over
static shapes; padded ground-truth rows are masked out of the IoU columns.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from faster_rcnn_tpu_torch.ops import boxes as box_ops
from faster_rcnn_tpu_torch.ops.sampling import subsample_rpn_anchors

BBREG_MULTIPLIERS = torch.tensor([10.0, 10.0, 5.0, 5.0], dtype=torch.float32)  # shared_constants.py:5


class RpnTargets(NamedTuple):
    cls_mask: torch.Tensor    # (B, N) bool, anchor enters the cls loss
    cls_target: torch.Tensor  # (B, N) bool, anchor is a positive
    reg_mask: torch.Tensor    # (B, N) bool, anchor enters the bbreg loss
    reg_target: torch.Tensor  # (B, N, 4) float32, multiplier-scaled


def rpn_targets(u_pos: torch.Tensor, u_neg: torch.Tensor, anchors: torch.Tensor,
                gt_boxes: torch.Tensor, gt_valid: torch.Tensor, img_w: torch.Tensor,
                img_h: torch.Tensor, pos_iou: float = 0.7, neg_iou: float = 0.3,
                sample_size: int = 256, max_pos: int = 128) -> RpnTargets:
    """RPN targets of a batch.

    Args:
      u_pos, u_neg: (B, N) uniform priorities of the anchor sampler.
      anchors: (N, 4) image-space anchor grid.
      gt_boxes: (B, G, 4) padded ground truth, image space; gt_valid (B, G).
      img_w, img_h: (B,) actual image dims; anchors crossing them are
        excluded (rpn_util.py:302-310).

    Positives: IoU > pos_iou with any gt, plus each gt's best anchor where
    that IoU is nonzero; negatives: max IoU < neg_iou and not positive;
    out-of-bounds anchors are excluded last. Regression targets point at
    each positive's own best gt.
    """
    b, n = u_pos.shape
    ious = box_ops.iou_matrix(anchors, gt_boxes)                     # (B, N, G)
    ious = torch.where(gt_valid[:, None, :], ious, torch.zeros_like(ious))

    # torch.argmax takes the first maximum, as jnp.argmax does
    max_iou = ious.max(dim=2).values
    argmax_gt = torch.argmax(ious, dim=2)                            # (B, N)
    best_anchor = torch.argmax(ious, dim=1)                          # (B, G)
    has_overlap = (ious.max(dim=1).values > 0.0) & gt_valid
    is_pos = torch.zeros((b, n), dtype=torch.uint8, device=ious.device).scatter_reduce_(
        1, best_anchor, has_overlap.to(torch.uint8), reduce="amax").bool()
    is_pos = is_pos | (max_iou > pos_iou)

    matched = torch.gather(gt_boxes.float(), 1, argmax_gt[..., None].expand(-1, -1, 4))
    reg = box_ops.encode(anchors[None], matched) * BBREG_MULTIPLIERS.to(ious.device)
    reg_target = torch.where(is_pos[..., None], reg, torch.zeros_like(reg))

    is_neg = (~is_pos) & (max_iou < neg_iou)
    oob = ((anchors[None, :, 0] < 0) | (anchors[None, :, 1] < 0)
           | (anchors[None, :, 2] >= img_w[:, None]) | (anchors[None, :, 3] >= img_h[:, None]))
    can_use = (is_pos | is_neg) & ~oob
    sampled = subsample_rpn_anchors(u_pos, u_neg, is_pos, can_use, sample_size, max_pos)
    return RpnTargets(cls_mask=sampled, cls_target=is_pos, reg_mask=is_pos & sampled,
                      reg_target=reg_target)


class DetTargets(NamedTuple):
    eligible: torch.Tensor    # (B, K) bool, IoU >= min_iou and a real ROI
    is_pos: torch.Tensor      # (B, K) bool, IoU >= pos_iou
    cls_target: torch.Tensor  # (B, K) int64, class id, background if not pos
    reg_target: torch.Tensor  # (B, K, 4) float32, multiplier-scaled


def det_targets(rois: torch.Tensor, roi_valid: torch.Tensor, gt_boxes: torch.Tensor,
                gt_class: torch.Tensor, gt_valid: torch.Tensor, num_classes: int,
                stride: int = 16, min_iou: float = 0.1, pos_iou: float = 0.5) -> DetTargets:
    """Detector-head targets of a batch of proposals.

    ``rois`` (B, K, 4) are in feature-map coords; ``gt_boxes`` (B, G, 4) in
    image coords, scaled here by 1/stride without rounding (det_util.py:
    312-313). ``gt_class`` ids count the background as num_classes - 1.
    """
    bg = num_classes - 1
    gt_conv = gt_boxes.float() / float(stride)
    ious = box_ops.iou_matrix(rois, gt_conv)                         # (B, K, G)
    ious = torch.where(gt_valid[:, None, :], ious, torch.zeros_like(ious))

    max_iou = ious.max(dim=2).values
    argmax_gt = torch.argmax(ious, dim=2)
    eligible = (max_iou >= min_iou) & roi_valid
    is_pos = (max_iou >= pos_iou) & eligible

    cls_target = torch.where(is_pos, torch.gather(gt_class.long(), 1, argmax_gt),
                             torch.full_like(argmax_gt, bg))
    matched = torch.gather(gt_conv, 1, argmax_gt[..., None].expand(-1, -1, 4))
    reg = box_ops.encode(rois, matched) * BBREG_MULTIPLIERS.to(rois.device)
    reg_target = torch.where(is_pos[..., None], reg, torch.zeros_like(reg))
    return DetTargets(eligible, is_pos, cls_target, reg_target)
