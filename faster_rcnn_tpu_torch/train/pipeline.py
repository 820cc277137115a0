"""The parts of faster_rcnn_tpu/train/pipeline.py that detection uses: image
ingest, the static anchor constants, and proposals from the RPN. The train
steps come with the training slice."""

from __future__ import annotations

from typing import NamedTuple

import torch

from faster_rcnn_tpu_torch.config import FasterRcnnConfig
from faster_rcnn_tpu_torch.models.detector import IMAGENET_BGR_MEANS, FasterRCNN
from faster_rcnn_tpu_torch.ops import anchors as anchor_ops
from faster_rcnn_tpu_torch.ops import proposals as prop_ops


def ingest_images(images: torch.Tensor) -> torch.Tensor:
    """Raw uint8 RGB canvases -> BGR float32 minus ImageNet means, on the
    images' device; float batches are taken as already preprocessed."""
    if images.dtype == torch.uint8:
        means = torch.as_tensor(IMAGENET_BGR_MEANS, device=images.device)
        return images.flip(-1).float() - means
    return images


class Constants(NamedTuple):
    anchors_image: torch.Tensor  # (N, 4) image-space anchor grid
    anchors_conv: torch.Tensor   # (N, 4) conv-space anchor grid


def build_constants(cfg: FasterRcnnConfig, device=None) -> Constants:
    dims = cfg.anchors.dims
    ch, cw, s = cfg.conv_h, cfg.conv_w, cfg.model.stride
    return Constants(
        anchors_image=torch.as_tensor(anchor_ops.anchor_grid_image_space(ch, cw, dims, s),
                                      device=device),
        anchors_conv=torch.as_tensor(anchor_ops.anchor_grid_conv_space(ch, cw, dims, s),
                                     device=device),
    )


def _position_validity(cfg: FasterRcnnConfig, device=None):
    return prop_ops.position_validity(cfg.conv_h, cfg.conv_w, cfg.anchors.num_anchors, device)


def rpn_forward_proposals(cfg: FasterRcnnConfig, model: FasterRCNN, images: torch.Tensor,
                          img_hw: torch.Tensor, pre_nms: int, post_nms: int,
                          consts: Constants | None = None, posv=None):
    """Backbone, RPN and proposals for a batch. ``img_hw`` is (B, 2) int, the
    actual (h, w) of each image on the canvas. Returns (feat (B, h, w, F),
    boxes (B, K, 4), scores (B, K), valid (B, K))."""
    device = images.device
    consts = consts if consts is not None else build_constants(cfg, device)
    posv = posv if posv is not None else _position_validity(cfg, device)
    feat = model.backbone(images)
    cls_logits, bbreg = model.rpn(feat)
    probs = torch.sigmoid(cls_logits)
    rows = img_hw[:, 0] // cfg.model.stride
    cols = img_hw[:, 1] // cfg.model.stride
    props = prop_ops.generate_proposals(
        probs, bbreg, consts.anchors_conv, posv(rows, cols), rows, cols,
        pre_nms=pre_nms, post_nms=post_nms, iou_thresh=cfg.rpn.nms_iou,
        nms_tile=cfg.rpn.nms_tile)
    return feat, props.boxes, props.scores, props.valid
