"""Batched detection inference: uint8 canvases -> final boxes.

Counterpart of faster_rcnn_tpu/inference.py: backbone -> RPN -> proposals
(8000 -> NMS -> 300) -> RoI align of all 300 at once -> detector head ->
per-ROI argmax + class-offset NMS -> fixed (B, D) detections. On a CUDA
device the stem conv, the proposal top-k, the RoI align and both NMS calls
run the port's kernels (ops/*_cuda.py).

The per-class NMS (voc_dets.py:76, thresh 0.5) uses the class-offset trick:
each detection is shifted by class_id * 16384 so boxes of different classes
never overlap, and one NMS does the work of C.
"""

from __future__ import annotations

import os
from typing import Dict, List, NamedTuple

import numpy as np
import torch

from faster_rcnn_tpu_torch import resolve_device
from faster_rcnn_tpu_torch.config import FasterRcnnConfig
from faster_rcnn_tpu_torch.models.detector import FasterRCNN
from faster_rcnn_tpu_torch.ops import boxes as box_ops
from faster_rcnn_tpu_torch.ops import nms as nms_ops
from faster_rcnn_tpu_torch.ops.roi_align_cuda import roi_align
from faster_rcnn_tpu_torch.ops.targets import BBREG_MULTIPLIERS
from faster_rcnn_tpu_torch.train import pipeline

_CLASS_OFFSET = 16384.0  # larger than any image dim; small enough for fp32 IoU


class Detections(NamedTuple):
    boxes: torch.Tensor    # (B, D, 4) resized-image pixel coords (float)
    scores: torch.Tensor   # (B, D)
    classes: torch.Tensor  # (B, D) int32
    valid: torch.Tensor    # (B, D) bool


def _decode_one_image(cfg: FasterRcnnConfig, rois, roi_valid, cls_prob, reg_out):
    """Per-ROI argmax decode + class-offset NMS, batched over images.

    rois: (B, R, 4) conv coords; roi_valid (B, R); cls_prob: (B, R, C)
    softmax probs; reg_out: (B, R, 4(C-1)).
    """
    c = cfg.model.num_classes
    bg = c - 1
    stride = float(cfg.model.stride)

    cls_idx = torch.argmax(cls_prob, dim=-1)                         # first maximum
    conf = torch.gather(cls_prob, -1, cls_idx[..., None])[..., 0]
    keep = roi_valid & (cls_idx != bg) & (conf >= cfg.det.det_threshold)

    safe_cls = torch.clamp_max(cls_idx, bg - 1)  # background rows read class bg-1
    cols = safe_cls[..., None] * 4 + torch.arange(4, device=cls_idx.device)
    deltas = torch.gather(reg_out, -1, cols) / BBREG_MULTIPLIERS.to(reg_out.device)

    boxes = box_ops.decode(rois, deltas, round_coords=False) * stride
    shifted = boxes + cls_idx[..., None].float() * _CLASS_OFFSET
    d = min(cfg.rpn.infer_post_nms, rois.shape[1])
    idx, ok = nms_ops.nms_topk_indices(
        shifted, torch.where(keep, conf, torch.full_like(conf, -1.0)), keep, d,
        cfg.det.final_nms_iou, tile=128)
    return (torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4)),
            torch.gather(conf, 1, idx),
            torch.gather(cls_idx, 1, idx).to(torch.int32),
            ok)


def make_detect_fn(cfg: FasterRcnnConfig, model: FasterRCNN, device=None):
    """Build ``detect(images, img_hw) -> Detections`` on ``device`` (CUDA by
    default; raises if there is none unless ``device='cpu'``).

    ``images`` are (B, Hc, Wc, 3) raw RGB uint8 canvases (the BGR flip and
    mean subtraction run on the device) or float32 batches already
    preprocessed; ``img_hw`` is (B, 2) int, the actual (h, w) of each image
    on the canvas. Both may be numpy arrays or tensors.
    """
    device = resolve_device(device)
    model = model.to(device).eval()
    consts = pipeline.build_constants(cfg, device)
    posv = pipeline._position_validity(cfg, device)

    @torch.inference_mode()
    def detect(images, img_hw) -> Detections:
        images = pipeline.ingest_images(torch.as_tensor(images, device=device))
        img_hw = torch.as_tensor(img_hw, device=device).long()
        feat, pboxes, _, pvalid = pipeline.rpn_forward_proposals(
            cfg, model, images, img_hw, cfg.rpn.infer_pre_nms, cfg.rpn.infer_post_nms,
            consts=consts, posv=posv)
        pooled = roi_align(feat.contiguous(), pboxes.contiguous(), cfg.det.pool_size)
        cls_logits, reg_out = model.det_head(pooled)
        cls_prob = torch.softmax(cls_logits, dim=-1)
        return Detections(*_decode_one_image(cfg, pboxes, pvalid, cls_prob, reg_out))

    return detect


def detections_to_records(dets: Detections, resize_ratios: List[float],
                          class_names: List[str]) -> List[List[Dict]]:
    """Detections -> per-image dicts in ORIGINAL image coords
    (voc_dets.py:79-88: divide by resize ratio, round to int)."""
    boxes = dets.boxes.cpu().numpy()
    scores = dets.scores.cpu().numpy()
    classes = dets.classes.cpu().numpy()
    valid = dets.valid.cpu().numpy()
    out: List[List[Dict]] = []
    for i in range(boxes.shape[0]):
        ratio = resize_ratios[i]
        recs = []
        for j in np.where(valid[i])[0]:
            x1, y1, x2, y2 = boxes[i, j]
            recs.append({
                "bbox": np.array([int(round(x1 / ratio)), int(round(y1 / ratio)),
                                  int(round(x2 / ratio)), int(round(y2 / ratio))]),
                "cls_name": class_names[classes[i, j]],
                "prob": float(scores[i, j]),
            })
        out.append(recs)
    return out


def write_dets(dets_by_cls: Dict[str, Dict[str, List[Dict]]], out_dir: str) -> None:
    """VOC comp3 detection files, 1-based output coords (voc_dets.py:114-129)."""
    os.makedirs(out_dir, exist_ok=True)
    for cls_name, by_img in dets_by_cls.items():
        path = os.path.join(out_dir, f"comp3_det_test_{cls_name}.txt")
        with open(path, "w") as f:
            for image_name, recs in by_img.items():
                for det in recs:
                    x1, y1, x2, y2 = det["bbox"] + 1
                    f.write(f"{image_name} {det['prob']} {x1} {y1} {x2} {y2}\n")
