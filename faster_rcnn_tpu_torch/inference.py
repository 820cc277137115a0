"""Batched detection inference: uint8 canvases -> final boxes.

Counterpart of faster_rcnn_tpu/inference.py: backbone -> RPN -> proposals
(8000 -> NMS -> 300) -> RoI align of all 300 at once -> detector head ->
per-ROI argmax + class-offset NMS -> fixed (B, D) detections, for every
network of ``cfg.model.network``. On a CUDA device the ResNet stem conv,
the proposal top-k, the RoI align and both NMS calls run the port's
kernels (ops/*_cuda.py).

The per-class NMS (voc_dets.py:76, thresh 0.5) uses the class-offset trick:
each detection is shifted by class_id * 16384 so boxes of different classes
never overlap, and one NMS does the work of C.

Batch-sharded serving (``make_detect_fn(..., mesh=...)``, one process per
card): the weights are replicated, each process detects its rows of the
batch, and the fixed (B, D) detections are all-gathered, so that every
process returns the whole batch's, as the JAX package's sharded
``make_detect_fn`` does.
"""

from __future__ import annotations

import os
from typing import Dict, List, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from faster_rcnn_tpu_torch import resolve_device
from faster_rcnn_tpu_torch.config import FasterRcnnConfig
from faster_rcnn_tpu_torch.models.detector import FasterRCNN
from faster_rcnn_tpu_torch.ops import boxes as box_ops
from faster_rcnn_tpu_torch.ops import nms as nms_ops
from faster_rcnn_tpu_torch.ops.roi_align_cuda import roi_align
from faster_rcnn_tpu_torch.ops.targets import BBREG_MULTIPLIERS
from faster_rcnn_tpu_torch.parallel import mesh as mesh_lib
from faster_rcnn_tpu_torch.train import pipeline
from faster_rcnn_tpu_torch.utils import profiling

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


def make_detect_fn(cfg: FasterRcnnConfig, model: FasterRCNN, device=None, mesh=None):
    """Build ``detect(images, img_hw) -> Detections`` on ``device`` (CUDA by
    default; raises if there is none unless ``device='cpu'``).

    ``images`` are (B, Hc, Wc, 3) raw RGB uint8 canvases (the BGR flip and
    mean subtraction run on the device) or float32 batches already
    preprocessed; ``img_hw`` is (B, 2) int, the actual (h, w) of each image
    on the canvas. Both may be numpy arrays or tensors.

    A call is the span ``frcnn.detect`` (utils/profiling) of five stages:
    ``ingest`` (the upload of the frames and ``img_hw``, flip, float, mean
    subtraction), ``backbone`` (to stride 16), ``rpn_proposals`` (RPN head,
    sigmoid, decode, top-k, NMS), ``roi_align_head`` (RoI align, stage 5 or
    fc6/fc7, softmax) and ``decode``. ``detect(images, img_hw, mark)``
    calls ``mark(stage)`` as each stage is enqueued (for timing).

    ``mesh`` (a parallel/mesh.Mesh): every process passes the whole batch,
    detects its rows of it (B must be a multiple of the mesh's data size)
    and returns the whole batch's detections; rank 0's weights are copied
    to every process when the function is built.
    """
    device = resolve_device(device)
    model = model.to(device).eval()
    if mesh is not None:
        mesh_lib.replicated(mesh, model.state_dict())
    consts = pipeline.build_constants(cfg, device)
    posv = pipeline._position_validity(cfg, device)

    @torch.inference_mode()
    def detect(images, img_hw, mark=None) -> Detections:
        with profiling.scope("frcnn.detect", device=device):
            with profiling.scope("ingest", mark):
                images = pipeline.ingest_images(torch.as_tensor(images, device=device))
                img_hw = torch.as_tensor(img_hw, device=device).long()
            with profiling.scope("backbone", mark):
                feat = model.backbone(images)
            with profiling.scope("rpn_proposals", mark):
                pboxes, _, pvalid = pipeline.rpn_proposals(
                    cfg, model, feat, img_hw, cfg.rpn.infer_pre_nms, cfg.rpn.infer_post_nms,
                    consts, posv)
            with profiling.scope("roi_align_head", mark):
                pooled = roi_align(feat.contiguous(), pboxes.contiguous(), cfg.det.pool_size)
                cls_logits, reg_out = model.det_head(pooled)
                cls_prob = torch.softmax(cls_logits, dim=-1)
            with profiling.scope("decode", mark):
                return Detections(*_decode_one_image(cfg, pboxes, pvalid, cls_prob, reg_out))

    if mesh is None:
        return detect

    def sharded_detect(images, img_hw) -> Detections:
        if len(images) % mesh.data:
            raise ValueError(f"batch {len(images)} is not a multiple of the mesh's data "
                             f"size {mesh.data}")
        part = mesh_lib.shard_batch(mesh, {"images": images, "img_hw": img_hw})
        return _all_gather(detect(part["images"], part["img_hw"]), mesh)

    return sharded_detect


def _all_gather(dets: Detections, mesh) -> Detections:
    """The whole batch's detections from every data shard's: the four
    fields packed as f32 (the class ids and the valid flag are exact in
    it), one all-gather over the mesh's data column, in rank order."""
    packed = torch.cat([dets.boxes, dets.scores[..., None], dets.classes[..., None].float(),
                        dets.valid[..., None].float()], -1).contiguous()
    parts = [torch.empty_like(packed) for _ in range(mesh.data)]
    dist.all_gather(parts, packed, group=mesh.data_group)
    full = torch.cat(parts)
    return Detections(full[..., :4].contiguous(), full[..., 4].contiguous(),
                      full[..., 5].to(torch.int32), full[..., 6] != 0)


def detections_to_records(dets: Detections, resize_ratios: List[float],
                          class_names: List[str]) -> List[List[Dict]]:
    """Detections -> per-image dicts in ORIGINAL image coords
    (voc_dets.py:79-88: divide by resize ratio, round to int).

    A detection whose box is not finite is dropped: a regression output
    past about 444 overflows ``exp`` in the decode, and such a box has no
    integer coordinates (the JAX package's counterpart raises
    ``OverflowError`` there). Finite boxes are kept as they are, unclipped."""
    boxes = dets.boxes.cpu().numpy()
    scores = dets.scores.cpu().numpy()
    classes = dets.classes.cpu().numpy()
    valid = dets.valid.cpu().numpy() & np.isfinite(boxes).all(-1)
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
