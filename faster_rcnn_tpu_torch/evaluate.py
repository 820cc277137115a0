"""PASCAL VOC mAP evaluation.

A copy of faster_rcnn_tpu/evaluate.py, which the port may not import.

Rebuild of eval_dets.py: 11-point interpolated AP (the metric the reference
reports, eval_dets.py:123) plus the AUC variant, greedy confidence-ordered
TP/FP matching at IoU 0.5 with the +1 area convention, 'difficult' ground
truth excluded from both npos and scoring (eval_dets.py:38-125).

One fix over the reference: annotations are parsed once and reused across
classes instead of re-parsed per class (eval_dets.py:43-47 quirk).
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np

from faster_rcnn_tpu_torch.data.voc import GtBox, imageset_names, parse_annotation


def voc_ap(rec: np.ndarray, prec: np.ndarray, use_07_metric: bool = True) -> float:
    """11-point (VOC2007) or area-under-PR-curve AP (eval_dets.py:8-35)."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = np.max(prec[rec >= t]) if np.sum(rec >= t) > 0 else 0.0
            ap += p / 11.0
        return float(ap)
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = np.maximum(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def parse_detection_file(det_file: str) -> Tuple[List[str], np.ndarray, np.ndarray]:
    """comp3 file -> (image_ids, confidences, boxes)."""
    with open(det_file) as f:
        lines = [x.strip().split(" ") for x in f if x.strip()]
    if not lines:
        return [], np.zeros((0,)), np.zeros((0, 4))
    image_ids = [x[0] for x in lines]
    confidence = np.array([float(x[1]) for x in lines])
    bb = np.array([[float(z) for z in x[2:]] for x in lines])
    return image_ids, confidence, bb


def voc_eval_class(
    gt_by_image: Dict[str, List[GtBox]],
    det_file: str,
    cls_name: str,
    ovthresh: float = 0.5,
    use_07_metric: bool = True,
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Greedy matching for one class (eval_dets.py:38-125).

    Provenance: this is the canonical PASCAL VOC devkit evaluation
    algorithm (py-faster-rcnn's ``voc_eval``), which the reference itself
    lifted; an exact-protocol evaluator must implement exactly this
    algorithm, hence the shared variable idiom (ixmin/ovmax/cumsum TP-FP).
    """
    class_recs = {}
    npos = 0
    for imagename, boxes in gt_by_image.items():
        r = [b for b in boxes if b.obj_cls == cls_name]
        bbox = np.array([b.corners for b in r]) if r else np.zeros((0, 4))
        difficult = np.array([b.difficult for b in r], bool)
        npos += int((~difficult).sum())
        class_recs[imagename] = {
            "bbox": bbox, "difficult": difficult, "det": [False] * len(r)
        }

    image_ids, confidence, bb_all = parse_detection_file(det_file)
    order = np.argsort(-confidence)
    bb_all = bb_all[order] if len(order) else bb_all
    image_ids = [image_ids[i] for i in order]

    nd = len(image_ids)
    tp = np.zeros(nd)
    fp = np.zeros(nd)
    for d in range(nd):
        r = class_recs[image_ids[d]]
        bb = bb_all[d].astype(float)
        ovmax, jmax = -np.inf, -1
        gt = r["bbox"].astype(float)
        if gt.size > 0:
            ixmin = np.maximum(gt[:, 0], bb[0])
            iymin = np.maximum(gt[:, 1], bb[1])
            ixmax = np.minimum(gt[:, 2], bb[2])
            iymax = np.minimum(gt[:, 3], bb[3])
            iw = np.maximum(ixmax - ixmin + 1.0, 0.0)
            ih = np.maximum(iymax - iymin + 1.0, 0.0)
            inters = iw * ih
            uni = (
                (bb[2] - bb[0] + 1.0) * (bb[3] - bb[1] + 1.0)
                + (gt[:, 2] - gt[:, 0] + 1.0) * (gt[:, 3] - gt[:, 1] + 1.0)
                - inters
            )
            overlaps = inters / uni
            ovmax = overlaps.max()
            jmax = int(overlaps.argmax())

        if ovmax > ovthresh:
            if not r["difficult"][jmax]:
                if not r["det"][jmax]:
                    tp[d] = 1.0
                    r["det"][jmax] = True
                else:
                    fp[d] = 1.0
        else:
            fp[d] = 1.0

    fp = np.cumsum(fp)
    tp = np.cumsum(tp)
    rec = tp / float(max(npos, 1))
    prec = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    return rec, prec, voc_ap(rec, prec, use_07_metric)


def load_ground_truth(voc_path: str, img_set: str) -> Dict[str, List[GtBox]]:
    """Parse every image's annotations once (fixes the per-class re-parse)."""
    names = imageset_names(voc_path, img_set)
    return {n: parse_annotation(voc_path, n).gt_boxes for n in names}


def eval_all(
    dets_path: str,
    voc_path: str,
    class_mapping: Dict[str, int],
    img_set: str = "val",
    verbose: bool = True,
) -> Dict[str, float]:
    """Per-class AP + mAP over all comp3 files (eval_dets.py:134-151)."""
    gt = load_ground_truth(voc_path, img_set)
    aps: Dict[str, float] = {}
    for cls_name in sorted(class_mapping):
        if cls_name == "bg":
            continue
        det_file = os.path.join(dets_path, f"comp3_det_test_{cls_name}.txt")
        if not os.path.exists(det_file):
            aps[cls_name] = 0.0
            continue
        _, _, ap = voc_eval_class(gt, det_file, cls_name)
        aps[cls_name] = ap
        if verbose:
            print(f"AP for {cls_name} = {ap:.4f}")
    mean_ap = float(np.mean(list(aps.values()))) if aps else 0.0
    if verbose:
        print(f"Mean AP = {mean_ap:.4f}")
    aps["mAP"] = mean_ap
    return aps
