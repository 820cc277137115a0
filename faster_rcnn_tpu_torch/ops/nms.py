"""Fixed-shape exact greedy NMS, batched over images.

Counterpart of faster_rcnn_tpu/ops/nms.py. Boxes are pre-sorted by score and
suppressed tile by tile: each tile is first suppressed by the survivors of
earlier tiles, then resolved internally. The +1 area convention and the
"suppress when IoU > thresh" rule follow the reference (det_util.py:230-249).

This module holds the plain PyTorch version of the keep mask; the detection
path computes it with the CUDA kernel behind
:func:`faster_rcnn_tpu_torch.ops.nms_cuda.nms_keep_mask`, which uses the
plain version only for tensors on the CPU. The plain version loops on the
host (one sync per tile and per fixpoint step), which is why the kernel
carries both NMS calls of the path on the card.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30
FAR = -1e8  # padding rows are parked here: IoU 0 against any real box


def _pairwise_iou_p1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, N) +1-convention IoU block, in faster_rcnn_tpu's operation order."""
    x1 = torch.maximum(a[:, None, 0], b[None, :, 0])
    y1 = torch.maximum(a[:, None, 1], b[None, :, 1])
    x2 = torch.minimum(a[:, None, 2], b[None, :, 2])
    y2 = torch.minimum(a[:, None, 3], b[None, :, 3])
    iw = torch.clamp_min(x2 - x1 + 1.0, 0.0)
    ih = torch.clamp_min(y2 - y1 + 1.0, 0.0)
    inter = iw * ih
    area_a = (a[:, 2] - a[:, 0] + 1.0) * (a[:, 3] - a[:, 1] + 1.0)
    area_b = (b[:, 2] - b[:, 0] + 1.0) * (b[:, 3] - b[:, 1] + 1.0)
    return inter / (area_a[:, None] + area_b[None, :] - inter)


def _self_suppress_fixpoint(iou_gt: torch.Tensor, keep0: torch.Tensor) -> torch.Tensor:
    """Greedy keep mask within one score-sorted tile by chaotic iteration.

    ``iou_gt[k, j]`` is IoU > thresh; the recurrence ``keep[k] = keep0[k] &
    ~any(j < k: keep[j] & iou_gt[k, j])`` has one solution, reached in at
    most T steps from ``keep0``.
    """
    t = keep0.shape[0]
    tri = torch.tril(iou_gt, diagonal=-1)
    keep, prev, it = keep0, torch.zeros_like(keep0), 0
    while bool((keep != prev).any()) and it < t:
        sup = (tri & keep[None, :]).any(dim=1)
        keep, prev, it = keep0 & ~sup, keep, it + 1
    return keep


def _blocked_keep_mask(boxes: torch.Tensor, iou_thresh: float, tile: int,
                       enough: int = 0) -> torch.Tensor:
    """Keep mask of exact greedy NMS over one image's score-sorted (N, 4)
    boxes. ``enough > 0`` stops once that many survivors exist; the tail is
    then left kept and only the first ``enough`` keeps are meaningful."""
    n = boxes.shape[0]
    keep = torch.ones(n, dtype=torch.bool, device=boxes.device)
    kept = 0
    for off in range(0, n, tile):
        if enough > 0 and kept >= enough:
            break
        a = boxes[off:off + tile]
        earlier = keep[:off]
        sup = (earlier[:, None] & (_pairwise_iou_p1(boxes[:off], a) > iou_thresh)).any(dim=0)
        keep_a = keep[off:off + tile] & ~sup
        iou_aa = _pairwise_iou_p1(a, a) > iou_thresh
        keep_a = _self_suppress_fixpoint(iou_aa.T, keep_a)
        keep[off:off + tile] = keep_a
        kept += int(keep_a.sum())
    return keep


def nms_sorted_mask_blocked(boxes: torch.Tensor, valid: torch.Tensor, iou_thresh: float,
                            tile: int = 256, enough: int = 0) -> torch.Tensor:
    """Plain keep mask for (B, N, 4) boxes already sorted by descending score,
    invalid rows last; (B, N) bool ``valid`` -> (B, N) bool keep."""
    n = boxes.shape[1]
    if n % tile != 0:
        raise ValueError(f"n={n} must be a multiple of tile={tile}")
    boxes = torch.where(valid[..., None], boxes.float(),
                        torch.full_like(boxes, FAR, dtype=torch.float32))
    keep = torch.stack([_blocked_keep_mask(bx, float(iou_thresh), tile, enough) for bx in boxes])
    return keep & valid


def sort_by_score(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor):
    """Score-descending stable sort of (B, N) rows; invalid rows sink to the
    end with score NEG_INF. Ties keep ascending index, as ``jnp.argsort``
    does. Returns (boxes, scores, valid, order)."""
    s = torch.where(valid, scores.float(), torch.full_like(scores, NEG_INF, dtype=torch.float32))
    scores_s, order = torch.sort(s, dim=-1, descending=True, stable=True)
    boxes_s = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    return boxes_s, scores_s, scores_s > NEG_INF / 2, order


def _pad_rows(x: torch.Tensor, pad: int, value) -> torch.Tensor:
    if pad == 0:
        return x
    shape = (x.shape[0], pad) + tuple(x.shape[2:])
    return torch.cat([x, torch.full(shape, value, dtype=x.dtype, device=x.device)], dim=1)


def _compact(keep: torch.Tensor, max_out: int):
    """Positions of the first ``max_out`` kept rows per image, in order, and
    their validity. A stable sort of ~keep: no scatter with duplicate
    indices, so the result is deterministic on CUDA too."""
    order = torch.sort((~keep).to(torch.uint8), dim=1, stable=True).indices[:, :max_out]
    count = keep.sum(dim=1, keepdim=True)
    out_valid = torch.arange(max_out, device=keep.device)[None, :] < count
    return torch.where(out_valid, order, torch.zeros_like(order)), out_valid


def _keep_mask(boxes, valid, iou_thresh, tile, enough):
    from faster_rcnn_tpu_torch.ops.nms_cuda import nms_keep_mask

    return nms_keep_mask(boxes, valid, iou_thresh, tile=tile, enough=enough)


def nms_topk_indices(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
                     max_out: int, iou_thresh: float, tile: int = 128):
    """Blocked greedy NMS over (B, N) rows returning original indices in
    selection order: ((B, max_out) int64 indices, (B, max_out) bool valid).
    Invalid slots hold index 0."""
    n = boxes.shape[1]
    boxes_s, _, valid_s, order = sort_by_score(boxes, scores, valid)
    pad = (-n) % tile
    boxes_s = _pad_rows(boxes_s.float(), pad, 0.0)
    valid_s = _pad_rows(valid_s, pad, False)
    src_s = _pad_rows(order, pad, 0)
    keep = _keep_mask(boxes_s, valid_s, iou_thresh, tile, max_out)
    pos, out_valid = _compact(keep, max_out)
    idx = torch.gather(src_s, 1, pos)
    return torch.where(out_valid, idx, torch.zeros_like(idx)), out_valid


def nms_topk(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor, max_out: int,
             iou_thresh: float, tile: int = 256, presorted: bool = False):
    """Proposal-style NMS over (B, N) rows: sort by score (unless
    ``presorted``), blocked suppression, the first ``max_out`` survivors in
    score order. Returns (boxes (B, max_out, 4), scores, valid)."""
    if boxes.shape[1] < max_out:
        extra = max_out - boxes.shape[1]
        boxes = _pad_rows(boxes, extra, 0.0)
        scores = _pad_rows(scores, extra, NEG_INF)
        valid = _pad_rows(valid, extra, False)
    n = boxes.shape[1]
    if presorted:
        scores_s = torch.where(valid, scores.float(),
                               torch.full_like(scores, NEG_INF, dtype=torch.float32))
        boxes_s = boxes.float()
        valid_s = scores_s > NEG_INF / 2
    else:
        boxes_s, scores_s, valid_s, _ = sort_by_score(boxes.float(), scores, valid)
    pad = (-n) % tile
    boxes_s = _pad_rows(boxes_s, pad, 0.0)
    scores_s = _pad_rows(scores_s, pad, NEG_INF)
    valid_s = _pad_rows(valid_s, pad, False)

    keep = _keep_mask(boxes_s, valid_s, iou_thresh, tile, max_out)
    pos, out_valid = _compact(keep, max_out)
    out_boxes = torch.gather(boxes_s, 1, pos[..., None].expand(-1, -1, 4))
    out_scores = torch.gather(scores_s, 1, pos)
    out_boxes = torch.where(out_valid[..., None], out_boxes, torch.zeros_like(out_boxes))
    out_scores = torch.where(out_valid, out_scores, torch.full_like(out_scores, NEG_INF))
    return out_boxes, out_scores, out_valid
