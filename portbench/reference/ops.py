"""Box, anchor, proposal, RoI-align, target, sampling and loss arithmetic of
Faster R-CNN, written out plainly in float32 PyTorch and NumPy.

Frozen copies of the formulas (Ren et al., arXiv:1506.01497; the
Kelicious/faster_rcnn conventions: +1 IoU in NMS, banker's rounding of
proposal corners, TF1 bilinear RoI crops, class-offset final NMS), written
for clarity and not speed: greedy NMS is a loop over kept boxes, the
top-k is a stable sort of total-order keys, RoI align is four gathers.
Nothing here is shared with the system under test.
"""

from __future__ import annotations

import math
from collections import namedtuple

import numpy as np
import torch

BBREG_MULTIPLIERS = (10.0, 10.0, 5.0, 5.0)
NEG_INF = -1e30
CLASS_OFFSET = 16384.0

# the samplers' uniform draws: anchor priorities (B, N), proposal priorities
# (B, K), and two 32-bit words (B, R) of each ROI drawn with replacement
Draws = namedtuple("Draws", "rpn_pos rpn_neg det_pos det_neg det_hi det_lo")


def anchor_dims(scales, ratios) -> np.ndarray:
    """Integer (h, w) of each anchor: [s*h, s*w] shrunk by sqrt(s*h*s*w)/s so
    its area is about s^2, floor-divided and truncated."""
    naive = np.array([[s * h, s * w] for s in scales for h, w in ratios])
    r = np.array([math.sqrt(s * h * s * w) / s for s in scales for h, w in ratios])
    return (naive // r[:, None]).astype(int)


def anchors_image(rows: int, cols: int, dims: np.ndarray, stride: int) -> np.ndarray:
    """(rows*cols*A, 4) image-space anchors: centres int(stride*(i+0.5)),
    corners centre - dim//2, index (y*cols + x)*A + a."""
    ys, xs = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    cx = (stride * (xs + 0.5)).astype(np.int64)[..., None]
    cy = (stride * (ys + 0.5)).astype(np.int64)[..., None]
    h, w = dims[:, 0].astype(np.int64), dims[:, 1].astype(np.int64)
    x1, y1 = cx - w // 2, cy - h // 2
    return np.stack(np.broadcast_arrays(x1, y1, x1 + w, y1 + h), -1) \
        .reshape(-1, 4).astype(np.float32)


def anchors_conv(rows: int, cols: int, dims: np.ndarray, stride: int) -> np.ndarray:
    """(rows*cols*A, 4) feature-map anchors: dims // stride, centres at the
    bare grid index, corners centre - dim//2."""
    d = dims // stride
    ys, xs = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    h, w = d[:, 0].astype(np.int64), d[:, 1].astype(np.int64)
    x1, y1 = xs[..., None] - w // 2, ys[..., None] - h // 2
    return np.stack(np.broadcast_arrays(x1, y1, x1 + w, y1 + h), -1) \
        .reshape(-1, 4).astype(np.float32)


def decode(anchors, deltas, round_coords: bool):
    w = anchors[..., 2] - anchors[..., 0]
    h = anchors[..., 3] - anchors[..., 1]
    cx = anchors[..., 0] + w / 2.0 + deltas[..., 0] * w
    cy = anchors[..., 1] + h / 2.0 + deltas[..., 1] * h
    nw = torch.exp(deltas[..., 2]) * w
    nh = torch.exp(deltas[..., 3]) * h
    x1, y1 = cx - nw / 2.0, cy - nh / 2.0
    if round_coords:
        x1, y1, nw, nh = torch.round(x1), torch.round(y1), torch.round(nw), torch.round(nh)
    return torch.stack([x1, y1, x1 + nw, y1 + nh], -1)


def encode(anchors, gt):
    aw, ah = anchors[..., 2] - anchors[..., 0], anchors[..., 3] - anchors[..., 1]
    gw, gh = gt[..., 2] - gt[..., 0], gt[..., 3] - gt[..., 1]
    acx, acy = (anchors[..., 0] + anchors[..., 2]) / 2.0, (anchors[..., 1] + anchors[..., 3]) / 2.0
    gcx, gcy = (gt[..., 0] + gt[..., 2]) / 2.0, (gt[..., 1] + gt[..., 3]) / 2.0
    ok = (aw > 0) & (ah > 0) & (gw > 0) & (gh > 0)
    one = torch.ones_like(aw)
    aw, ah = torch.where(ok, aw, one), torch.where(ok, ah, one)
    gw, gh = torch.where(ok, gw, one), torch.where(ok, gh, one)
    t = torch.stack([(gcx - acx) / aw, (gcy - acy) / ah, torch.log(gw / aw),
                     torch.log(gh / ah)], -1)
    return torch.where(ok[..., None], t, torch.zeros_like(t))


def iou(a, b):
    """All-pairs IoU without the +1 convention: (..., N, 4) x (..., M, 4)."""
    a, b = a[..., :, None, :], b[..., None, :, :]
    iw = (torch.minimum(a[..., 2], b[..., 2]) - torch.maximum(a[..., 0], b[..., 0])).clamp_min(0)
    ih = (torch.minimum(a[..., 3], b[..., 3]) - torch.maximum(a[..., 1], b[..., 1])).clamp_min(0)
    inter = iw * ih
    union = ((a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
             + (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1]) - inter)
    return torch.where(union > 0, inter / torch.where(union > 0, union, torch.ones_like(union)),
                       torch.zeros_like(union))


def topk_total_order(scores, k: int):
    """The k largest of each row in the IEEE total order, ties by index."""
    bits = scores.float().contiguous().view(torch.int32)
    key = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    idx = torch.sort(key, dim=-1, descending=True, stable=True).indices[..., :k]
    return scores.gather(-1, idx), idx


def greedy_nms(boxes: np.ndarray, valid: np.ndarray, thresh: float, max_out: int) -> np.ndarray:
    """Exact greedy NMS over one image's score-sorted (N, 4) f32 boxes with
    the +1 area convention, suppressing IoU > thresh: the positions of the
    first ``max_out`` survivors, in order."""
    b = boxes.astype(np.float32)
    one = np.float32(1.0)
    area = (b[:, 2] - b[:, 0] + one) * (b[:, 3] - b[:, 1] + one)
    alive = valid.copy()
    kept = []
    t = np.float32(thresh)
    for i in range(b.shape[0]):
        if not alive[i]:
            continue
        kept.append(i)
        if len(kept) == max_out:
            break
        rest = slice(i + 1, None)
        iw = np.maximum(np.minimum(b[i, 2], b[rest, 2]) - np.maximum(b[i, 0], b[rest, 0]) + one,
                        np.float32(0))
        ih = np.maximum(np.minimum(b[i, 3], b[rest, 3]) - np.maximum(b[i, 1], b[rest, 1]) + one,
                        np.float32(0))
        inter = iw * ih
        alive[rest] &= ~(inter / (area[i] + area[rest] - inter) > t)
    return np.array(kept, np.int64)


def proposals(probs, bbreg, conv_anchors, rows, cols, num_anchors: int, conv_w: int,
              pre_nms: int, post_nms: int, thresh: float):
    """RPN output -> (boxes (B, post, 4), valid (B, post)) in feature-map
    coords: decode with rounding, clip to each image's conv extent, drop
    anchors whose cell lies outside it, top ``pre_nms``, greedy NMS."""
    b, n = probs.shape[0], conv_anchors.shape[0]
    probs = probs.reshape(b, n).float()
    mult = torch.tensor(BBREG_MULTIPLIERS, device=probs.device)
    boxes = decode(conv_anchors[None], bbreg.reshape(b, n, 4).float() / mult, True)
    x1, y1, x2, y2 = boxes.unbind(-1)
    x2, y2 = torch.maximum(x1 + 1, x2), torch.maximum(y1 + 1, y2)
    x1, y1 = x1.clamp_min(0), y1.clamp_min(0)
    x2 = torch.minimum((cols - 1).float()[:, None], x2)
    y2 = torch.minimum((rows - 1).float()[:, None], y2)
    boxes = torch.stack([x1, y1, x2, y2], -1)
    cell = torch.arange(n, device=probs.device) // num_anchors
    inside = ((cell // conv_w)[None] < rows[:, None]) & ((cell % conv_w)[None] < cols[:, None])
    valid = (x2 > x1) & (y2 > y1) & inside
    masked = torch.where(valid, probs, torch.full_like(probs, NEG_INF))
    k = min(pre_nms, n)
    top, idx = topk_total_order(masked, k)
    top_boxes = boxes.gather(1, idx[..., None].expand(-1, -1, 4))
    top_valid = (top > NEG_INF / 2).cpu().numpy()
    tb = top_boxes.cpu().numpy()
    out = torch.zeros((b, post_nms, 4), dtype=torch.float32)
    ok = torch.zeros((b, post_nms), dtype=torch.bool)
    for i in range(b):
        keep = greedy_nms(tb[i], top_valid[i], thresh, post_nms)
        out[i, :len(keep)] = torch.from_numpy(tb[i][keep])
        ok[i, :len(keep)] = True
    return out.to(probs.device), ok.to(probs.device)


def roi_align(feat, rois, p: int):
    """(B, H, W, C) f32 map x (B, R, 4) integer feature-map ROIs -> (B, R, P,
    P, C): the crop map[y1:y2, x1:x2] resized bilinearly as TF1 does (source
    i*(crop/P), taps floor and min(floor+1, crop-1), clamped to the map)."""
    b, h, w, c = feat.shape
    r = rois.shape[1]
    x1, y1 = rois[..., 0], rois[..., 1]
    cw, ch = rois[..., 2] - x1, rois[..., 3] - y1
    i = torch.arange(p, dtype=torch.float32, device=feat.device)
    pt = torch.full((), float(p), device=feat.device)
    sy, sx = i * (ch[..., None] / pt), i * (cw[..., None] / pt)
    y0, x0 = torch.floor(sy), torch.floor(sx)
    fy, fx = sy - y0, sx - x0
    y0, x0 = y0 + y1[..., None], x0 + x1[..., None]
    ya = y0.clamp(0, h - 1).long()
    yb = torch.minimum(y0 + 1, (y1 + ch - 1)[..., None]).clamp(0, h - 1).long()
    xa = x0.clamp(0, w - 1).long()
    xb = torch.minimum(x0 + 1, (x1 + cw - 1)[..., None]).clamp(0, w - 1).long()
    flat = feat.reshape(b, h * w, c)

    def tap(yy, xx):
        lin = (yy[:, :, :, None] * w + xx[:, :, None, :]).reshape(b, r * p * p)
        return flat.gather(1, lin[..., None].expand(-1, -1, c)).reshape(b, r, p, p, c)

    f00, f01, f10, f11 = tap(ya, xa), tap(ya, xb), tap(yb, xa), tap(yb, xb)
    fx, fy = fx[:, :, None, :, None], fy[:, :, :, None, None]
    top = f00 + (f01 - f00) * fx
    bot = f10 + (f11 - f10) * fx
    return top + (bot - top) * fy


def class_boxes(rois, reg, stride: int):
    """(B, R, C-1, 4) image-px box of every ROI for every foreground class."""
    b, r, n = reg.shape
    mult = torch.tensor(BBREG_MULTIPLIERS, device=reg.device)
    d = reg.reshape(b, r, n // 4, 4) / mult
    return decode(rois[:, :, None, :], d, False) * float(stride)


def final_detections(rois, roi_valid, cls_prob, reg, num_classes: int, stride: int,
                     thresh: float, iou_thresh: float, max_det: int):
    """Per ROI its most probable class (background last), that class's box,
    and one NMS over all classes with boxes shifted apart by class: (boxes
    (B, D, 4) image px, scores, classes, valid), D = min(max_det, R)."""
    bg = num_classes - 1
    cls = cls_prob.argmax(-1)
    conf = cls_prob.gather(-1, cls[..., None])[..., 0]
    keep = roi_valid & (cls != bg) & (conf >= thresh)
    col = cls.clamp_max(bg - 1)[..., None] * 4 + torch.arange(4, device=cls.device)
    mult = torch.tensor(BBREG_MULTIPLIERS, device=reg.device)
    boxes = decode(rois, reg.gather(-1, col) / mult, False) * float(stride)
    b, r = conf.shape
    d = min(max_det, r)
    out_b = torch.zeros((b, d, 4))
    out_s = torch.zeros((b, d))
    out_c = torch.zeros((b, d), dtype=torch.int32)
    out_v = torch.zeros((b, d), dtype=torch.bool)
    bx, cf, cl, kp = (t.cpu() for t in (boxes, conf, cls, keep))
    for i in range(b):
        s = torch.where(kp[i], cf[i], torch.full_like(cf[i], NEG_INF))
        order = torch.sort(s, descending=True, stable=True).indices
        shifted = (bx[i] + cl[i][:, None].float() * CLASS_OFFSET)[order]
        pos = greedy_nms(shifted.numpy(), kp[i][order].numpy(), iou_thresh, d)
        sel = order[torch.from_numpy(pos)]
        n = len(sel)
        out_b[i, :n], out_s[i, :n], out_c[i, :n] = bx[i][sel], cf[i][sel], cl[i][sel].int()
        out_v[i, :n] = True
    return out_b, out_s, out_c, out_v


# ---------------------------------------------------------------- training


def _keep_top(priority, mask, k):
    """At most k (per row) True entries of ``mask``: those of highest
    priority, ties by index."""
    pri = torch.where(mask, priority, torch.full_like(priority, NEG_INF))
    order = torch.sort(-pri, dim=-1, stable=True).indices
    rank = torch.empty_like(order).scatter_(
        -1, order, torch.arange(pri.shape[-1], device=pri.device).expand_as(order))
    return mask & (rank < torch.as_tensor(k, device=mask.device).reshape(-1, 1))


def rpn_targets(u_pos, u_neg, anchors, gt, gt_valid, img_w, img_h, pos_iou, neg_iou,
                sample, max_pos):
    """(cls mask, positive, reg mask, reg target) over the anchors: IoU >
    pos_iou or a ground truth's best anchor is positive, max IoU < neg_iou
    negative, anchors crossing the image left out, then at most ``max_pos``
    positives and ``sample`` in all, by the priorities."""
    b, n = u_pos.shape
    ious = iou(anchors, gt)
    ious = torch.where(gt_valid[:, None, :], ious, torch.zeros_like(ious))
    max_iou, arg = ious.max(2).values, ious.argmax(2)
    best = ious.argmax(1)
    has = (ious.max(1).values > 0) & gt_valid
    pos = torch.zeros((b, n), dtype=torch.uint8, device=ious.device).scatter_reduce_(
        1, best, has.to(torch.uint8), reduce="amax").bool() | (max_iou > pos_iou)
    matched = gt.gather(1, arg[..., None].expand(-1, -1, 4))
    mult = torch.tensor(BBREG_MULTIPLIERS, device=gt.device)
    reg = torch.where(pos[..., None], encode(anchors[None], matched) * mult, torch.zeros(()))
    neg = ~pos & (max_iou < neg_iou)
    oob = ((anchors[None, :, 0] < 0) | (anchors[None, :, 1] < 0)
           | (anchors[None, :, 2] >= img_w[:, None]) | (anchors[None, :, 3] >= img_h[:, None]))
    use = (pos | neg) & ~oob
    kp = _keep_top(u_pos, pos & use, max_pos)
    kn = _keep_top(u_neg, ~pos & use, sample - kp.sum(-1))
    sampled = kp | kn
    return sampled, pos, pos & sampled, reg


def det_sample(draws, rois, roi_valid, gt, gt_class, gt_valid, num_classes, stride, min_iou,
               pos_iou, num_rois, pos_fraction):
    """The detector's ROI minibatch and its targets: (rois (B, R, 4), class
    (B, R), reg target (B, R, 4), positive (B, R), image has any (B,))."""
    bg = num_classes - 1
    g = gt / float(stride)
    ious = iou(rois, g)
    ious = torch.where(gt_valid[:, None, :], ious, torch.zeros_like(ious))
    mx, arg = ious.max(2).values, ious.argmax(2)
    elig = (mx >= min_iou) & roi_valid
    pos = (mx >= pos_iou) & elig
    cls = torch.where(pos, gt_class.long().gather(1, arg), torch.full_like(arg, bg))
    mult = torch.tensor(BBREG_MULTIPLIERS, device=gt.device)
    reg = encode(rois, g.gather(1, arg[..., None].expand(-1, -1, 4))) * mult
    reg = torch.where(pos[..., None], reg, torch.zeros_like(reg))

    want = int(num_rois * pos_fraction)
    pm, nm = elig & pos, elig & ~pos
    npos, nneg = pm.sum(-1, keepdim=True), nm.sum(-1, keepdim=True)
    inf = torch.full_like(draws.det_pos, NEG_INF)
    pool_p = torch.sort(-torch.where(pm, draws.det_pos, inf), dim=-1, stable=True).indices
    pool_n = torch.sort(-torch.where(nm, draws.det_neg, inf), dim=-1, stable=True).indices
    take = npos.clamp_max(want)
    slots = torch.arange(num_rois, device=rois.device)[None]
    nslot = slots - take
    sn, sp = nneg.clamp_min(1), npos.clamp_min(1)
    mult32 = (65536 % sn) ** 2 % sn
    rnd = ((draws.det_hi % sn) * mult32 + draws.det_lo % sn) % sn
    choice = torch.where(nneg >= num_rois - take, nslot, rnd)
    nidx = torch.where(nneg > 0, pool_n.gather(-1, choice % sn), pool_p.gather(-1, nslot % sp))
    pidx = pool_p.gather(-1, slots.expand_as(nslot) % sp)
    idx = torch.where(slots < take, pidx, nidx)

    def take_rows(x):
        return x.gather(1, idx if x.dim() == 2 else idx[..., None].expand(-1, -1, x.shape[-1]))

    return take_rows(rois), take_rows(cls), take_rows(reg), take_rows(pos), (npos + nneg)[:, 0] > 0


def _smooth_l1(x):
    ax = x.abs()
    return torch.where(ax <= 1.0, 0.5 * ax * ax, ax - 0.5)


def rpn_losses(logits, bbreg, sampled, pos, reg_mask, reg_t, n_cls, n_reg, lam):
    """Per image: the sampled anchors' sigmoid cross-entropy over ``n_cls``,
    and the positives' smooth-L1 times ``lam`` over ``n_reg``."""
    b = logits.shape[0]
    x = logits.reshape(b, -1)
    t = pos.float()
    bce = x.clamp_min(0) - x * t + torch.log1p(torch.exp(-x.abs()))
    l_cls = (sampled.float() * bce).sum(-1) / n_cls
    d = reg_t - bbreg.reshape(b, -1, 4)
    l_reg = lam * (reg_mask.float()[..., None] * _smooth_l1(d)).sum((-2, -1)) / n_reg
    return l_cls, l_reg


def det_losses(logits, reg, cls_t, reg_t, pos, num_classes):
    """Per image: the ROIs' mean cross-entropy, and the positives' smooth-L1
    on their class's four outputs over 4 n_pos + 1e-4 R 4 (C-1)."""
    r, cfg = logits.shape[-2], num_classes - 1
    nll = -torch.log_softmax(logits, -1).gather(-1, cls_t[..., None])[..., 0]
    col = cls_t.clamp_max(cfg - 1)[..., None] * 4 + torch.arange(4, device=reg.device)
    m = pos.float()[..., None]
    num = (m * _smooth_l1(reg_t - reg.gather(-1, col))).sum((-2, -1))
    return nll.mean(-1), num / (4.0 * m.sum((-2, -1)) + 1e-4 * r * 4 * cfg)
