"""The two paths a cell times, computed plainly: detection of a batch of
uint8 canvases, and the joint train step (RPN and detector losses summed,
global-norm clip, SGD with momentum) followed for a few steps.

Inputs are what the benchmark made (weights, frames, boxes, the samplers'
uniform draws) and numbers from the configuration file (``spec``). The
train path takes one thing more from the system under judgment: its
proposals at each step, since proposals are a greedy, discontinuous choice
that a rounding can flip, and a flip there reshuffles the whole ROI sample.
The benchmark checks that stage by itself (``proposals`` on the system's own
RPN outputs).
"""

from __future__ import annotations

import torch

from portbench.reference import nets
from portbench.reference import ops

BGR_MEANS = (103.939, 116.779, 123.68)


def no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def ingest(images_u8):
    """(B, H, W, 3) RGB uint8 -> NCHW BGR float32 minus the ImageNet means."""
    x = images_u8.flip(-1).float() - torch.tensor(BGR_MEANS, device=images_u8.device)
    return x.permute(0, 3, 1, 2)


class Grid:
    """The static anchors of a configuration, on ``device``."""

    def __init__(self, spec: dict, device):
        dims = ops.anchor_dims(spec["anchor_scales"], [tuple(r) for r in spec["anchor_ratios"]])
        s = spec["stride"]
        self.rows, self.cols = spec["canvas_h"] // s, spec["canvas_w"] // s
        self.a = len(dims)
        self.image = torch.from_numpy(ops.anchors_image(self.rows, self.cols, dims, s)).to(device)
        self.conv = torch.from_numpy(ops.anchors_conv(self.rows, self.cols, dims, s)).to(device)


def rpn_proposals(spec, grid, probs, bbreg, img_hw, pre_nms: int, post_nms: int):
    s = spec["stride"]
    return ops.proposals(probs, bbreg, grid.conv, img_hw[:, 0] // s, img_hw[:, 1] // s, grid.a,
                         grid.cols, pre_nms, post_nms, spec["nms_iou"])


@torch.no_grad()
def detect(W, spec: dict, images_u8, img_hw, prec: str = "f32", props=None, block: int = 4):
    """Detection of a batch, ``block`` images at a time. ``props``: the
    proposals (boxes (B, K, 4), valid (B, K)) to follow instead of this
    path's own. Returns a dict on the CPU: ``dets`` (boxes (B, D, 4) canvas
    px, scores, classes, valid), the RPN's ``probs`` (B, N) and ``bbreg``
    (B, N, 4), the proposals used, ``rois`` and ``roi_valid``, and the
    head's ``roi_prob`` (B, R, C), ``roi_reg`` (B, R, 4(C-1)) and class boxes
    ``roi_boxes`` (B, R, C-1, 4) image px."""
    net = nets.Network(spec["network"])
    grid = Grid(spec, images_u8.device)
    parts = []
    for lo in range(0, images_u8.shape[0], block):
        im, hw = images_u8[lo:lo + block], img_hw[lo:lo + block].long()
        feat = net.stages(ingest(im), W, 1, net.last_stage, prec)
        cls, reg = nets.rpn_head(feat, W, prec)
        probs = torch.sigmoid(cls)
        if props is None:
            rois, valid = rpn_proposals(spec, grid, probs, reg, hw, spec["infer_pre_nms"],
                                        spec["infer_post_nms"])
        else:
            rois, valid = (t[lo:lo + block].to(im.device) for t in props)
        pooled = ops.roi_align(feat.permute(0, 2, 3, 1).contiguous(), rois, spec["pool_size"])
        b, r = rois.shape[:2]
        logits, breg = net.head(pooled.reshape((b * r,) + pooled.shape[2:]), W,
                                spec["num_classes"], prec)
        prob = torch.softmax(logits.reshape(b, r, -1), -1)
        breg = breg.reshape(b, r, -1)
        dets = ops.final_detections(
            rois, valid, prob, breg, spec["num_classes"], spec["stride"],
            spec["det_threshold"], spec["final_nms_iou"], spec["infer_post_nms"])
        parts.append(dets + (probs.reshape(b, -1).cpu(), reg.reshape(b, -1, 4).cpu(),
                             rois.cpu(), valid.cpu(), prob.cpu(),
                             ops.class_boxes(rois, breg, spec["stride"]).cpu(), breg.cpu()))
    cat = [torch.cat([p[i] for p in parts]) for i in range(11)]
    return {"dets": tuple(cat[:4]), "probs": cat[4], "bbreg": cat[5], "rois": cat[6],
            "roi_valid": cat[7], "roi_prob": cat[8], "roi_boxes": cat[9], "roi_reg": cat[10]}


def trainable(W: dict, spec: dict):
    """Names of the weights that train: not a batch norm's, and outside the
    frozen backbone stages."""
    net = nets.Network(spec["network"])
    frozen = set(spec["freeze_blocks"])
    return [k for k in W if not nets.is_norm(k) and net.block_of(k) not in frozen
            and not k.endswith((".mean", ".var"))]


def frozen_prefix(spec: dict) -> int:
    k = 0
    for s in range(1, nets.Network(spec["network"]).last_stage + 1):
        if s not in spec["freeze_blocks"]:
            break
        k = s
    return k


def step_losses(W, spec, grid, batch, draws, props, prec: str, lo: int, hi: int):
    """The four losses of rows ``lo:hi`` of a batch, each summed over those
    images (the step's losses are their means over the batch)."""
    net = nets.Network(spec["network"])
    images = batch["image"][lo:hi]
    gt, gt_cls = batch["gt_boxes"][lo:hi].float(), batch["gt_class"][lo:hi]
    gt_valid, hw = batch["gt_valid"][lo:hi].bool(), batch["img_hw"][lo:hi].long()
    d = type(draws)(*(t[lo:hi] for t in draws))
    sg = frozen_prefix(spec)
    with torch.no_grad():
        x = net.stages(ingest(images), W, 1, sg, prec)
    feat = net.stages(x, W, sg + 1, net.last_stage, prec)
    cls, reg = nets.rpn_head(feat, W, prec)
    with torch.no_grad():
        sampled, pos, reg_mask, reg_t = ops.rpn_targets(
            d.rpn_pos, d.rpn_neg, grid.image, gt, gt_valid, hw[:, 1], hw[:, 0], spec["rpn_pos_iou"],
            spec["rpn_neg_iou"], spec["rpn_sample_size"], spec["rpn_max_pos"])
    l_rcls, l_rreg = ops.rpn_losses(cls, reg, sampled, pos, reg_mask, reg_t, spec["n_cls"],
                                    spec["n_reg"], spec["lambda_reg"])
    with torch.no_grad():
        if props is None:
            own = rpn_proposals(spec, grid, torch.sigmoid(cls), reg, hw, spec["train_pre_nms"],
                                spec["train_post_nms"])
        else:
            own = (props[0][lo:hi], props[1][lo:hi])
        rois, cls_t, box_t, pos_m, ok = ops.det_sample(
            d, own[0], own[1], gt, gt_cls, gt_valid, spec["num_classes"],
            spec["stride"], spec["det_min_iou"], spec["det_pos_iou"], spec["num_rois"],
            spec["pos_fraction"])
    pooled = ops.roi_align(feat.permute(0, 2, 3, 1).contiguous(), rois, spec["pool_size"])
    b, r = rois.shape[:2]
    logits, breg = net.head(pooled.reshape((b * r,) + pooled.shape[2:]), W, spec["num_classes"],
                            prec)
    l_dcls, l_dreg = ops.det_losses(logits.reshape(b, r, -1), breg.reshape(b, r, -1), cls_t,
                                    box_t, pos_m, spec["num_classes"])
    s = ok.float()
    return {"rpn_cls": l_rcls.sum(), "rpn_reg": l_rreg.sum(), "det_cls": (l_dcls * s).sum(),
            "det_reg": (l_dreg * s).sum()}, own


def train(W0: dict, spec: dict, batches, draws, props, prec: str = "f32", block: int = 4,
          reduce_grads=None, world: int = 1):
    """Follow the joint train step over ``len(batches)`` steps from weights
    ``W0``. ``props[i]`` is the proposals (boxes, valid) the system made at
    step i; None: this path's own, from its own RPN outputs.
    ``reduce_grads``: on ``world`` processes, each holding its shard of
    every batch, sums a list of tensors over them (each shard's gradient,
    then the average). Returns (losses of each step: a dict of floats, the
    first step's SGD trace by name, the weights after the last step by
    name, the proposals each step used)."""
    if spec["weight_decay"]:
        raise ValueError("the reference follows SGD without weight decay")
    grid = Grid(spec, batches[0]["image"].device)
    names = trainable(W0, spec)
    W = {k: v.detach().clone().float() for k, v in W0.items()}
    for k in names:
        W[k].requires_grad_(True)
    lr, mom, clip = spec["learning_rate"], spec["momentum"], spec["clip_grad_norm"]
    trace = {k: torch.zeros_like(W[k]) for k in names}
    losses, first_trace, used = [], None, []
    for batch, dr, pr in zip(batches, draws, props or [None] * len(batches)):
        n = batch["image"].shape[0]
        grads = {k: torch.zeros_like(W[k]) for k in names}
        total = {"rpn_cls": 0.0, "rpn_reg": 0.0, "det_cls": 0.0, "det_reg": 0.0}
        own = []
        for lo in range(0, n, block):
            parts, p = step_losses(W, spec, grid, batch, dr, pr, prec, lo, min(lo + block, n))
            own.append(p)
            loss = sum(parts.values()) / n
            g = torch.autograd.grad(loss, [W[k] for k in names], allow_unused=True)
            for k, gk in zip(names, g):
                if gk is not None:
                    grads[k] += gk
            for k, v in parts.items():
                total[k] += float(v.detach()) / n
        if reduce_grads is not None:
            flat = reduce_grads([grads[k] for k in names] + [
                torch.tensor([total[k] for k in total], device=grads[names[0]].device)])
            grads = {k: g / world for k, g in zip(names, flat[:-1])}
            total = {k: float(v) / world for k, v in zip(total, flat[-1])}
        total["loss"] = sum(total.values())
        losses.append(total)
        used.append(tuple(torch.cat([p[i] for p in own]) for i in range(2)))
        with torch.no_grad():
            norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
            scale = 1.0 if not clip or norm < clip else clip / norm
            for k in names:
                g = grads[k] if scale == 1.0 else grads[k] / norm * clip
                trace[k] = g + mom * trace[k]
                W[k] -= lr * trace[k]
        if first_trace is None:
            first_trace = {k: t.clone() for k, t in trace.items()}
    return losses, first_trace, {k: W[k].detach() for k in names}, used

