"""Counterpart of faster_rcnn_tpu/train/pipeline.py: image ingest, the static
anchor constants, proposals from the RPN, and the joint train step
(:func:`make_joint_train_step`). The 4-step scheme's RPN and detector steps
come with a later slice.

The joint step, in one pass over a batch:

  images -> backbone (stages <= k without autograd) -> RPN head
    -> RPN targets + anchor sampling -> RPN losses
    -> proposals (6000 -> NMS -> 2000) from the detached RPN output
    -> detector targets + 64-ROI sampling
    -> RoI align on the same feature map -> detector head -> losses
    -> backward -> freeze-aware optimizer update

Batch layout: ``image`` (B, Hc, Wc, 3) raw RGB uint8 canvases or float32
preprocessed pixels; ``gt_boxes`` (B, G, 4) float32 resized-image coords;
``gt_class`` (B, G) int; ``gt_valid`` (B, G) bool; ``img_hw`` (B, 2) int,
the actual (h, w) of each image on the canvas.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from faster_rcnn_tpu_torch import resolve_device
from faster_rcnn_tpu_torch.config import FasterRcnnConfig
from faster_rcnn_tpu_torch.models.detector import IMAGENET_BGR_MEANS, FasterRCNN
from faster_rcnn_tpu_torch.ops import anchors as anchor_ops
from faster_rcnn_tpu_torch.ops import losses as loss_ops
from faster_rcnn_tpu_torch.ops import proposals as prop_ops
from faster_rcnn_tpu_torch.ops import targets as tgt_ops
from faster_rcnn_tpu_torch.ops.roi_align_cuda import roi_align
from faster_rcnn_tpu_torch.ops.sampling import sample_det_rois
from faster_rcnn_tpu_torch.parallel.freeze import FreezeAwareOptimizer, frozen_prefix_stage


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


# ---------------------------------------------------------------------------
# the joint train step
# ---------------------------------------------------------------------------


class Draws(NamedTuple):
    """The random numbers of one joint step's samplers."""

    rpn_pos: torch.Tensor  # (B, N) uniform priorities of the positive anchors
    rpn_neg: torch.Tensor  # (B, N) ... of the negative anchors
    det_pos: torch.Tensor  # (B, K) uniform priorities of the positive proposals
    det_neg: torch.Tensor  # (B, K) ... of the negative proposals
    det_hi: torch.Tensor   # (B, R) int64 32-bit words of the draw with replacement
    det_lo: torch.Tensor   # (B, R)


def draw_samples(cfg: FasterRcnnConfig, b: int, generator: torch.Generator) -> Draws:
    """One step's draws from ``generator``, on its device."""
    n = cfg.conv_h * cfg.conv_w * cfg.anchors.num_anchors
    k, r = cfg.rpn.train_post_nms, cfg.det.num_rois
    dev = generator.device

    def u(m):
        return torch.rand((b, m), generator=generator, device=dev)

    def bits():
        return torch.randint(0, 2 ** 32, (b, r), generator=generator, device=dev)

    return Draws(u(n), u(n), u(k), u(k), bits(), bits())


def rpn_losses(cfg: FasterRcnnConfig, consts: Constants, draws: Draws, cls_logits, bbreg,
               gt_boxes, gt_valid, img_hw):
    """RPN targets and masked losses of a batch, per image: (B,), (B,).
    Counterpart of ``rpn_losses_one_image`` over the batch."""
    b = cls_logits.shape[0]
    with torch.no_grad():
        tg = tgt_ops.rpn_targets(
            draws.rpn_pos, draws.rpn_neg, consts.anchors_image, gt_boxes, gt_valid,
            img_hw[:, 1], img_hw[:, 0], pos_iou=cfg.rpn.pos_iou, neg_iou=cfg.rpn.neg_iou,
            sample_size=cfg.rpn.sample_size, max_pos=cfg.rpn.max_pos_samples)
    l_cls = loss_ops.rpn_cls_loss(cls_logits.reshape(b, -1), tg.cls_target, tg.cls_mask,
                                  cfg.rpn.n_cls)
    l_reg = loss_ops.rpn_reg_loss(bbreg.reshape(b, -1, 4), tg.reg_target, tg.reg_mask,
                                  cfg.rpn.n_reg, cfg.rpn.lambda_reg)
    return l_cls, l_reg


@torch.no_grad()
def det_samples(cfg: FasterRcnnConfig, draws: Draws, rois, roi_valid, gt_boxes, gt_class,
                gt_valid):
    """Detector targets and the ROI minibatch of a batch: (rois (B, R, 4),
    class targets (B, R), regression targets (B, R, 4), positive mask
    (B, R), image has any eligible ROI (B,)). Counterpart of
    ``det_losses_one_image`` over the batch."""
    tg = tgt_ops.det_targets(rois, roi_valid, gt_boxes, gt_class, gt_valid,
                             num_classes=cfg.model.num_classes, stride=cfg.model.stride,
                             min_iou=cfg.det.min_iou, pos_iou=cfg.det.pos_iou)
    idx, ok = sample_det_rois(draws.det_pos, draws.det_neg, draws.det_hi, draws.det_lo,
                              tg.eligible, tg.is_pos, cfg.det.num_rois, cfg.det.pos_fraction)

    def take(x):
        if x.dim() == 2:
            return torch.gather(x, 1, idx)
        return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))

    return take(rois), take(tg.cls_target), take(tg.reg_target), take(tg.is_pos), ok


def make_joint_train_step(cfg: FasterRcnnConfig, model: FasterRCNN,
                          optimizer: FreezeAwareOptimizer, freeze_blocks=None,
                          freeze_modules=(), device=None):
    """The approximate-joint train step of faster_rcnn_tpu
    (pipeline.py:316-409): one backbone pass serves the RPN losses and, via
    proposals from the detached RPN output and RoI align on the same
    feature map, the detector losses; all four are minimised together.

    Returns ``step(batch, draws, mark=None) -> metrics``. ``draws`` is a
    :class:`Draws` or a ``torch.Generator`` to draw one from. ``mark``, if
    given, is called with a stage's name as each stage is enqueued (for
    timing). The metrics are 0-dim tensors: ``rpn_cls``, ``rpn_reg``,
    ``det_cls``, ``det_reg``, ``num_valid_images`` and ``loss``.

    ``freeze_blocks``/``freeze_modules`` are the spec the optimizer was
    built with (default: ``cfg.model.freeze_blocks``, nothing
    module-frozen); the backbone runs the frozen prefix without autograd.
    Runs on CUDA unless ``device="cpu"``.
    """
    device = resolve_device(device)
    model = model.to(device)
    consts = build_constants(cfg, device)
    posv = _position_validity(cfg, device)
    sg_stage = frozen_prefix_stage(
        cfg.model.network, cfg.model.freeze_blocks if freeze_blocks is None else freeze_blocks,
        freeze_modules)
    stride = cfg.model.stride

    def step(batch, draws, mark: Callable[[str], None] | None = None):
        mark = mark or (lambda _: None)
        images = ingest_images(torch.as_tensor(batch["image"], device=device))
        gt_boxes = torch.as_tensor(batch["gt_boxes"], device=device).float()
        gt_class = torch.as_tensor(batch["gt_class"], device=device).long()
        gt_valid = torch.as_tensor(batch["gt_valid"], device=device).bool()
        img_hw = torch.as_tensor(batch["img_hw"], device=device).long()
        if isinstance(draws, torch.Generator):
            draws = draw_samples(cfg, images.shape[0], draws)
        draws = Draws(*(t.to(device) for t in draws))

        backbone = model.backbone
        x = backbone.run_stages(images.to(backbone.dtype), 1, sg_stage, sg_stage)
        mark("frozen_prefix")
        feat = backbone.run_stages(x, sg_stage + 1, 4, sg_stage)
        cls_logits, bbreg = model.rpn(feat)
        mark("stage4_rpn")

        l_rcls, l_rreg = rpn_losses(cfg, consts, draws, cls_logits, bbreg, gt_boxes, gt_valid,
                                    img_hw)
        mark("rpn_targets_losses")
        with torch.no_grad():
            rows, cols = img_hw[:, 0] // stride, img_hw[:, 1] // stride
            props = prop_ops.generate_proposals(
                torch.sigmoid(cls_logits), bbreg, consts.anchors_conv, posv(rows, cols), rows,
                cols, pre_nms=cfg.rpn.train_pre_nms, post_nms=cfg.rpn.train_post_nms,
                iou_thresh=cfg.rpn.nms_iou, nms_tile=cfg.rpn.nms_tile)
        mark("proposals")
        rois, cls_t, reg_t, pos_m, ok = det_samples(cfg, draws, props.boxes, props.valid,
                                                    gt_boxes, gt_class, gt_valid)
        mark("det_targets")

        pooled = roi_align(feat.contiguous(), rois.contiguous(), cfg.det.pool_size)
        dcls, dreg = model.det_head(pooled)
        s = ok.float()
        l_dcls = loss_ops.det_cls_loss(dcls, cls_t) * s
        l_dreg = loss_ops.det_reg_loss(dreg, reg_t, cls_t, pos_m, cfg.model.num_classes) * s
        metrics = {"rpn_cls": l_rcls.mean(), "rpn_reg": l_rreg.mean(),
                   "det_cls": l_dcls.mean(), "det_reg": l_dreg.mean()}
        loss = metrics["rpn_cls"] + metrics["rpn_reg"] + metrics["det_cls"] + metrics["det_reg"]
        mark("roi_align_head")

        optimizer.zero_grad()
        loss.backward()
        mark("backward")
        optimizer.step()
        mark("optimizer")
        metrics = {k: v.detach() for k, v in metrics.items()}
        return dict(metrics, num_valid_images=ok.sum(), loss=loss.detach())

    return step
