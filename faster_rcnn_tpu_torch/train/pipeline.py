"""Counterpart of faster_rcnn_tpu/train/pipeline.py: image ingest, the static
anchor constants, proposals from the RPN, the 4-step scheme's RPN step
(:func:`make_rpn_train_step`, steps 1 and 3) and detector step
(:func:`make_det_train_step`, steps 2 and 4), and the joint train step
(:func:`make_joint_train_step`).

  step 1/3  images -> backbone (stages <= k without autograd) -> RPN head
              -> RPN targets + anchor sampling -> RPN losses -> update
  step 2/4  images -> frozen RPN (no autograd) -> proposals (6000 -> NMS
              -> 2000) -> detector targets + 64-ROI sampling -> RoI align
              on the detector's own backbone (step 2) or the frozen RPN's
              map (step 4) -> detector head -> losses -> update
  joint     images -> backbone -> RPN head -> RPN losses; proposals from
              the detached RPN output -> detector targets + sampling ->
              RoI align on the same map -> detector head -> losses; all
              four minimised together

Batch layout: ``image`` (B, Hc, Wc, 3) raw RGB uint8 canvases or float32
preprocessed pixels; ``gt_boxes`` (B, G, 4) float32 resized-image coords;
``gt_class`` (B, G) int; ``gt_valid`` (B, G) bool; ``img_hw`` (B, 2) int,
the actual (h, w) of each image on the canvas.

Data parallel (an optimizer built with a ``mesh``, a parallel/mesh.Mesh):
each process steps on its rows of the global batch with its rows of the
global draws (parallel/multihost.global_draws); the optimizer averages the
gradients over the data column, and the step's metrics are reduced over it
(the losses averaged, ``num_valid_images`` summed), so every process
returns the global batch's metrics, as the JAX package's sharded step does.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.distributed as dist

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
from faster_rcnn_tpu_torch.utils import profiling


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
    return (feat,) + rpn_proposals(cfg, model, feat, img_hw, pre_nms, post_nms, consts, posv)


def rpn_proposals(cfg: FasterRcnnConfig, model: FasterRCNN, feat: torch.Tensor,
                  img_hw: torch.Tensor, pre_nms: int, post_nms: int, consts: Constants, posv):
    """The RPN head on the backbone's map ``feat`` and the proposals from
    it: (boxes (B, K, 4), scores (B, K), valid (B, K))."""
    cls_logits, bbreg = model.rpn(feat)
    probs = torch.sigmoid(cls_logits)
    rows = img_hw[:, 0] // cfg.model.stride
    cols = img_hw[:, 1] // cfg.model.stride
    props = prop_ops.generate_proposals(
        probs, bbreg, consts.anchors_conv, posv(rows, cols), rows, cols,
        pre_nms=pre_nms, post_nms=post_nms, iou_thresh=cfg.rpn.nms_iou,
        nms_tile=cfg.rpn.nms_tile)
    return props.boxes, props.scores, props.valid


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


def _frozen_prefix(cfg: FasterRcnnConfig, freeze_blocks, freeze_modules) -> int:
    return frozen_prefix_stage(
        cfg.model.network, cfg.model.freeze_blocks if freeze_blocks is None else freeze_blocks,
        freeze_modules)


def _batch_on(batch, device):
    """(images, gt_boxes, gt_class, gt_valid, img_hw) of a batch, on ``device``."""
    return (ingest_images(torch.as_tensor(batch["image"], device=device)),
            torch.as_tensor(batch["gt_boxes"], device=device).float(),
            torch.as_tensor(batch["gt_class"], device=device).long(),
            torch.as_tensor(batch["gt_valid"], device=device).bool(),
            torch.as_tensor(batch["img_hw"], device=device).long())


def _draws_on(cfg: FasterRcnnConfig, draws, b: int, device) -> Draws:
    if isinstance(draws, torch.Generator):
        draws = draw_samples(cfg, b, draws)
    return Draws(*(t.to(device) for t in draws))


def _frozen_stages(model: FasterRCNN, images: torch.Tensor, sg_stage: int) -> torch.Tensor:
    """The backbone's stages <= ``sg_stage``, without autograd."""
    backbone = model.backbone
    return backbone.run_stages(images.to(backbone.dtype), 1, sg_stage, sg_stage)


def _trained_stages(model: FasterRCNN, x: torch.Tensor, sg_stage: int) -> torch.Tensor:
    """The backbone's stages above ``sg_stage``, on the frozen prefix's map."""
    backbone = model.backbone
    return backbone.run_stages(x, sg_stage + 1, backbone.last_stage, sg_stage)


def _det_losses(cfg: FasterRcnnConfig, model: FasterRCNN, feat, rois, cls_t, reg_t, pos_m, ok):
    """RoI align of the sampled ROIs on ``feat``, the detector head, and its
    losses with images that have no eligible ROI scaled to 0 (the reference
    skips them): the batch means (det_cls, det_reg)."""
    pooled = roi_align(feat.contiguous(), rois.contiguous(), cfg.det.pool_size)
    dcls, dreg = model.det_head(pooled)
    s = ok.float()
    l_cls = loss_ops.det_cls_loss(dcls, cls_t) * s
    l_reg = loss_ops.det_reg_loss(dreg, reg_t, cls_t, pos_m, cfg.model.num_classes) * s
    return l_cls.mean(), l_reg.mean()


def _update(optimizer: FreezeAwareOptimizer, metrics: dict, mark, num_valid=None) -> dict:
    """Backward of the sum of the losses in ``metrics`` and the optimizer's
    step (the stages ``backward`` and ``optimizer``); returns the detached
    losses, ``loss``, their sum, and ``num_valid_images`` where
    ``num_valid`` is given, reduced over the optimizer's mesh, if it has
    one."""
    with profiling.scope("backward", mark):
        loss = sum(metrics.values())
        optimizer.zero_grad()
        loss.backward()
    with profiling.scope("optimizer", mark):
        optimizer.step()
    out = dict({k: v.detach() for k, v in metrics.items()}, loss=loss.detach())
    if num_valid is not None:
        out["num_valid_images"] = num_valid
    return reduce_metrics(out, optimizer.mesh)


def reduce_metrics(metrics: dict, mesh) -> dict:
    """The global batch's metrics from each data shard's: one all-reduce
    over the mesh's data column, the losses averaged (each is a batch mean
    over equal shards) and ``num_valid_images`` summed. Without a mesh,
    ``metrics`` as they are."""
    if mesh is None:
        return metrics
    names = list(metrics)
    flat = torch.stack([metrics[k].float() for k in names])
    dist.all_reduce(flat, group=mesh.data_group)
    return {k: (v.to(metrics[k].dtype) if k == "num_valid_images" else v / mesh.data)
            for k, v in zip(names, flat)}


def make_rpn_train_step(cfg: FasterRcnnConfig, model: FasterRCNN,
                        optimizer: FreezeAwareOptimizer, freeze_blocks=None,
                        freeze_modules=(), device=None):
    """The RPN train step of the 4-step scheme (steps 1 and 3), faster_rcnn_tpu's
    ``make_rpn_train_step`` (pipeline.py:119-165): backbone, RPN head, RPN
    targets and losses, backward and the freeze-aware update.

    Returns ``step(batch, draws, mark=None) -> metrics`` (``rpn_cls``,
    ``rpn_reg``, ``loss``); ``draws`` and ``mark`` as for
    :func:`make_joint_train_step`, of which only the RPN sampler's draws
    are read. A step is the span ``frcnn.train.rpn`` of the stages
    ``frozen_prefix``, ``backbone_rpn``, ``rpn_targets_losses``,
    ``backward`` and ``optimizer``. ``freeze_blocks``/``freeze_modules``
    are the spec the optimizer was built with (``train.trainer.step_freeze_spec``); the
    backbone runs its frozen prefix without autograd, all of it in step 3.
    Runs on CUDA unless ``device="cpu"``; data parallel when the optimizer
    has a mesh (the module docstring).
    """
    device = resolve_device(device)
    model = model.to(device)
    consts = build_constants(cfg, device)
    sg_stage = _frozen_prefix(cfg, freeze_blocks, freeze_modules)

    def step(batch, draws, mark: Callable[[str], None] | None = None):
        with profiling.scope("frcnn.train.rpn", device=device):
            with profiling.scope("frozen_prefix", mark):
                images, gt_boxes, _, gt_valid, img_hw = _batch_on(batch, device)
                draws = _draws_on(cfg, draws, images.shape[0], device)
                x = _frozen_stages(model, images, sg_stage)
            with profiling.scope("backbone_rpn", mark):
                cls_logits, bbreg = model.rpn(_trained_stages(model, x, sg_stage))
            with profiling.scope("rpn_targets_losses", mark):
                l_cls, l_reg = rpn_losses(cfg, consts, draws, cls_logits, bbreg, gt_boxes,
                                          gt_valid, img_hw)
            return _update(optimizer, {"rpn_cls": l_cls.mean(), "rpn_reg": l_reg.mean()}, mark)

    return step


def make_det_train_step(cfg: FasterRcnnConfig, model: FasterRCNN,
                        optimizer: FreezeAwareOptimizer, rpn_model: FasterRCNN,
                        heads_only: bool = False, freeze_blocks=None, freeze_modules=(),
                        device=None):
    """The detector train step of the 4-step scheme (steps 2 and 4),
    faster_rcnn_tpu's ``make_det_train_step`` (pipeline.py:232-310).

    ``rpn_model`` is the frozen RPN (the JAX step's ``rpn_vars``): its
    backbone, RPN head and proposals run without autograd. Then the
    detector's targets and 64-ROI sample, RoI align, the detector head and
    the losses. ``heads_only=False`` (step 2): RoI align reads the map of
    ``model``'s own backbone, which trains above its frozen prefix.
    ``heads_only=True`` (step 4): RoI align reads the frozen RPN's map,
    ``model``'s backbone does not run, and only the head trains.

    Returns ``step(batch, draws, mark=None) -> metrics`` (``det_cls``,
    ``det_reg``, ``num_valid_images``, ``loss``); ``draws`` and ``mark`` as
    for :func:`make_joint_train_step`, of which only the ROI sampler's draws
    are read. A step is the span ``frcnn.train.det`` of the stages
    ``rpn_proposals``, ``det_targets``, ``frozen_prefix`` and ``backbone``
    (step 2 only), ``roi_align_head``, ``backward`` and ``optimizer``.
    Runs on CUDA unless ``device="cpu"``; data parallel when the
    optimizer has a mesh (the module docstring), and tensor parallel too
    with VGG16's fc head split over its model rows
    (parallel/sharding.shard_vgg_head).
    """
    device = resolve_device(device)
    model = model.to(device)
    rpn_model = rpn_model.to(device)
    consts = build_constants(cfg, device)
    posv = _position_validity(cfg, device)
    sg_stage = _frozen_prefix(cfg, freeze_blocks, freeze_modules)

    def step(batch, draws, mark: Callable[[str], None] | None = None):
        with profiling.scope("frcnn.train.det", device=device):
            with profiling.scope("rpn_proposals", mark):
                images, gt_boxes, gt_class, gt_valid, img_hw = _batch_on(batch, device)
                draws = _draws_on(cfg, draws, images.shape[0], device)
                with torch.no_grad():
                    feat, pboxes, _, pvalid = rpn_forward_proposals(
                        cfg, rpn_model, images, img_hw, cfg.rpn.train_pre_nms,
                        cfg.rpn.train_post_nms, consts=consts, posv=posv)
            with profiling.scope("det_targets", mark):
                rois, cls_t, reg_t, pos_m, ok = det_samples(cfg, draws, pboxes, pvalid,
                                                            gt_boxes, gt_class, gt_valid)
            if not heads_only:
                with profiling.scope("frozen_prefix", mark):
                    x = _frozen_stages(model, images, sg_stage)
                with profiling.scope("backbone", mark):
                    feat = _trained_stages(model, x, sg_stage)
            with profiling.scope("roi_align_head", mark):
                l_cls, l_reg = _det_losses(cfg, model, feat, rois, cls_t, reg_t, pos_m, ok)
            return _update(optimizer, {"det_cls": l_cls, "det_reg": l_reg}, mark, ok.sum())

    return step


def make_joint_train_step(cfg: FasterRcnnConfig, model: FasterRCNN,
                          optimizer: FreezeAwareOptimizer, freeze_blocks=None,
                          freeze_modules=(), device=None):
    """The approximate-joint train step of faster_rcnn_tpu
    (pipeline.py:316-409): one backbone pass serves the RPN losses and, via
    proposals from the detached RPN output and RoI align on the same
    feature map, the detector losses; all four are minimised together.

    Returns ``step(batch, draws, mark=None) -> metrics``. ``draws`` is a
    :class:`Draws` or a ``torch.Generator`` to draw one from. A step is the
    span ``frcnn.train.joint`` (utils/profiling) of the stages
    ``frozen_prefix`` (the batch's ingest and the draws too),
    ``backbone_rpn``, ``rpn_targets_losses``, ``proposals``,
    ``det_targets``, ``roi_align_head``, ``backward`` and ``optimizer``;
    ``mark``, if given, is called with a stage's name as each stage is
    enqueued (for timing). The metrics are 0-dim tensors: ``rpn_cls``,
    ``rpn_reg``, ``det_cls``, ``det_reg``, ``num_valid_images`` and
    ``loss``.

    ``freeze_blocks``/``freeze_modules`` are the spec the optimizer was
    built with (default: ``cfg.model.freeze_blocks``, nothing
    module-frozen); the backbone runs the frozen prefix without autograd.
    Runs on CUDA unless ``device="cpu"``; data parallel when the optimizer
    has a mesh (the module docstring).
    """
    device = resolve_device(device)
    model = model.to(device)
    consts = build_constants(cfg, device)
    posv = _position_validity(cfg, device)
    sg_stage = _frozen_prefix(cfg, freeze_blocks, freeze_modules)
    stride = cfg.model.stride

    def step(batch, draws, mark: Callable[[str], None] | None = None):
        with profiling.scope("frcnn.train.joint", device=device):
            with profiling.scope("frozen_prefix", mark):
                images, gt_boxes, gt_class, gt_valid, img_hw = _batch_on(batch, device)
                draws = _draws_on(cfg, draws, images.shape[0], device)
                x = _frozen_stages(model, images, sg_stage)
            with profiling.scope("backbone_rpn", mark):
                feat = _trained_stages(model, x, sg_stage)
                cls_logits, bbreg = model.rpn(feat)
            with profiling.scope("rpn_targets_losses", mark):
                l_rcls, l_rreg = rpn_losses(cfg, consts, draws, cls_logits, bbreg, gt_boxes,
                                            gt_valid, img_hw)
            with profiling.scope("proposals", mark), torch.no_grad():
                rows, cols = img_hw[:, 0] // stride, img_hw[:, 1] // stride
                props = prop_ops.generate_proposals(
                    torch.sigmoid(cls_logits), bbreg, consts.anchors_conv, posv(rows, cols),
                    rows, cols, pre_nms=cfg.rpn.train_pre_nms, post_nms=cfg.rpn.train_post_nms,
                    iou_thresh=cfg.rpn.nms_iou, nms_tile=cfg.rpn.nms_tile)
            with profiling.scope("det_targets", mark):
                rois, cls_t, reg_t, pos_m, ok = det_samples(cfg, draws, props.boxes, props.valid,
                                                            gt_boxes, gt_class, gt_valid)
            with profiling.scope("roi_align_head", mark):
                l_dcls, l_dreg = _det_losses(cfg, model, feat, rois, cls_t, reg_t, pos_m, ok)
            metrics = {"rpn_cls": l_rcls.mean(), "rpn_reg": l_rreg.mean(),
                       "det_cls": l_dcls, "det_reg": l_dreg}
            return _update(optimizer, metrics, mark, ok.sum())

    return step
