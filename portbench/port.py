"""The system under test, built from a configuration file: the port's
config, its model holding the benchmark's weights, its detect function and
its joint train step with the freeze-aware optimizer; the taps that read
its proposal stage and its kernels' inputs. Besides this module, only a
multi-card rank imports the port, to build its kernels once a host."""

from __future__ import annotations

import contextlib
from unittest import mock

import torch

from faster_rcnn_tpu_torch import _build, inference
from faster_rcnn_tpu_torch.config import (AnchorConfig, DataConfig, DetConfig,
                                          FasterRcnnConfig, ModelConfig, RpnConfig, TrainConfig)
from faster_rcnn_tpu_torch.models import resnet
from faster_rcnn_tpu_torch.models.detector import FasterRCNN
from faster_rcnn_tpu_torch.ops import nms_cuda, roi_align_cuda, sort_cuda
from faster_rcnn_tpu_torch.ops import proposals as proposal_ops
from faster_rcnn_tpu_torch.parallel import mesh as mesh_lib
from faster_rcnn_tpu_torch.parallel.freeze import FreezeAwareOptimizer
from faster_rcnn_tpu_torch.train import pipeline

LAUNCHES = _build.LAUNCHES
Draws = pipeline.Draws


def port_config(spec: dict) -> FasterRcnnConfig:
    return FasterRcnnConfig(
        anchors=AnchorConfig(scales=tuple(spec["anchor_scales"]),
                             ratios=tuple(tuple(r) for r in spec["anchor_ratios"])),
        rpn=RpnConfig(pos_iou=spec["rpn_pos_iou"], neg_iou=spec["rpn_neg_iou"],
                      sample_size=spec["rpn_sample_size"], max_pos_samples=spec["rpn_max_pos"],
                      train_pre_nms=spec["train_pre_nms"], train_post_nms=spec["train_post_nms"],
                      infer_pre_nms=spec["infer_pre_nms"], infer_post_nms=spec["infer_post_nms"],
                      nms_iou=spec["nms_iou"], nms_tile=spec["nms_tile"], n_cls=spec["n_cls"],
                      n_reg=spec["n_reg"], lambda_reg=spec["lambda_reg"]),
        det=DetConfig(min_iou=spec["det_min_iou"], pos_iou=spec["det_pos_iou"],
                      num_rois=spec["num_rois"], pos_fraction=spec["pos_fraction"],
                      pool_size=spec["pool_size"], final_nms_iou=spec["final_nms_iou"],
                      det_threshold=spec["det_threshold"]),
        data=DataConfig(resize_max=spec["frame_w"], canvas_h=spec["canvas_h"],
                        canvas_w=spec["canvas_w"], max_gt_boxes=spec["max_gt_boxes"]),
        model=ModelConfig(network=spec["network"], num_classes=spec["num_classes"],
                          stride=spec["stride"], pooling_regions=spec["pool_size"],
                          weight_decay=spec["weight_decay"],
                          freeze_blocks=tuple(spec["freeze_blocks"]),
                          compute_dtype=spec["compute_dtype"]),
        train=TrainConfig(momentum=spec["momentum"], clip_grad_norm=spec["clip_grad_norm"]),
    )


def model(spec: dict, weights: dict, device) -> FasterRCNN:
    """The port's detector on ``device`` holding ``weights`` (copied in)."""
    with torch.device(device):
        m = FasterRCNN(port_config(spec))
    m.load_state_dict(weights, strict=True)
    return m.eval()


def detect_fn(spec: dict, m: FasterRCNN, device):
    return inference.make_detect_fn(port_config(spec), m, device)


def train_step(spec: dict, m: FasterRCNN, device, data_parallel: bool = False):
    """(step, optimizer): the joint train step and the optimizer that
    ``train_one_step`` builds, with the data-only mesh of the process group
    when ``data_parallel``."""
    cfg = port_config(spec)
    mesh = mesh_lib.create_mesh() if data_parallel else None
    if mesh is not None:
        mesh_lib.replicated(mesh, m.state_dict())
    opt = FreezeAwareOptimizer(m, spec["network"], tuple(spec["freeze_blocks"]),
                               spec["learning_rate"], optimizer="sgd", momentum=spec["momentum"],
                               weight_decay=spec["weight_decay"],
                               clip_grad_norm=spec["clip_grad_norm"], mesh=mesh)
    return pipeline.make_joint_train_step(cfg, m, opt, device=device), opt


class ProposalTap:
    """While open, records the calls of the port's proposal stage made while
    ``armed``: its inputs (objectness, box outputs) and what it returned;
    and, in detection, the inputs of the call's final decode (its ROIs,
    their flags, the head's class probabilities and box outputs) under
    ``decode`` of the same record. Unarmed calls cost one flag test."""

    def __init__(self, armed: bool = True):
        self.calls = []
        self.armed = armed
        self._orig = proposal_ops.generate_proposals
        self._orig_decode = inference._decode_one_image

    def __enter__(self):
        def tapped(probs, bbreg, anchors, posv, rows, cols, **kw):
            out = self._orig(probs, bbreg, anchors, posv, rows, cols, **kw)
            if self.armed:
                self.calls.append({"probs": probs.detach().clone(),
                                   "bbreg": bbreg.detach().clone(),
                                   "boxes": out.boxes.clone(), "valid": out.valid.clone()})
            return out

        def tapped_decode(cfg, rois, roi_valid, cls_prob, reg_out):
            if self.armed and self.calls:
                self.calls[-1]["decode"] = tuple(t.detach().clone()
                                                 for t in (rois, roi_valid, cls_prob, reg_out))
            return self._orig_decode(cfg, rois, roi_valid, cls_prob, reg_out)

        proposal_ops.generate_proposals = tapped
        inference._decode_one_image = tapped_decode
        return self

    def __exit__(self, *exc):
        proposal_ops.generate_proposals = self._orig
        inference._decode_one_image = self._orig_decode


def optimizer_traces(opt) -> dict:
    """The SGD trace of every trained weight, by name (the live tensors)."""
    return {name: st["trace"] for name, st in opt.state.items()}


def trained_names(opt):
    return [name for name, _, _ in opt.params]


@contextlib.contextmanager
def kernel_inputs(out: dict):
    """While open, records what the kernels' byte and operation counts need
    of each launch (shapes, the ROIs, NMS's keep mask), by name: ``k1_fwd``,
    ``k1_bwd``, ``k2``, ``k3``, ``k4``. Keeps references, copies nothing."""
    def rec(name, fn, what):
        def wrapped(*a, **kw):
            got = fn(*a, **kw)
            out.setdefault(name, []).append(what(got, *a, **kw))
            return got
        return wrapped

    k1 = rec("k1_fwd", roi_align_cuda.roi_align,
             lambda got, feat, rois, p=7: (tuple(feat.shape), rois, p, feat.element_size()))
    patches = [
        (inference, "roi_align", k1), (pipeline, "roi_align", k1),
        (roi_align_cuda, "roi_align_backward",
         rec("k1_bwd", roi_align_cuda.roi_align_backward,
             lambda got, grad, rois, shape, p=7: (grad.numel(), got.numel(), rois.numel(),
                                                  grad.element_size()))),
        (resnet, "conv1_kernel",
         rec("k2", resnet.conv1_kernel, lambda got, x, w: (x.numel(), got.numel()))),
        (nms_cuda, "nms_keep_mask",
         rec("k3", nms_cuda.nms_keep_mask,
             lambda got, boxes, valid, iou, tile, enough: (tuple(boxes.shape), got, valid, tile,
                                                           enough))),
        (sort_cuda, "topk_sorted",
         rec("k4", sort_cuda.topk_sorted, lambda got, scores, k: tuple(scores.shape) + (k,))),
    ]
    with contextlib.ExitStack() as stack:
        for mod, attr, fn in patches:
            stack.enter_context(mock.patch.object(mod, attr, fn))
        yield out
