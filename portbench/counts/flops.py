"""Model FLOPs of a call, counted by ``torch.utils.flop_counter`` over the
plain reference on meta tensors at the cell's shapes, so the count is the
same whatever implements the work: the backbone, the RPN head and the
detector head over the call's ROIs (convolutions and matrix products; RoI
align, NMS and the elementwise work are not counted). For training, the
forward and the backward that the joint step needs: the frozen prefix
without autograd, the rest with it, as the step runs."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.reference import nets
from portbench.reference.paths import frozen_prefix


def meta_weights(spec: dict, requires_grad: bool) -> dict:
    shapes = nets.weight_shapes(spec["network"], spec["num_classes"],
                                len(spec["anchor_scales"]) * len(spec["anchor_ratios"]))
    return {k: torch.empty(s, device="meta", requires_grad=requires_grad and len(s) > 1)
            for k, s in shapes.items()}


def _count(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return int(fc.get_total_flops())


def per_image(spec: dict, train: bool, rois_per_image: int) -> float:
    """FLOPs per image of one detect call (``train=False``) or one joint
    step, with ``rois_per_image`` ROIs through the detector head."""
    net = nets.Network(spec["network"])
    W = meta_weights(spec, requires_grad=train)
    h, w = spec["canvas_h"], spec["canvas_w"]
    feat_c = 1024 if spec["network"] == "resnet50" else 512
    x = torch.empty((1, 3, h, w), device="meta")
    pooled = torch.empty((rois_per_image, spec["pool_size"], spec["pool_size"], feat_c),
                         device="meta", requires_grad=train)

    def run():
        sg = frozen_prefix(spec) if train else net.last_stage
        with torch.no_grad():
            y = net.stages(x, W, 1, sg, "f32")
        with torch.set_grad_enabled(train):
            y = net.stages(y, W, sg + 1, net.last_stage, "f32")
            cls, reg = nets.rpn_head(y, W, "f32")
            logits, box = net.head(pooled, W, spec["num_classes"], "f32")
            if train:
                (cls.sum() + reg.sum() + logits.sum() + box.sum()).backward()

    return float(_count(run))
