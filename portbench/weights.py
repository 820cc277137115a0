"""Seeded weights of a detector, made on the device in one draw.

The scales keep activations of order one through the depth on noise
frames: He-normal convolutions, the stem and VGG16's first conv divided by
the pixels' spread (about 64), the last conv of every residual branch at a
quarter (so that the residual stream grows slowly), and random frozen batch
norms near the identity. The RPN's objectness and the classifier get logits
of a few units, so that scores differ clearly; the box outputs stay small.

On noise frames every ROI looks alike, so each class's logit is nearly the
same on every ROI, and a seed whose background row happens to score highest
calls every ROI background (VGG16: 3 of 18 seeds; ResNet-50: 1 of 28). So
the classifier's background row and bias are the foreground rows' mean,
which never scores highest: every seed gives detections to judge.
"""

from __future__ import annotations

import math

import torch

from portbench.reference.nets import weight_shapes

PIXEL_SPREAD = 64.0


def _std(name: str, shape) -> float:
    if len(shape) == 1:
        return 0.0
    fan_in = math.prod(shape[1:])
    he = math.sqrt(2.0 / fan_in)
    if name.startswith(("backbone.conv1.", "backbone.block1_conv1.")):
        return he / PIXEL_SPREAD
    if "_branch2c." in name:
        return he / 4.0
    if ".rpn_out_cls." in name or ".dense_class_" in name:
        return 1.5 * he
    if ".rpn_out_bbreg." in name or ".dense_reg_" in name:
        return 0.2 * he
    return he


def make_weights(spec: dict, seed: int, device) -> dict:
    """Every weight of ``spec``'s network by name, float32 on ``device``,
    from one normal draw of a generator seeded with ``seed``."""
    shapes = weight_shapes(spec["network"], spec["num_classes"], len(spec["anchor_scales"])
                           * len(spec["anchor_ratios"]))
    total = sum(math.prod(s) for s in shapes.values())
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device)
    out, off = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        z = flat[off:off + n].view(shape)
        off += n
        if name.endswith(".var"):
            w = 1.0 + 0.25 * z.abs()
        elif name.endswith(".scale"):
            w = 1.0 + 0.1 * z
        elif name.endswith((".mean", ".bias")) and ".bn" in name:
            w = 0.1 * z
        elif name.endswith(".bias"):
            w = 0.01 * z
        else:
            w = z * _std(name, shape)
        out[name] = w.contiguous()
    c = spec["num_classes"]
    for name in (f"det_head.dense_class_{c}.weight", f"det_head.dense_class_{c}.bias"):
        out[name][-1] = out[name][:-1].mean(0)
    return out
