"""The composite Faster R-CNN module: backbone + RPN head + detector head.

Counterpart of faster_rcnn_tpu/models/detector.py, for ``vgg16``,
``resnet50`` and ``resnet101`` (``cfg.model.network``). The three
stages are ``model.backbone(images)``, ``model.rpn(feat)`` and
``model.det_head(pooled)``; their submodules are named ``backbone``,
``rpn_head`` and ``det_head`` as in the Flax tree.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from faster_rcnn_tpu_torch import resolve_device
from faster_rcnn_tpu_torch.config import FasterRcnnConfig
from faster_rcnn_tpu_torch.models.heads import ResNetDetHead, RpnHead, VggDetHead
from faster_rcnn_tpu_torch.models.resnet import ResNetBackbone
from faster_rcnn_tpu_torch.models.vgg import VGG16Backbone

# ImageNet channel means in BGR order ('caffe-mode' preprocessing,
# vgg.py:52-57, resnet.py:64-75): pixels enter the network as BGR minus these.
IMAGENET_BGR_MEANS = np.array([103.939, 116.779, 123.68], np.float32)


def preprocess_rgb(pixels_rgb: np.ndarray) -> np.ndarray:
    """RGB uint8/float (H, W, 3) -> BGR float32 minus ImageNet means."""
    bgr = np.asarray(pixels_rgb, np.float32)[..., ::-1]
    return bgr - IMAGENET_BGR_MEANS


def compute_dtype(cfg: FasterRcnnConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.model.compute_dtype == "bfloat16" else torch.float32


class FasterRCNN(nn.Module):
    def __init__(self, cfg: FasterRcnnConfig):
        super().__init__()
        m = cfg.model
        self.cfg = cfg
        dtype = compute_dtype(cfg)
        if m.network == "vgg16":
            backbone = VGG16Backbone(dtype=dtype)
            det_head = VggDetHead(m.num_classes, cfg.det.pool_size, dtype=dtype)
        elif m.network in ("resnet50", "resnet101"):
            depth = 50 if m.network == "resnet50" else 101
            backbone = ResNetBackbone(depth=depth, dtype=dtype)
            det_head = ResNetDetHead(m.num_classes, depth=depth, dtype=dtype)
        else:
            raise ValueError(f"unknown network {m.network}")
        # registered in this order, which init_model's draws follow
        self.backbone = backbone
        # faster_rcnn_tpu builds its RpnHead without a dtype, so the RPN's 3x3
        # conv runs in bf16 whatever compute_dtype says (detector.py:62)
        self.rpn_head = RpnHead(m.final_conv_filters, cfg.anchors.num_anchors,
                                dtype=torch.bfloat16)
        self.det_head = det_head

    def rpn(self, feat: torch.Tensor):
        """Feature map -> (objectness logits (B, h, w, A), bbreg (B, h, w, 4A))."""
        return self.rpn_head(feat)


def init_model(seed: int, cfg: FasterRcnnConfig, device=None) -> FasterRCNN:
    """A model with random weights drawn from ``torch.Generator(seed)`` with
    the Flax initialisers' distributions, on ``device`` (CUDA by default)."""
    device = resolve_device(device)
    model = FasterRCNN(cfg)
    gen = torch.Generator().manual_seed(int(seed))
    for mod in model.modules():
        if hasattr(mod, "reset_parameters"):
            mod.reset_parameters(gen)
    return model.to(device).eval()
