"""The composite Faster R-CNN module: backbone + RPN head + detector head.

Counterpart of faster_rcnn_tpu/models/detector.py for ResNet-50. The three
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
from faster_rcnn_tpu_torch.models.heads import ResNetDetHead, RpnHead
from faster_rcnn_tpu_torch.models.resnet import ResNetBackbone

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
        if m.network != "resnet50":
            raise ValueError(f"only resnet50 is ported so far, not {m.network}")
        self.cfg = cfg
        dtype = compute_dtype(cfg)
        self.backbone = ResNetBackbone(depth=50, dtype=dtype)
        # faster_rcnn_tpu builds its RpnHead without a dtype, so the RPN's 3x3
        # conv runs in bf16 whatever compute_dtype says (detector.py:62)
        self.rpn_head = RpnHead(m.final_conv_filters, cfg.anchors.num_anchors,
                                dtype=torch.bfloat16)
        self.det_head = ResNetDetHead(m.num_classes, dtype=dtype)

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
