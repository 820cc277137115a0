"""RPN and ResNet detector heads.

Counterpart of faster_rcnn_tpu/models/heads.py (``VggDetHead`` waits for the
VGG16 slice). The RPN's 1x1 outputs and the dense outputs run in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from faster_rcnn_tpu_torch.models.layers import Conv2d, Dense
from faster_rcnn_tpu_torch.models.resnet import ResNetStage5


class RpnHead(nn.Module):
    """Shared 3x3x512 conv, then 1x1 objectness logits (A channels) and 1x1
    regression (4A channels): (B, h, w, F) -> ((B, h, w, A), (B, h, w, 4A))."""

    def __init__(self, cin: int, anchors_per_loc: int = 18, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.rpn_conv1 = Conv2d(cin, 512, 3, dtype=dtype, init_std=0.01)
        self.rpn_out_cls = Conv2d(512, anchors_per_loc, 1, dtype=torch.float32, init_std=0.01)
        self.rpn_out_bbreg = Conv2d(512, 4 * anchors_per_loc, 1, dtype=torch.float32,
                                    init_std=0.01)

    def forward(self, feat: torch.Tensor):
        net = F.relu(self.rpn_conv1(feat)).float()
        return self.rpn_out_cls(net), self.rpn_out_bbreg(net)


class ResNetDetHead(nn.Module):
    """Pooled ROIs (..., P, P, 1024) -> (class logits (..., C), per-class
    regression (..., 4(C-1))); leading axes are folded into one batch."""

    def __init__(self, num_classes: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_classes = num_classes
        self.stage5 = ResNetStage5(dtype=dtype)
        self.add_module(f"dense_class_{num_classes}", Dense(2048, num_classes, 0.01))
        self.add_module(f"dense_reg_{num_classes}", Dense(2048, 4 * (num_classes - 1), 0.001))

    def forward(self, pooled: torch.Tensor):
        lead = pooled.shape[:-3]
        x = self.stage5(pooled.reshape((-1,) + tuple(pooled.shape[-3:])).to(self.stage5.dtype))
        x32 = x.float()
        c = self.num_classes
        cls = self._modules[f"dense_class_{c}"](x32)
        reg = self._modules[f"dense_reg_{c}"](x32)
        return cls.reshape(lead + (c,)), reg.reshape(lead + (4 * (c - 1),))
