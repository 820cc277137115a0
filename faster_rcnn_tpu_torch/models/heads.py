"""RPN and detector heads.

Counterpart of faster_rcnn_tpu/models/heads.py: the RPN head, VGG16's fc
head and ResNet's stage-5 head. The RPN's 1x1 outputs and the dense class
and regression outputs run in float32.
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


def _outputs(head: nn.Module, cin: int, num_classes: int) -> None:
    """The class logits (C) and per-class regression (4(C-1)) outputs, named
    as in the Flax tree."""
    head.add_module(f"dense_class_{num_classes}", Dense(cin, num_classes, 0.01))
    head.add_module(f"dense_reg_{num_classes}", Dense(cin, 4 * (num_classes - 1), 0.001))


def _apply_outputs(head: nn.Module, x32: torch.Tensor, lead, num_classes: int):
    c = num_classes
    cls = head._modules[f"dense_class_{c}"](x32)
    reg = head._modules[f"dense_reg_{c}"](x32)
    return cls.reshape(lead + (c,)), reg.reshape(lead + (4 * (c - 1),))


class VggDetHead(nn.Module):
    """Pooled ROIs (..., 7, 7, 512) -> (class logits (..., C), per-class
    regression (..., 4(C-1))): each ROI flattened in NHWC order into 25,088
    values (the order of the Flax kernel's rows), then ``fc1`` and ``fc2``
    (4096, ReLU) in the compute dtype, then the outputs in f32."""

    def __init__(self, num_classes: int, pool_size: int = 7, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_classes = num_classes
        self.fc1 = Dense(pool_size * pool_size * 512, 4096, dtype=dtype)
        self.fc2 = Dense(4096, 4096, dtype=dtype)
        _outputs(self, 4096, num_classes)

    def forward(self, pooled: torch.Tensor):
        lead = pooled.shape[:-3]
        x = pooled.reshape(-1, self.fc1.weight.shape[1])
        x = F.relu(self.fc2(F.relu(self.fc1(x))))
        return _apply_outputs(self, x.float(), lead, self.num_classes)


class ResNetDetHead(nn.Module):
    """Pooled ROIs (..., P, P, 1024) -> (class logits (..., C), per-class
    regression (..., 4(C-1))); leading axes are folded into one batch."""

    def __init__(self, num_classes: int, depth: int = 50, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_classes = num_classes
        self.stage5 = ResNetStage5(depth=depth, dtype=dtype)
        _outputs(self, 2048, num_classes)

    def forward(self, pooled: torch.Tensor):
        lead = pooled.shape[:-3]
        x = self.stage5(pooled.reshape((-1,) + tuple(pooled.shape[-3:])).to(self.stage5.dtype))
        return _apply_outputs(self, x.float(), lead, self.num_classes)
