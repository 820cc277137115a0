"""VGG16 backbone: 13 SAME 3x3 convs in 5 blocks, the final max-pool dropped,
so the output stride is 16 and the feature width 512.

Counterpart of faster_rcnn_tpu/models/vgg.py. Module names are the Keras
layer names of the Flax tree (``block{i}_conv{j}``), so weights map across
by name (utils/convert.py) and the freeze rules read the block from the name
(:func:`vgg_param_block`). Activations are NHWC.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from faster_rcnn_tpu_torch.models.layers import Conv2d

# (block, convs, filters)
_VGG_CFG = ((1, 2, 64), (2, 2, 128), (3, 3, 256), (4, 3, 512), (5, 3, 512))


class VGG16Backbone(nn.Module):
    """(B, H, W, 3) preprocessed pixels -> (B, H/16, W/16, 512). Each conv
    is followed by a ReLU, blocks 1-4 by a 2x2/s2 max-pool."""

    last_stage = 5

    def __init__(self, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        cin = 3
        for block, convs, filters in _VGG_CFG:
            for conv in range(1, convs + 1):
                self.add_module(f"block{block}_conv{conv}", Conv2d(cin, filters, 3, dtype=dtype))
                cin = filters

    def _stage(self, x: torch.Tensor, block: int) -> torch.Tensor:
        for name, mod in self.named_children():
            if name.startswith(f"block{block}_"):
                x = F.relu(mod(x))
        if block < 5:
            x = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
        return x

    def run_stages(self, x: torch.Tensor, first: int, last: int,
                   stop_grad_stage: int = 0) -> torch.Tensor:
        """Blocks ``first`` .. ``last`` on ``x``; a block at or below
        ``stop_grad_stage`` runs without autograd, as the JAX package's
        ``stop_gradient`` after block k (vgg.py:48-49)."""
        grad = torch.is_grad_enabled()
        for block in range(first, last + 1):
            with torch.set_grad_enabled(grad and block > stop_grad_stage):
                x = self._stage(x, block)
        return x

    def forward(self, x: torch.Tensor, stop_grad_stage: int = 0) -> torch.Tensor:
        return self.run_stages(x.to(self.dtype), 1, self.last_stage, stop_grad_stage)


def vgg_param_block(path: Sequence[str]) -> int | None:
    """The 1-based VGG block of a parameter, for the freeze rules; None
    outside the backbone's convs. ``path`` is the name split at the dots."""
    for p in path:
        if p.startswith("block") and "_conv" in p:
            return int(p[5])
    return None
