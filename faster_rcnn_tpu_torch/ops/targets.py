"""Training-target constants (the rest of faster_rcnn_tpu/ops/targets.py
comes with the training slice)."""

import torch

BBREG_MULTIPLIERS = torch.tensor([10.0, 10.0, 5.0, 5.0], dtype=torch.float32)  # shared_constants.py:5
