"""The 4-step alternating scheme's freeze specs and weight handoff.

Counterpart of the parts of faster_rcnn_tpu/train/trainer.py that the steps
need (:42-66), with ``run_four_step_training``'s handoff (:325-352):

  step 1  RPN: backbone + RPN head from a fresh model, low blocks frozen;
  step 2  a fresh detector (own backbone + head) on step 1's frozen RPN;
  step 3  RPN again: step 2's backbone, all frozen; a fresh RPN head;
  step 4  detector head only: step 3's backbone and RPN head, on step 3's
          frozen RPN.

Weights move between steps as state dicts, merged by top-level module
(:func:`merge_params`).
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from faster_rcnn_tpu_torch.config import FasterRcnnConfig

ALL_BLOCKS = {"vgg16": (1, 2, 3, 4, 5), "resnet50": (1, 2, 3, 4), "resnet101": (1, 2, 3, 4)}


def step_freeze_spec(step, cfg: FasterRcnnConfig):
    """(freeze_blocks, freeze_modules) of a training step: 1-4 or "joint"."""
    net = cfg.model.network
    if step == 1:
        return cfg.model.freeze_blocks, ("det_head",)
    if step == 2:
        return cfg.model.freeze_blocks, ("rpn_head",)
    if step == 3:  # whole backbone frozen (train_rpn_step3.py:60-81)
        return ALL_BLOCKS[net], ("det_head", "backbone")
    if step == 4:  # heads only
        return ALL_BLOCKS[net], ("backbone", "rpn_head")
    if step == "joint":  # everything trains together
        return cfg.model.freeze_blocks, ()
    raise ValueError(step)


def merge_params(dst: Dict[str, torch.Tensor], src: Dict[str, torch.Tensor],
                 top_keys: Sequence[str]) -> Dict[str, torch.Tensor]:
    """``dst`` with every entry of ``src`` under the top-level modules
    ``top_keys`` (e.g. "backbone": every ``backbone.*`` name) taken from
    ``src``. Both are state dicts of :class:`FasterRCNN`."""
    out = dict(dst)
    out.update({k: v for k, v in src.items() if k.split(".", 1)[0] in top_keys})
    return out
