"""The one generator of every mix's inputs, from ``--seed`` and the mix's
parameters: KITTI-sized frames of uniform noise on a zero canvas, seeded
ground-truth boxes of car-to-pedestrian size, and the samplers' draws of
each training step. The same seed gives the same inputs, on any rank and
in the reference."""

from __future__ import annotations

import numpy as np
import torch

_MIX = 1_000_003


def _gen(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed((int(seed) * _MIX + stream) % (2 ** 63))


def frames(spec: dict, mix: dict, seed: int, index: int, device) -> torch.Tensor:
    """Batch ``index``'s (rows, H, W, 3) uint8 canvases on ``device``: the
    frame (``frame_h`` x ``frame_w``) holds noise, the padding zeros."""
    b, (h, w) = mix["batch"], (spec["canvas_h"], spec["canvas_w"])
    fh, fw = spec["frame_h"], spec["frame_w"]
    out = torch.zeros((b, h, w, 3), dtype=torch.uint8, device=device)
    out[:, :fh, :fw] = torch.randint(0, 256, (b, fh, fw, 3), generator=_gen(seed, index, device),
                                     device=device, dtype=torch.uint8)
    return out


def frame_hw(spec: dict, mix: dict) -> np.ndarray:
    return np.tile(np.array([[spec["frame_h"], spec["frame_w"]]], np.int64), (mix["batch"], 1))


def boxes(spec: dict, mix: dict, seed: int, index: int) -> dict:
    """Batch ``index``'s ground truth, numpy: per image ``gt_min``-``gt_max``
    boxes, ``box_w`` wide and ``box_h`` tall (resized-image px) inside the
    frame, classes below the background's."""
    rng = np.random.default_rng([int(seed) % (2 ** 63), index])
    b, g = mix["batch"], spec["max_gt_boxes"]
    fh, fw = spec["frame_h"], spec["frame_w"]
    gt = np.zeros((b, g, 4), np.float32)
    cls = np.zeros((b, g), np.int64)
    valid = np.zeros((b, g), bool)
    for i in range(b):
        n = int(rng.integers(mix["gt_min"], mix["gt_max"] + 1))
        w = rng.uniform(*mix["box_w"], n)
        h = rng.uniform(*mix["box_h"], n)
        x1, y1 = rng.uniform(0, fw - w), rng.uniform(0, fh - h)
        gt[i, :n] = np.stack([x1, y1, x1 + w, y1 + h], 1)
        cls[i, :n] = rng.integers(0, spec["num_classes"] - 1, n)
        valid[i, :n] = True
    return {"gt_boxes": gt, "gt_class": cls, "gt_valid": valid, "img_hw": frame_hw(spec, mix)}


def train_batch(spec: dict, mix: dict, seed: int, index: int, device) -> dict:
    """Batch ``index`` of a training mix, resident on ``device``."""
    out = {k: torch.as_tensor(v, device=device) for k, v in boxes(spec, mix, seed, index).items()}
    out["image"] = frames(spec, mix, seed, index, device)
    return out


def draws(spec: dict, rows: int, seed: int, step: int, device, draws_type):
    """Step ``step``'s sampler draws for ``rows`` images: uniform priorities
    of every anchor and proposal, and two 32-bit words a sampled ROI."""
    g = _gen(seed, 10_000_000 + step, device)
    n = (spec["canvas_h"] // spec["stride"]) * (spec["canvas_w"] // spec["stride"]) \
        * len(spec["anchor_scales"]) * len(spec["anchor_ratios"])
    k, r = spec["train_post_nms"], spec["num_rois"]

    def u(m):
        return torch.rand((rows, m), generator=g, device=device)

    def bits():
        return torch.randint(0, 2 ** 32, (rows, r), generator=g, device=device)

    return draws_type(u(n), u(n), u(k), u(k), bits(), bits())
