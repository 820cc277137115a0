"""Anchor grid generation (NumPy; a copy of faster_rcnn_tpu/ops/anchors.py).

Anchor geometry is *static* given the canvas size and anchor dims, so it is
computed once on the host with exact NumPy integer arithmetic (matching the
reference's int semantics bit-for-bit) and moved to the device once per
detection function — no per-step cost.

Two coordinate spaces, as in the reference:

* **image space** (used for RPN target assignment, rpn_util.py:276-298):
  centers at ``stride * (i + 0.5)`` truncated to int, corners via integer
  ``center - dim // 2``.
* **feature/conv space** (used for proposal decode, det_util.py:162-175 with
  ``anchor_dims // stride``): centers at the integer grid position ``(x, y)``
  itself (NOT +0.5), dims pre-divided by the stride with integer truncation.
"""

from __future__ import annotations

import numpy as np


def anchor_grid_image_space(
    conv_rows: int, conv_cols: int, anchor_dims: np.ndarray, stride: int
) -> np.ndarray:
    """All anchors in image-pixel coordinates, shape (rows*cols*A, 4) float32.

    Row-major over (row, col, anchor) exactly like rpn_util.py:276-298
    (_get_all_anchor_coords): index = (y * cols + x) * A + a.
    """
    a = len(anchor_dims)
    ys, xs = np.meshgrid(np.arange(conv_rows), np.arange(conv_cols), indexing="ij")
    # int truncation of stride*(i+0.5); exact for even strides (rpn_util.py:168-178)
    x_center = (stride * (xs + 0.5)).astype(np.int64)
    y_center = (stride * (ys + 0.5)).astype(np.int64)

    heights = np.asarray(anchor_dims)[:, 0].astype(np.int64)
    widths = np.asarray(anchor_dims)[:, 1].astype(np.int64)

    x1 = x_center[:, :, None] - widths[None, None, :] // 2
    y1 = y_center[:, :, None] - heights[None, None, :] // 2
    x2 = x1 + widths[None, None, :]
    y2 = y1 + heights[None, None, :]

    coords = np.stack([x1, y1, x2, y2], axis=-1).reshape(conv_rows * conv_cols * a, 4)
    return coords.astype(np.float32)


def anchor_grid_conv_space(
    conv_rows: int, conv_cols: int, anchor_dims: np.ndarray, stride: int
) -> np.ndarray:
    """All anchors in feature-map coordinates, shape (rows*cols*A, 4) float32.

    Matches det_util.py:370-380 (_get_rois) + det_util.py:162-175
    (_get_anchor_coords): dims are ``anchor_dims // stride`` (integer floor),
    centers are the bare grid indices, corners ``center - dim // 2``.  Layout is
    (row, col, anchor) row-major to line up with the RPN head's reshaped
    ``(H, W, 4A)`` regression output.
    """
    dims = np.asarray(anchor_dims) // stride
    a = len(dims)
    ys, xs = np.meshgrid(np.arange(conv_rows), np.arange(conv_cols), indexing="ij")

    heights = dims[:, 0].astype(np.int64)
    widths = dims[:, 1].astype(np.int64)

    x1 = xs[:, :, None] - widths[None, None, :] // 2
    y1 = ys[:, :, None] - heights[None, None, :] // 2
    x2 = x1 + widths[None, None, :]
    y2 = y1 + heights[None, None, :]

    coords = np.stack([x1, y1, x2, y2], axis=-1).reshape(conv_rows * conv_cols * a, 4)
    return coords.astype(np.float32)
