"""Where RoI align's taps land, counted on the host with numpy: which map
rows and columns each ROI's cells weigh, the tap rows the K1 forward loads
(csrc/roi_align.cu, ``roi_align_kernel``), the hits the K1 backward's blocks
find on each map row (``roi_align_bwd_kernel``), and the entries it sums
into each pixel. The measurement scripts report these counts beside the
kernels' times; nothing on the paths calls them.
"""

from __future__ import annotations

import numpy as np
import torch

BWD_WARPS, BWD_HEAVY = 8, 64  # the backward kernel's split rule (csrc/roi_align.cu)


def row_taps(starts, crops, p: int, limit: int) -> tuple:
    """(lo, hi), each (B, R, P): the map row (or column) of each cell's two
    taps, by the kernels' tap arithmetic in f32."""
    src = np.arange(p, dtype=np.float32) * (crops[..., None] / np.float32(p))
    lo = np.floor(src)
    lo_abs = np.clip(lo + starts[..., None], 0, limit - 1).astype(np.int64)
    hi_abs = np.clip(np.minimum(lo + 1, crops[..., None] - 1) + starts[..., None], 0,
                     limit - 1).astype(np.int64)
    return lo_abs, hi_abs


def forward_loads(rois: torch.Tensor, h: int, p: int) -> float:
    """The K1 forward's new tap-row pixels per output vector on these ROIs,
    4 at most: a thread runs its column's cell rows in order and takes a
    cell's lo tap row (two pixels) anew unless it is the row before's lo or
    hi, and its hi tap row unless it is its own lo or the row before's hi.
    The f32 kernel loads these; the bf16 kernel loads all 4 and computes
    the horizontal lerps of these."""
    lo, hi = row_taps(*roi_axes(rois)[0], p, h)
    prev_lo = np.concatenate([np.full(lo.shape[:2] + (1,), -1), lo[..., :-1]], -1)
    prev_hi = np.concatenate([np.full(hi.shape[:2] + (1,), -1), hi[..., :-1]], -1)
    top_new = (lo != prev_lo) & (lo != prev_hi)
    bot_new = (hi != lo) & (hi != prev_hi)
    return float(2 * (top_new.mean() + bot_new.mean()))


def tap_counts(starts, crops, p: int, limit: int, merged: bool = True) -> np.ndarray:
    """(B, R, limit): how many of each ROI's P cells put a tap of nonzero
    weight on each map row (or column), by the kernels' tap arithmetic in
    f32: the lower tap always, the upper where its fraction is above zero;
    with ``merged``, an upper tap on the lower tap's index counts once with
    it, as the K1 backward takes the two."""
    src = np.arange(p, dtype=np.float32) * (crops[..., None] / np.float32(p))
    lo = np.floor(src)
    lo_abs, hi_abs = row_taps(starts, crops, p, limit)
    upper = (src > lo) & ((hi_abs != lo_abs) | (not merged))
    out = np.zeros(lo.shape[:2] + (limit,), np.int64)
    bi, ri = np.indices(lo.shape[:2])
    for c in range(p):
        np.add.at(out, (bi, ri, lo_abs[..., c]), 1)
        np.add.at(out, (bi[upper[..., c]], ri[upper[..., c]], hi_abs[..., c][upper[..., c]]), 1)
    return out


def roi_axes(rois: torch.Tensor):
    """((y1, crop_h), (x1, crop_w)) of (B, R, 4) ROIs, as f32 numpy."""
    r = rois.detach().cpu().numpy().astype(np.float32)
    return (r[..., 1], r[..., 3] - r[..., 1]), (r[..., 0], r[..., 2] - r[..., 0])


def row_hits(rois: torch.Tensor, h: int, p: int) -> np.ndarray:
    """(B, H) hits of the K1 backward on each map row: the (r, i) with a
    row tap of nonzero weight there, which the blocks of the row take in
    turn."""
    return tap_counts(*roi_axes(rois)[0], p, h).sum(1)


def entries_per_column(rois: torch.Tensor, h: int, w: int, p: int) -> dict:
    """The entries (cotangent row, weight) that the K1 backward sums into
    each map pixel, as it takes them (coincident taps merged) and as they
    would be with every tap apart: totals, the largest row and column, and
    the columns it splits over its warps (more than BWD_HEAVY entries and
    more than 1/BWD_WARPS of their row's; the kernel decides this per batch
    of ROIs, so the count is its own where all of an image's ROIs fit one
    batch, as the train step's 64 do)."""
    rows, cols = roi_axes(rois)
    out = {}
    for merged in (True, False):
        ent = np.einsum("bry,brx->byx", tap_counts(*rows, p, h, merged),
                        tap_counts(*cols, p, w, merged))
        row_total = ent.sum(2, keepdims=True)
        out["merged" if merged else "apart"] = {
            "total": int(ent.sum()), "max_column": int(ent.max()),
            "max_row": int(row_total.max()),
            "split_columns": int(((ent > BWD_HEAVY) & (ent * BWD_WARPS > row_total)).sum())}
    return out
