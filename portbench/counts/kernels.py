"""Each hand-written kernel's least time on the H100, from the bytes and
operations one call needs: the larger of bytes over HBM bandwidth and
operations over the peak of the unit it runs on. Each input byte is read
once and each output byte written once. Where the work depends on the data
(the map pixels RoI align touches, the IoU pairs NMS evaluates), the count
is of what these inputs need."""

from __future__ import annotations

import numpy as np

from portbench.counts.peaks import BF16_FLOPS, F32_FLOPS, HBM_BYTES_PER_S

IOU_OPS = 25      # f32 operations of one +1-convention IoU and its compare
LERP_OPS = 9      # f32 operations of one bilinear output value
SCATTER_OPS = 10  # f32 operations of one cotangent value's four taps
STEM_TAPS = 7 * 7 * 3


def bound_s(nbytes: float, ops: float, peak: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / peak)


def _row_taps(starts, crops, p: int, limit: int):
    src = np.arange(p, dtype=np.float32) * (crops[..., None] / np.float32(p))
    lo = np.floor(src)
    lo_abs = np.clip(lo + starts[..., None], 0, limit - 1).astype(np.int64)
    hi_abs = np.clip(np.minimum(lo + 1, crops[..., None] - 1) + starts[..., None], 0,
                     limit - 1).astype(np.int64)
    return src, lo, lo_abs, hi_abs


def _touched(starts, crops, p: int, limit: int) -> np.ndarray:
    """(B, R, limit) bool: the map rows (or columns) each ROI's cells put a
    tap of nonzero weight on (the lower tap always, the upper where its
    fraction is above zero)."""
    src, lo, lo_abs, hi_abs = _row_taps(starts, crops, p, limit)
    upper = src > lo
    out = np.zeros(lo.shape[:2] + (limit,), bool)
    bi, ri = np.indices(lo.shape[:2])
    for c in range(p):
        out[bi, ri, lo_abs[..., c]] = True
        m = upper[..., c]
        out[bi[m], ri[m], hi_abs[..., c][m]] = True
    return out


def touched_pixels(rois: np.ndarray, h: int, w: int, p: int) -> int:
    """Map pixels that RoI align must read for (B, R, 4) feature-map ROIs:
    the union over each image's ROIs."""
    r = rois.astype(np.float32)
    rows = _touched(r[..., 1], r[..., 3] - r[..., 1], p, h)
    cols = _touched(r[..., 0], r[..., 2] - r[..., 0], p, w)
    hit = np.einsum("bry,brx->byx", rows, cols, dtype=np.int64)
    return int((hit > 0).sum())


def roi_align_fwd(map_shape, rois: np.ndarray, p: int, elem: int) -> float:
    """K1 forward: the touched map pixels and the (B, R, P, P, C) output at
    the map's element size, the ROIs in f32; 9 f32 operations a value."""
    b, h, w, c = map_shape
    out = rois.shape[0] * rois.shape[1] * p * p * c
    nbytes = (touched_pixels(rois, h, w, p) * c + out) * elem + rois.size * 4
    return bound_s(nbytes, LERP_OPS * out, F32_FLOPS)


def roi_align_bwd(grad_numel: int, map_numel: int, rois_numel: int, elem: int) -> float:
    """K1 backward: the cotangent read, the map's gradient written; 10 f32
    operations a cotangent value."""
    nbytes = (grad_numel + map_numel) * elem + rois_numel * 4
    return bound_s(nbytes, SCATTER_OPS * grad_numel, F32_FLOPS)


def stem_conv(x_numel: int, out_numel: int, elem: int = 2) -> float:
    """K2: the 7x7/2 stem, 3 -> 64 channels, on the tensor cores."""
    nbytes = (x_numel + STEM_TAPS * 64 + out_numel) * elem
    return bound_s(nbytes, 2.0 * out_numel * STEM_TAPS, BF16_FLOPS)


def nms_pairs(keep: np.ndarray, valid: np.ndarray, tile: int, enough: int) -> int:
    """IoU pairs the blocked greedy NMS evaluates on these inputs: per tile
    phase, the tile against every earlier survivor plus its own upper
    triangle, until ``enough`` survivors exist."""
    pairs = 0
    for k, v in zip(keep, valid):
        kept = 0
        for off in range(0, k.shape[0], tile):
            if enough > 0 and kept >= enough:
                break
            pairs += tile * kept + tile * (tile - 1) // 2
            kept += int((k[off:off + tile] & v[off:off + tile]).sum())
    return pairs


def nms(boxes_shape, keep: np.ndarray, valid: np.ndarray, tile: int, enough: int) -> float:
    """K3: the boxes and flags read, the keep mask written; 25 f32
    operations an IoU pair."""
    b, n = boxes_shape[:2]
    nbytes = b * n * 4 * 4 + 2 * b * n
    return bound_s(nbytes, IOU_OPS * nms_pairs(keep, valid, tile, enough), F32_FLOPS)


def topk(b: int, n: int, k: int) -> float:
    """K4: the (B, N) f32 rows read, k values and int64 indices written."""
    return bound_s(b * n * 4 + b * k * 12, b * n, F32_FLOPS)
