"""Wrapper of the NMS keep-mask kernel (csrc/nms.cu).

Replaces faster_rcnn_tpu/ops/nms_pallas.py ``nms_keep_mask_pallas`` (and the
XLA loop ``_blocked_keep_mask`` it equals). One launch computes the keep
masks of a whole batch, one thread-block cluster of :func:`cluster_size`
blocks per image.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch

from faster_rcnn_tpu_torch import _build
from faster_rcnn_tpu_torch.ops.nms import nms_sorted_mask_blocked

SMEM_LIMIT = 232448  # bytes of shared memory one H100 block may use
MAX_CLUSTER = 8      # blocks of the largest portable thread-block cluster


def cluster_size(b: int, tile: int, active: Callable[[int], int]) -> int:
    """Blocks of the cluster that takes one of ``b`` images: the largest
    size up to MAX_CLUSTER whose ``b`` clusters the card runs in one wave
    (``active(c)``: the clusters of ``c`` blocks it holds at once), 1 if
    none does; and at most tile // 32, the words of candidates a tile
    holds: a small tile's work is not worth a larger cluster's barriers."""
    for c in range(min(MAX_CLUSTER, tile // 32), 1, -1):
        if active(c) >= b:
            return c
    return 1


@functools.lru_cache(maxsize=None)
def max_active_clusters(device: torch.device, n: int, tile: int, enough: int, c: int) -> int:
    """Clusters of ``c`` blocks that CUDA ``device`` runs at once at these
    shapes (cudaOccupancyMaxActiveClusters); 0 if a block's shared memory
    would pass SMEM_LIMIT."""
    if _build.query("frcnn_nms_smem_bytes", device, n, tile, enough, c) + 16 > SMEM_LIMIT:
        return 0
    active = _build.query("frcnn_nms_max_active_clusters", device, n, tile, enough, c)
    if active < 0:
        _build.check(-active, "cudaOccupancyMaxActiveClusters")
    return active


@functools.lru_cache(maxsize=None)
def _config(device: torch.device, b: int, n: int, tile: int, enough: int) -> tuple:
    """(cluster size, shared memory bytes per block) of a launch."""
    c = cluster_size(b, tile, lambda c: max_active_clusters(device, n, tile, enough, c))
    return c, _build.query("frcnn_nms_smem_bytes", device, n, tile, enough, c)


def launch_shape(boxes: torch.Tensor, tile: int, enough: int) -> dict:
    """The cluster size, the shared memory per block and the clusters that
    fit on the card at once for a CUDA ``boxes`` of (B, N, 4), with the
    waves of clusters that follow."""
    b, n = boxes.shape[:2]
    c, smem = _config(boxes.device, b, n, tile, enough)
    active = max_active_clusters(boxes.device, n, tile, enough, c)
    return {"cluster": c, "smem_bytes": smem, "max_active_clusters": active,
            "waves": -(-b // active) if active else None}


def nms_keep_mask(boxes: torch.Tensor, valid: torch.Tensor, iou_thresh: float,
                  tile: int = 256, enough: int = 0) -> torch.Tensor:
    """(B, N, 4) f32 score-sorted boxes, (B, N) bool valid -> (B, N) bool
    keep, equal to :func:`ops.nms.nms_sorted_mask_blocked`. N must be a
    multiple of ``tile``. A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel."""
    if boxes.dim() != 3 or boxes.shape[-1] != 4 or valid.shape != boxes.shape[:2]:
        raise ValueError(f"want boxes (B, N, 4) and valid (B, N), got "
                         f"{tuple(boxes.shape)} and {tuple(valid.shape)}")
    b, n = valid.shape
    if n % tile != 0:
        raise ValueError(f"n={n} must be a multiple of tile={tile}")
    if boxes.device.type == "cpu":
        return nms_sorted_mask_blocked(boxes, valid, iou_thresh, tile=tile, enough=enough)
    if boxes.device.type != "cuda" or valid.device != boxes.device:
        raise ValueError(f"nms_keep_mask: unsupported devices {boxes.device}, {valid.device}")
    if boxes.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError(f"nms_keep_mask wants float32 boxes and bool valid, got "
                        f"{boxes.dtype}, {valid.dtype}")
    if not (boxes.is_contiguous() and valid.is_contiguous()) or boxes.data_ptr() % 16:
        raise ValueError("nms_keep_mask wants contiguous tensors, boxes 16-byte aligned")
    if tile % 32 != 0 or not 32 <= tile <= 1024:
        raise ValueError(f"nms_keep_mask: tile={tile} must be a multiple of 32 in [32, 1024]")
    keep = torch.empty((b, n), dtype=torch.bool, device=boxes.device)
    if b == 0:
        return keep
    c, smem = _config(boxes.device, b, n, tile, enough)
    if smem + 16 > SMEM_LIMIT:
        raise ValueError(f"nms_keep_mask: n={n}, tile={tile}, enough={enough} need {smem} "
                         f"bytes of shared memory per block of {c}, more than a block has")
    _build.launch("nms", "frcnn_nms_keep_mask", boxes, boxes.data_ptr(), valid.data_ptr(),
                  keep.data_ptr(), b, n, tile, float(iou_thresh), int(enough), c)
    return keep
