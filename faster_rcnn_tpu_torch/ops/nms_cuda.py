"""Wrapper of the NMS keep-mask kernel (csrc/nms.cu).

Replaces faster_rcnn_tpu/ops/nms_pallas.py ``nms_keep_mask_pallas`` (and the
XLA loop ``_blocked_keep_mask`` it equals). One launch computes the keep
masks of a whole batch, one block per image.
"""

from __future__ import annotations

import torch

from faster_rcnn_tpu_torch import _build
from faster_rcnn_tpu_torch.ops.nms import nms_sorted_mask_blocked

SMEM_LIMIT = 232448  # bytes of shared memory one H100 block may use


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
    if not (boxes.is_contiguous() and valid.is_contiguous()):
        raise ValueError("nms_keep_mask wants contiguous tensors")
    if tile % 32 != 0 or not 32 <= tile <= 1024 or n > 65536:
        raise ValueError(f"nms_keep_mask: tile={tile} must be a multiple of 32 in "
                         f"[32, 1024] and n={n} at most 65536")
    lib = _build.lib()
    smem = lib.frcnn_nms_smem_bytes(n, tile)
    if smem + 16 > SMEM_LIMIT:
        raise ValueError(f"nms_keep_mask: n={n}, tile={tile} need {smem} bytes of "
                         f"shared memory, more than a block has")
    keep = torch.empty((b, n), dtype=torch.bool, device=boxes.device)
    if b == 0:
        return keep
    err = lib.frcnn_nms_keep_mask(boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(),
                                  b, n, tile, float(iou_thresh), int(enough),
                                  _build.stream_ptr(boxes))
    _build.check(err, "nms")
    _build.count_launch("nms")
    return keep
