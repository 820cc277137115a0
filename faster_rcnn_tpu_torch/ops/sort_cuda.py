"""Wrapper of the top-k kernel (csrc/topk.cu).

Replaces faster_rcnn_tpu/ops/sort_pallas.py ``topk_sorted_pallas`` (the
bitonic kernel, a bit-identical drop-in for ``lax.top_k``). It takes every
top-k of the port: the proposal prescore truncation and the RPN anchor
sampler. One launch handles a whole batch, one block per row.
"""

from __future__ import annotations

import torch

from faster_rcnn_tpu_torch import _build
from faster_rcnn_tpu_torch.ops.sort import topk_sorted_plain

MAX_SORTED = 16384  # pairs the kernel's shared-memory bitonic sort holds


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def topk_sorted(scores: torch.Tensor, k: int):
    """(B, N) f32 scores -> (values (B, k) f32, indices (B, k) int64),
    descending by value, ties by ascending index, bit for bit
    :func:`ops.sort.topk_sorted_plain`. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel."""
    if scores.dim() != 2 or not 0 <= k <= scores.shape[1]:
        raise ValueError(f"want scores (B, N) and 0 <= k <= N, got {tuple(scores.shape)}, k={k}")
    if scores.device.type == "cpu":
        return topk_sorted_plain(scores, k)
    if scores.device.type != "cuda":
        raise ValueError(f"topk_sorted: unsupported device {scores.device}")
    if scores.dtype != torch.float32:
        raise TypeError(f"topk_sorted wants float32 scores, got {scores.dtype}")
    if not scores.is_contiguous():
        raise ValueError("topk_sorted wants contiguous scores")
    b, n = scores.shape
    pad = _next_pow2(k)
    if pad > MAX_SORTED or n >= 2 ** 31:
        raise ValueError(f"topk_sorted: k={k} over {MAX_SORTED} or n={n} too large")
    vals = torch.empty((b, k), dtype=torch.float32, device=scores.device)
    idx = torch.empty((b, k), dtype=torch.int64, device=scores.device)
    if b == 0 or k == 0:
        return vals, idx
    err = _build.lib().frcnn_topk_f32(scores.data_ptr(), vals.data_ptr(), idx.data_ptr(),
                                      b, n, k, pad, _build.stream_ptr(scores))
    _build.check(err, "topk")
    _build.count_launch("topk")
    return vals, idx
