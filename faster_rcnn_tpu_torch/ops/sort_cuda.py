"""Wrapper of the top-k kernel (csrc/topk.cu).

Replaces faster_rcnn_tpu/ops/sort_pallas.py ``topk_sorted_pallas`` (the
bitonic kernel, a bit-identical drop-in for ``lax.top_k``). It takes every
top-k of the port: the proposal prescore truncation and the RPN anchor
sampler. One call handles a whole batch: each row is cut into
:func:`slices_per_row` slices, one block per slice and row in every pass.
"""

from __future__ import annotations

import functools

import torch

from faster_rcnn_tpu_torch import _build
from faster_rcnn_tpu_torch.ops.sort import topk_sorted_plain

MAX_SORTED = 16384  # pairs of one row the kernel's merge holds in shared memory
MIN_SLICE = 1024    # keys a slice holds at least


def slices_per_row(b: int, n: int, sms: int) -> int:
    """Slices each of ``b`` rows of ``n`` scores is cut into: enough for the
    b * slices blocks of a pass to reach twice the card's ``sms`` SMs, and
    none shorter than MIN_SLICE keys."""
    return max(1, min(-(-2 * sms // b), n // MIN_SLICE))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    if k > MAX_SORTED or n >= 2 ** 31:
        raise ValueError(f"topk_sorted: k={k} over {MAX_SORTED} or n={n} too large")
    vals = torch.empty((b, k), dtype=torch.float32, device=scores.device)
    idx = torch.empty((b, k), dtype=torch.int64, device=scores.device)
    if b == 0 or k == 0:
        return vals, idx
    s = slices_per_row(b, n, _sm_count(scores.device.index))
    # Scratch of the launches below; freed on return, the caching allocator
    # hands it only to work queued after them on this stream.
    work = torch.empty(_build.query("frcnn_topk_work_bytes", scores.device, b, s, k),
                       dtype=torch.uint8, device=scores.device)
    _build.launch("topk", "frcnn_topk_f32", scores, scores.data_ptr(), vals.data_ptr(),
                  idx.data_ptr(), work.data_ptr(), b, n, k, s)
    return vals, idx
