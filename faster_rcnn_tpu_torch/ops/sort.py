"""Score-descending top-k with ascending-index ties, plain PyTorch.

Counterpart of faster_rcnn_tpu/ops/sort_pallas.py ``topk_sorted_pallas``,
the drop-in for ``jax.lax.top_k`` on f32 scores. :func:`topk_sorted_plain`
is the plain version of the kernel behind
:func:`faster_rcnn_tpu_torch.ops.sort_cuda.topk_sorted`: a stable
descending ``torch.sort``, so ties keep ascending index as ``lax.top_k``
does (``torch.topk`` does not promise that order).
"""

from __future__ import annotations

import torch


def topk_sorted_plain(scores: torch.Tensor, k: int):
    """(B, N) scores -> (values (B, k), indices (B, k) int64), descending by
    value, ties by ascending index."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]
