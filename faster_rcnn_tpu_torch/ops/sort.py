"""Score-descending top-k with ascending-index ties, plain PyTorch.

Counterpart of faster_rcnn_tpu/ops/sort_pallas.py ``topk_sorted_pallas``,
the drop-in for ``jax.lax.top_k`` on f32 scores. :func:`topk_sorted_plain`
is the plain version of the kernel behind
:func:`faster_rcnn_tpu_torch.ops.sort_cuda.topk_sorted`.

The order is ``lax.top_k``'s: descending in the IEEE total order (+NaN
first, +0.0 above -0.0, a NaN with its sign bit set last), ties by ascending
index. A stable ``torch.sort`` of the float scores is not one function
across devices: on the CPU, and on a card for rows short enough for its
in-place sort, it ties -0.0 with +0.0 and puts every NaN first; on a card's
long rows (its radix sort) it follows the total order. So the plain version
sorts int32 keys in that order, which every device sorts alike, and gathers
the values, which keep the input's bits.
"""

from __future__ import annotations

import torch


def topk_sorted_plain(scores: torch.Tensor, k: int):
    """(B, N) scores -> (values (B, k), indices (B, k) int64), descending in
    the IEEE total order, ties by ascending index."""
    bits = scores.float().contiguous().view(torch.int32)
    key = bits ^ ((bits >> 31) & 0x7FFFFFFF)  # ascends as the total order does
    idx = torch.sort(key, dim=-1, descending=True, stable=True)[1][..., :k]
    return scores.gather(-1, idx), idx
