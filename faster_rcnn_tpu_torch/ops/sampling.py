"""Fixed-shape minibatch samplers, batched over images.

Counterpart of faster_rcnn_tpu/ops/sampling.py. Every candidate gets a
uniform random priority; ranking by priority and keeping the first ``k``
ranks is a without-replacement sample of ``k`` from a masked set.

jax.random and torch draw different streams, so the samplers take their
random numbers as tensors: uniform priorities in [0, 1), and for the draw
with replacement two 32-bit words per slot. The train step draws them from a
``torch.Generator``; the tests draw them with jax.random from the JAX step's
own keys and hand both packages the same numbers.
"""

from __future__ import annotations

import torch

from faster_rcnn_tpu_torch.ops import sort_cuda

NEG_INF = -1e30


def _ranks(priority: torch.Tensor) -> torch.Tensor:
    """rank[..., i] = position of element i when sorted by descending
    priority, ties by index (a stable sort of -priority, as ``jnp.argsort``
    is stable)."""
    order = torch.sort(-priority, dim=-1, stable=True).indices
    ar = torch.arange(priority.shape[-1], device=priority.device).expand_as(order)
    return torch.empty_like(order).scatter_(-1, order, ar)


def randint_from_bits(hi: torch.Tensor, lo: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Integers in [0, n) from two 32-bit words per draw (int64 tensors
    holding values in [0, 2^32)): the 64-bit word ``hi * 2^32 + lo`` modulo
    ``n``, which is the reduction ``jax.random.randint`` applies to its two
    words. ``n`` (broadcast against ``hi``) is at least 1 and at most 2^16,
    where the products below stay exact in 32 bits as in JAX."""
    mult = (65536 % n) ** 2 % n  # 2^32 mod n
    return ((hi % n) * mult + lo % n) % n


def random_subset_mask(priority_u: torch.Tensor, mask: torch.Tensor, k,
                       max_k: int | None = None) -> torch.Tensor:
    """Keep at most ``k`` (an int or a (B,) tensor) True entries of each row
    of ``mask`` (B, N): those with the highest priorities ``priority_u``.

    ``max_k``: an upper bound on k. Below the candidate count the selection
    is a top-``max_k`` of the priorities (the top-k kernel) and a scatter,
    as faster_rcnn_tpu's ``lax.top_k`` path; otherwise a full ranking."""
    pri = torch.where(mask, priority_u, torch.full_like(priority_u, NEG_INF))
    k = torch.as_tensor(k, device=mask.device).reshape(-1, 1)
    if max_k is not None and max_k < mask.shape[-1]:
        vals, idx = sort_cuda.topk_sorted(pri.contiguous(), max_k)
        slot = torch.arange(max_k, device=mask.device)
        keep_slot = (slot < k) & (vals > NEG_INF / 2)
        return torch.zeros_like(mask).scatter_(-1, idx, keep_slot)
    return mask & (_ranks(pri) < k)


def subsample_rpn_anchors(u_pos: torch.Tensor, u_neg: torch.Tensor, is_pos: torch.Tensor,
                          can_use: torch.Tensor, sample_size: int = 256,
                          max_pos: int = 128) -> torch.Tensor:
    """rpn_util.py:324-350 (_apply_sampling): cap the positives at
    ``max_pos``, then the negatives so pos + neg <= ``sample_size``. (B, N)
    masks and priorities in, the sampled ``can_use`` mask out."""
    pos_mask = is_pos & can_use
    neg_mask = (~is_pos) & can_use
    kept_pos = random_subset_mask(u_pos, pos_mask, max_pos, max_k=max_pos)
    num_pos = kept_pos.sum(-1)
    kept_neg = random_subset_mask(u_neg, neg_mask, sample_size - num_pos, max_k=sample_size)
    return kept_pos | kept_neg


def sample_det_rois(u_pos: torch.Tensor, u_neg: torch.Tensor, bits_hi: torch.Tensor,
                    bits_lo: torch.Tensor, eligible: torch.Tensor, is_pos: torch.Tensor,
                    num_rois: int = 64, pos_fraction: float = 0.25):
    """Fast R-CNN ROI minibatch sampling (det_util.py:260-306), batched.

    Up to ``num_rois * pos_fraction`` positives, all of them if fewer; the
    rest negatives, with replacement when there are too few distinct ones
    (det_util.py:293); positives tiled into the negative slots when there
    are no negatives (det_util.py:297-299).

    Args:
      u_pos, u_neg: (B, K) uniform priorities of the positives, negatives.
      bits_hi, bits_lo: (B, num_rois) 32-bit words of the draw with
        replacement (:func:`randint_from_bits`).
      eligible: (B, K) bool, ROI passed the >= min_iou filter and is real.
      is_pos: (B, K) bool, ROI IoU >= pos_iou.

    Returns:
      (indices (B, num_rois) int64 into the K ROIs, any_valid (B,) bool).
    """
    desired_pos = int(num_rois * pos_fraction)
    pos_mask = eligible & is_pos
    neg_mask = eligible & (~is_pos)
    n_pos = pos_mask.sum(-1, keepdim=True)
    n_neg = neg_mask.sum(-1, keepdim=True)

    # pool[j] = the candidate of rank j, the inverse of the rank permutation
    neg_inf = torch.full_like(u_pos, NEG_INF)
    pool_pos = torch.sort(-torch.where(pos_mask, u_pos, neg_inf), dim=-1, stable=True).indices
    pool_neg = torch.sort(-torch.where(neg_mask, u_neg, neg_inf), dim=-1, stable=True).indices

    take_pos = torch.clamp_max(n_pos, desired_pos)
    desired_neg = num_rois - take_pos
    slots = torch.arange(num_rois, device=eligible.device)[None, :]
    neg_slot = slots - take_pos

    safe_neg = torch.clamp_min(n_neg, 1)
    safe_pos = torch.clamp_min(n_pos, 1)
    rand_draw = randint_from_bits(bits_hi, bits_lo, safe_neg)
    neg_choice = torch.where(n_neg >= desired_neg, neg_slot, rand_draw)
    neg_idx = torch.gather(pool_neg, -1, neg_choice % safe_neg)
    tiled_pos = torch.gather(pool_pos, -1, neg_slot % safe_pos)
    neg_idx = torch.where(n_neg > 0, neg_idx, tiled_pos)
    pos_idx = torch.gather(pool_pos, -1, slots.expand_as(neg_slot) % safe_pos)
    indices = torch.where(slots < take_pos, pos_idx, neg_idx)
    return indices, (n_pos + n_neg)[:, 0] > 0
