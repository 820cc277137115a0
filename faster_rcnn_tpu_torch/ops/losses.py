"""Masked detection losses, one value per image.

Counterpart of faster_rcnn_tpu/ops/losses.py (loss_functions.py:15-77), with
a leading batch axis: each loss reduces the per-image axes and returns (B,).
The normalizers are the reference's: N_CLS=256, N_REG=2400, LAMBDA_REG=10,
and the detector regression's elementwise ``1e-4 + mask`` denominator. The
RPN regression masks inside the sum, the fix the JAX package documents.
"""

from __future__ import annotations

import torch


def smooth_l1(x: torch.Tensor) -> torch.Tensor:
    """Huber / smooth-L1 with its transition at |x| = 1."""
    ax = torch.abs(x)
    return torch.where(ax <= 1.0, 0.5 * ax * ax, ax - 0.5)


def rpn_cls_loss(logits: torch.Tensor, target_pos: torch.Tensor, mask: torch.Tensor,
                 n_cls: float = 256.0) -> torch.Tensor:
    """sum(mask * BCE(is_pos, sigmoid(logit))) / N_CLS over (B, N) -> (B,),
    from logits in the stable form max(x, 0) - x*t + log1p(exp(-|x|))."""
    logits = logits.float()
    t = target_pos.float()
    bce = torch.clamp_min(logits, 0.0) - logits * t + torch.log1p(torch.exp(-torch.abs(logits)))
    return torch.sum(mask.float() * bce, dim=-1) / n_cls


def rpn_reg_loss(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor,
                 n_reg: float = 2400.0, lambda_reg: float = 10.0) -> torch.Tensor:
    """lambda * sum(mask * smoothL1(target - pred)) / N_REG over (B, N, 4)
    with a (B, N) mask -> (B,)."""
    d = target.float() - pred.float()
    return lambda_reg * torch.sum(mask.float()[..., None] * smooth_l1(d), dim=(-2, -1)) / n_reg


def det_cls_loss(logits: torch.Tensor, cls_target: torch.Tensor) -> torch.Tensor:
    """Mean categorical cross-entropy over the ROI minibatch: logits (B, R,
    C), class ids (B, R) -> (B,)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, cls_target.long()[..., None])[..., 0]
    return nll.mean(dim=-1)


def det_reg_loss(pred: torch.Tensor, reg_target: torch.Tensor, cls_target: torch.Tensor,
                 is_pos: torch.Tensor, num_classes: int,
                 lambda_reg_det: float = 1.0) -> torch.Tensor:
    """Per-class smooth-L1 over the positive ROIs (loss_functions.py:51-67).

    ``pred`` (B, R, 4(C-1)) holds class-major 4-slices; the slice of each
    ROI's class is gathered, which is the sum of the reference's one-hot
    expansion. The denominator is sum(1e-4 + mask) over the (R, 4(C-1))
    mask matrix: 4 n_pos + 1e-4 R 4 (C-1). Returns (B,).
    """
    r = pred.shape[-2]
    c_fg = num_classes - 1
    base = torch.clamp_max(cls_target.long(), c_fg - 1) * 4
    cols = base[..., None] + torch.arange(4, device=pred.device)
    pred_slice = torch.gather(pred.float(), -1, cols)
    m = is_pos.float()[..., None]
    num = torch.sum(m * smooth_l1(reg_target.float() - pred_slice), dim=(-2, -1))
    denom = 4.0 * torch.sum(m, dim=(-2, -1)) + 1e-4 * r * 4 * c_fg
    return lambda_reg_det * num / denom
