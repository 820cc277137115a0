"""Parameter freezing and the freeze-aware optimizer.

Counterpart of faster_rcnn_tpu/parallel/freeze.py, which builds an optax
chain: weight decay ``2*wd*p`` added to the trainable, non-norm gradients,
then (per the ``"train"`` route only) a global-norm clip and SGD with
momentum or Adam, while the ``"frozen"`` route gets zero updates.
:class:`FreezeAwareOptimizer` performs those updates on PyTorch parameters
in the same order and the same f32 arithmetic. ``torch.optim.SGD`` cannot:
its weight decay comes after a ``clip_grad_norm_``, and the clip would see
frozen gradients.

Frozen sets (reference semantics): the backbone stages in
``freeze_blocks`` (1-based; conv1 is stage 1), every batch-norm and channel
scale parameter, and optionally whole top-level modules (``freeze_modules``,
e.g. ``"backbone"``). Frozen parameters are set ``requires_grad=False``, so
autograd computes no gradient for them, and they are never updated.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import numpy as np
import torch
from torch import nn

from faster_rcnn_tpu_torch.models.resnet import is_norm_param, resnet_param_block


def param_labels(model: nn.Module, network: str, freeze_blocks: Sequence[int],
                 freeze_modules: Sequence[str] = ()) -> Dict[str, str]:
    """``{parameter name: "train" or "frozen"}`` by name, as the JAX package
    labels the same Keras-named leaves."""
    if network not in ("resnet50", "resnet101"):
        raise ValueError(f"only the ResNet freeze rules are ported, not {network}")

    def label(name: str) -> str:
        path = name.split(".")
        if path[0] in freeze_modules or is_norm_param(path):
            return "frozen"
        blk = resnet_param_block(path)
        return "frozen" if blk is not None and blk in freeze_blocks else "train"

    return {name: label(name) for name, _ in model.named_parameters()}


def frozen_prefix_stage(network: str, freeze_blocks: Sequence[int],
                        freeze_modules: Sequence[str] = ()) -> int:
    """Largest k such that backbone stages 1..k are all frozen (0 if conv1
    trains). The backbone runs stages <= k without autograd: no trainable
    parameter lies below that boundary (norm parameters are always frozen),
    so the update is the same and the frozen prefix costs no backward."""
    last = 5 if network == "vgg16" else 4
    if "backbone" in freeze_modules:
        return last
    k = 0
    for b in range(1, last + 1):
        if b not in set(freeze_blocks):
            break
        k = b
    return k


def decay_mask(model: nn.Module) -> Dict[str, bool]:
    """True for convolution and dense weights and biases; False for the
    batch-norm and channel-scale parameters."""
    return {name: not is_norm_param(name.split(".")) for name, _ in model.named_parameters()}


class FreezeAwareOptimizer:
    """The update of faster_rcnn_tpu's ``make_optimizer`` (freeze.py:101-141).

    ``step()`` reads each trainable parameter's ``.grad`` (zeros where
    autograd left none) and, in this order: adds ``2*weight_decay*p`` to the
    non-norm gradients; clips them to ``clip_grad_norm`` by their global
    norm, over the trainable parameters only; takes the SGD-with-momentum
    (``trace = g + momentum*trace``, ``p += -lr*trace``; the trace starts at
    zero, so the first step is ``trace = g``, as torch's SGD buffer starts)
    or Adam (b1 0.9, b2 0.999, eps 1e-8, bias-corrected) step. ``lr`` is a
    number or a function of the step count, which starts at 0. Frozen
    parameters get no update and no optimizer state.
    """

    def __init__(self, model: nn.Module, network: str, freeze_blocks: Sequence[int],
                 learning_rate: Callable[[int], float] | float, optimizer: str = "sgd",
                 momentum: float = 0.9, weight_decay: float = 0.0,
                 freeze_modules: Sequence[str] = (), clip_grad_norm: float = 0.0):
        if optimizer not in ("sgd", "adam"):
            raise ValueError(f"unknown optimizer {optimizer}")
        self.labels = param_labels(model, network, freeze_blocks, freeze_modules)
        decay = decay_mask(model)
        self.params = []       # (name, parameter, decays) of the trainable ones
        for name, p in model.named_parameters():
            train = self.labels[name] == "train"
            p.requires_grad_(train)
            if train:
                self.params.append((name, p, decay[name]))
        self.lr = learning_rate if callable(learning_rate) else (lambda _: learning_rate)
        self.kind, self.momentum = optimizer, momentum
        self.weight_decay, self.clip = weight_decay, clip_grad_norm
        self.count = 0
        self.state: Dict[str, Dict[str, torch.Tensor]] = {
            name: ({"trace": torch.zeros_like(p)} if optimizer == "sgd"
                   else {"mu": torch.zeros_like(p), "nu": torch.zeros_like(p)})
            for name, p, _ in self.params}

    def zero_grad(self) -> None:
        for _, p, _ in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for _, p, _ in self.params]
        if self.weight_decay:
            wd = 2.0 * self.weight_decay
            grads = [g + wd * p if d else g for g, (_, p, d) in zip(grads, self.params)]
        if self.clip:
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            keep = norm < self.clip
            grads = [torch.where(keep, g, g / norm * self.clip) for g in grads]
        step_size = -float(self.lr(self.count))
        for g, (name, p, _) in zip(grads, self.params):
            st = self.state[name]
            if self.kind == "sgd":
                st["trace"] = g + self.momentum * st["trace"]
                upd = st["trace"] * step_size
            else:
                upd = self._adam(g, st) * step_size
            p.add_(upd)
        self.count += 1

    def _adam(self, g: torch.Tensor, st: Dict[str, torch.Tensor],
              b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> torch.Tensor:
        st["mu"] = (1 - b1) * g + b1 * st["mu"]
        st["nu"] = (1 - b2) * (g * g) + b2 * st["nu"]
        t = self.count + 1
        # the bias corrections in f32, as optax computes them
        c1 = float(np.float32(1) - np.float32(b1) ** t)
        c2 = float(np.float32(1) - np.float32(b2) ** t)
        return (st["mu"] / c1) / (torch.sqrt(st["nu"] / c2) + eps)


# faster_rcnn_tpu's name for it: SGD (momentum 0.9) or Adam with freezing, l2
# and optional global-norm clipping (args_util.py:48-59)
make_optimizer = FreezeAwareOptimizer
