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

Over a process mesh (parallel/mesh.py) the optimizer also does what XLA
inserts in the JAX package's sharded step: it averages the trainable
gradients over the mesh's data column, and its clip sees the norm of the
whole logical parameters, VGG16's split fc head included
(parallel/sharding.py).
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from faster_rcnn_tpu_torch.models.resnet import is_norm_param, resnet_param_block
from faster_rcnn_tpu_torch.models.vgg import vgg_param_block
from faster_rcnn_tpu_torch.parallel.sharding import split_dim


def param_labels(model: nn.Module, network: str, freeze_blocks: Sequence[int],
                 freeze_modules: Sequence[str] = ()) -> Dict[str, str]:
    """``{parameter name: "train" or "frozen"}`` by name, as the JAX package
    labels the same Keras-named leaves."""
    block_of = vgg_param_block if network == "vgg16" else resnet_param_block

    def label(name: str) -> str:
        path = name.split(".")
        if path[0] in freeze_modules or is_norm_param(path):
            return "frozen"
        blk = block_of(path)
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
    parameters get no update and no optimizer state. The state is created
    at the first ``step()``, on each parameter's device then, so the model
    may move (``make_joint_train_step`` moves it) after the optimizer is
    built, as with ``torch.optim``.

    ``state_dict()`` is ``{"kind", "count", "state"}``: the optimizer
    ("sgd" or "adam"), the step count (which the learning-rate schedule
    reads, as optax's schedules read its count, so a resumed run goes on
    with the schedule) and, per trainable parameter's name, its ``trace``
    (SGD) or ``mu`` and ``nu`` (Adam). The tensors are the live state, not
    copies. ``load_state_dict`` takes one back and puts each tensor on its
    parameter's device, at the load and again at each ``step()`` if the
    model has moved since, never on the device the dict came from.

    ``mesh`` (a parallel/mesh.Mesh, or None on one process): ``step()``
    first averages the trainable gradients over the mesh's data column, one
    all-reduce of a flat buffer per dtype; each loss is a batch mean, so the
    mean of equal shards' gradients is the global batch's gradient. The
    clip's sum of squares over the parameters split on the model row
    (``sharding.split_dim``, when the mesh's model size exceeds 1) is summed
    over that row before the square root, so that a split run clips as the
    replicated one does. The step makers of train/pipeline.py make a step
    data-parallel by this alone: it averages the gradients, and they reduce
    their metrics over ``optimizer.mesh``.
    """

    def __init__(self, model: nn.Module, network: str, freeze_blocks: Sequence[int],
                 learning_rate: Callable[[int], float] | float, optimizer: str = "sgd",
                 momentum: float = 0.9, weight_decay: float = 0.0,
                 freeze_modules: Sequence[str] = (), clip_grad_norm: float = 0.0,
                 mesh=None):
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
        self.state: Dict[str, Dict[str, torch.Tensor]] = {}
        self.mesh = mesh

    def zero_grad(self) -> None:
        for _, p, _ in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for _, p, _ in self.params]
        if self.mesh is not None:
            grads = self._data_mean(grads)
        if self.weight_decay:
            wd = 2.0 * self.weight_decay
            grads = [g + wd * p if d else g for g, (_, p, d) in zip(grads, self.params)]
        if self.clip:
            norm = torch.sqrt(self._sum_of_squares(grads))
            keep = norm < self.clip
            grads = [torch.where(keep, g, g / norm * self.clip) for g in grads]
        step_size = -float(self.lr(self.count))
        for g, (name, p, _) in zip(grads, self.params):
            if name not in self.state:  # zeros, as optax's init, on p's device now
                self.state[name] = ({"trace": torch.zeros_like(p)} if self.kind == "sgd"
                                    else {"mu": torch.zeros_like(p), "nu": torch.zeros_like(p)})
            st = self._on_device(name, p)
            if self.kind == "sgd":
                st["trace"] = g + self.momentum * st["trace"]
                upd = st["trace"] * step_size
            else:
                upd = self._adam(g, st) * step_size
            p.add_(upd)
        self.count += 1

    def _data_mean(self, grads):
        """The gradients averaged over the mesh's data column: one
        all-reduce of a flat buffer per dtype."""
        out = list(grads)
        by_dtype: Dict[torch.dtype, list] = {}
        for i, g in enumerate(grads):
            by_dtype.setdefault(g.dtype, []).append(i)
        for idx in by_dtype.values():
            flat = torch.cat([grads[i].reshape(-1) for i in idx])
            dist.all_reduce(flat, group=self.mesh.data_group)
            flat /= self.mesh.data
            for i, part in zip(idx, flat.split([grads[i].numel() for i in idx])):
                out[i] = part.view_as(grads[i])
        return out

    def _sum_of_squares(self, grads) -> torch.Tensor:
        """The squared global norm of the logical parameters: on a mesh
        that splits the fc head, its shards' share summed over the model
        row."""
        split = [self.mesh is not None and self.mesh.model > 1 and split_dim(name) is not None
                 for name, _, _ in self.params]
        total = sum(torch.sum(g * g) for g, s in zip(grads, split) if not s)
        if any(split):
            part = sum(torch.sum(g * g) for g, s in zip(grads, split) if s)
            dist.all_reduce(part, group=self.mesh.model_group)
            total = total + part
        return total

    def _on_device(self, name: str, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        st = self.state[name]
        for k, v in st.items():
            if v.device != p.device:
                st[k] = v.to(p.device)
        return st

    def state_dict(self) -> dict:
        return {"kind": self.kind, "count": self.count,
                "state": {name: dict(st) for name, st in self.state.items()}}

    def load_state_dict(self, state: dict) -> None:
        """Take a :meth:`state_dict` back (one saved by a checkpoint, say),
        its tensors onto the parameters' devices. Raises if it is another
        optimizer's or names a parameter this one does not train."""
        keys = ("trace",) if self.kind == "sgd" else ("mu", "nu")
        if state["kind"] != self.kind:
            raise ValueError(f"a {state['kind']} state for a {self.kind} optimizer")
        params = {name: p for name, p, _ in self.params}
        unknown = sorted(set(state["state"]) - set(params))
        if unknown:
            raise ValueError(f"state for parameters this optimizer does not train: {unknown}")
        self.count = int(state["count"])
        self.state = {}
        for name, st in state["state"].items():
            if set(st) != set(keys) or any(v.shape != params[name].shape for v in st.values()):
                raise ValueError(f"{name}: state {sorted(st)} does not fit the parameter")
            self.state[name] = dict(st)
            self._on_device(name, params[name])

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
