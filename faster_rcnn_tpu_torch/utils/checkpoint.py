"""Checkpointing with auto-resume: ``torch.save`` of a tree of tensors.

Counterpart of faster_rcnn_tpu/utils/checkpoint.py (Orbax), with its API:
:func:`save`, :func:`latest_step`, :func:`restore`. A checkpoint is
``<directory>/<step>/checkpoint.pt``, a tree of dicts, lists and tensors
(the trainer's: the model's state dict, the optimizer's and the count).

Every tensor is copied to the CPU before the write, and the write is
synchronous. It goes to a temporary directory whose name is not a number,
which is renamed to ``<step>`` once the file is complete: a process killed
mid-write leaves no directory that :func:`latest_step` would pick.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, List, Optional

import torch

_FILE = "checkpoint.pt"


def _to_cpu(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def _steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(d) for d in os.listdir(directory)
                  if d.isdigit() and os.path.isfile(os.path.join(directory, d, _FILE)))


def save(directory: str, step: int, tree: Any, keep: int = 3, wait: bool = False) -> None:
    """Save ``tree`` as the checkpoint at ``step``, replacing one there, and
    delete all but the ``keep`` latest. ``wait`` is accepted for the JAX
    package's API (where it waits for an asynchronous write); every write
    here has finished when this returns."""
    del wait
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f".tmp-{step}-{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    with open(os.path.join(tmp, _FILE), "wb") as f:
        torch.save(_to_cpu(tree), f)
        f.flush()
        os.fsync(f.fileno())
    final = os.path.join(directory, str(step))
    if os.path.isdir(final):  # an earlier save of this step: move it aside first
        old = os.path.join(directory, f".old-{step}-{os.getpid()}")
        os.replace(final, old)
        os.replace(tmp, final)
        shutil.rmtree(old)
    else:
        os.replace(tmp, final)
    for s in _steps(directory)[:-keep]:
        shutil.rmtree(os.path.join(directory, str(s)))


def latest_step(directory: str) -> Optional[int]:
    """The latest complete checkpoint's step, or None."""
    steps = _steps(directory)
    return steps[-1] if steps else None


def restore(directory: str, step: Optional[int] = None) -> Any:
    """The tree saved at ``step`` (default: the latest), its tensors on the
    CPU; ``load_state_dict`` puts them on the parameters' devices."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    return torch.load(os.path.join(directory, str(step), _FILE), map_location="cpu",
                      weights_only=True)
