"""Carry weights from a faster_rcnn_tpu (Flax) variable tree to the port.

The port's module names are the Flax tree's Keras layer names, so the
mapping is by path: ``params/backbone/res2a/res2a_branch2a/kernel`` becomes
``backbone.res2a.res2a_branch2a.weight``, for every network: VGG16's
``block*_conv*`` and ``fc1``/``fc2``, ResNet-101's ``scale*`` channel
scales and bias-free convs. The tree arrives as nested dicts of
numpy arrays, so this module needs no JAX.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def from_flax_numpy(variables_np) -> Dict[str, torch.Tensor]:
    """``{"params": ..., "batch_stats": ...}`` of numpy arrays -> a state
    dict for :class:`faster_rcnn_tpu_torch.models.detector.FasterRCNN`.

    Conv kernels go HWIO -> OIHW, dense kernels (in, out) -> (out, in),
    ``batch_stats`` mean/var become the batch-norm buffers; the ``scale``
    of a batch norm or channel scale and every ``bias`` keep their names.
    """
    out: Dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, leaf in _flatten(variables_np.get(collection, {})):
            arr = np.asarray(leaf, np.float32)
            name = path[-1]
            if name == "kernel":
                if arr.ndim == 4:
                    arr = arr.transpose(3, 2, 0, 1)
                elif arr.ndim == 2:
                    arr = arr.T
                else:
                    raise ValueError(f"unexpected kernel rank at {'/'.join(path)}: {arr.shape}")
                name = "weight"
            elif name not in ("bias", "scale", "mean", "var"):
                raise ValueError(f"unexpected leaf {'/'.join(path)}")
            out[".".join(path[:-1] + (name,))] = torch.tensor(arr)
    return out
