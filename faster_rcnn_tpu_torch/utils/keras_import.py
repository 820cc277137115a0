"""Keras h5 weights in and out of the port's state dicts, by layer name.

Counterpart of faster_rcnn_tpu/utils/keras_import.py: the reference hands
weights between steps as Keras h5 files matched by layer name
(train_rpn_step3.py:92-93; vgg.py:191-195; resnet.py:481-485) and seeds its
backbones from the Keras ImageNet h5s. The port's module names are the
Keras layer names (utils/convert.py), so a state-dict key such as
``backbone.res2a.res2a_branch2a.weight`` holds the h5 layer
``res2a_branch2a``'s kernel.

Layout facts handled:
  * Keras h5: root attr ``layer_names``; each layer group has
    ``weight_names`` entries like ``res2a_branch2a/kernel:0`` (bytes or
    str) whose datasets hold the arrays; nested under ``model_weights/``
    for full-model saves.
  * Conv kernels are HWIO in Keras (TF backend) and OIHW here; dense
    kernels are (in, out) in Keras and (out, in) here.
  * BatchNormalization gamma/beta/moving_mean/moving_variance are the
    frozen batch norm's ``scale``/``bias`` and its ``mean``/``var``
    buffers; the reference's custom Scale layer's gamma/beta are
    ``ChannelScale``'s ``scale``/``bias``.

``h5py`` is imported inside the functions: only the h5 tools need it.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

# keras short name -> the state dict's leaf name
_LEAF = {
    "kernel": "weight",
    "bias": "bias",
    "gamma": "scale",
    "beta": "bias",
    "moving_mean": "mean",
    "moving_variance": "var",
}


def _collect_h5_layers(f) -> Dict[str, Dict[str, np.ndarray]]:
    """{layer_name: {short_weight_name: array}} from a Keras h5 file."""
    root = f["model_weights"] if "model_weights" in f else f
    layers: Dict[str, Dict[str, np.ndarray]] = {}
    layer_names = [
        n.decode() if isinstance(n, bytes) else n for n in root.attrs.get("layer_names", [])
    ]
    for lname in layer_names:
        g = root[lname]
        weight_names = [
            n.decode() if isinstance(n, bytes) else n for n in g.attrs.get("weight_names", [])
        ]
        if not weight_names:
            continue
        weights = {}
        for wn in weight_names:
            short = wn.split("/")[-1].split(":")[0]  # 'kernel', 'gamma', ...
            weights[short] = np.asarray(g[wn])
        layers[lname] = weights
    return layers


def _kernel_to_torch(arr: np.ndarray) -> np.ndarray:
    """HWIO -> OIHW (conv), (in, out) -> (out, in) (dense)."""
    if arr.ndim == 4:
        return arr.transpose(3, 2, 0, 1)
    if arr.ndim == 2:
        return arr.T
    raise ValueError(f"unexpected kernel rank {arr.shape}")


def _kernel_to_keras(arr: np.ndarray) -> np.ndarray:
    """OIHW -> HWIO (conv), (out, in) -> (in, out) (dense)."""
    if arr.ndim == 4:
        return arr.transpose(2, 3, 1, 0)
    if arr.ndim == 2:
        return arr.T
    raise ValueError(f"unexpected weight rank {arr.shape}")


def load_keras_h5(
    h5_path: str,
    state_dict: Dict[str, torch.Tensor],
    verbose: bool = False,
) -> Tuple[Dict[str, torch.Tensor], List[str], List[str]]:
    """Transplant h5 weights into a copy of ``state_dict`` by name: an h5
    layer applies to every entry with a key component equal to its name,
    whose leaf is the weight's counterpart and whose shape matches.

    Returns (new state dict, loaded layer names, unmatched layer names).
    Unmatched layers are skipped, as Keras's ``by_name`` does (printed
    with ``verbose``); two entries claiming one layer's weight raise.
    """
    import h5py

    with h5py.File(h5_path, "r") as f:
        layers = _collect_h5_layers(f)

    out = {k: v.clone() for k, v in state_dict.items()}
    keys = [(k, tuple(k.split("."))) for k in out]
    loaded, unmatched = [], []
    for lname, weights in layers.items():
        hit = False
        for short, arr in weights.items():
            leaf = _LEAF.get(short)
            if leaf is None:
                continue
            if short == "kernel":
                arr = _kernel_to_torch(arr)
            matches = [k for k, path in keys
                       if lname in path[:-1] and path[-1] == leaf
                       and tuple(out[k].shape) == arr.shape]
            if len(matches) > 1:
                # Keras layer names are unique within a model; two modules
                # claiming one h5 layer means the mapping is ambiguous
                raise ValueError(f"keras_import: h5 layer {lname!r}/{short} matches "
                                 f"multiple entries: {matches}")
            if matches:
                k = matches[0]
                out[k] = torch.from_numpy(np.ascontiguousarray(arr, np.float32)).to(out[k].dtype)
                hit = True
        if hit:
            loaded.append(lname)
        else:
            unmatched.append(lname)
            if verbose:
                print(f"keras_import: no match for layer {lname}")
    return out, loaded, unmatched


def save_keras_h5(state_dict: Dict[str, torch.Tensor], h5_path: str) -> List[str]:
    """Write a state dict as a Keras 2.0.8 weights-only h5, the inverse of
    :func:`load_keras_h5`: the layout Keras ``model.save_weights`` emits
    (root ``layer_names`` attr, per-layer ``weight_names`` with
    ``<layer>/<weight>:0`` datasets), so weights trained here can be handed
    back to the reference's ``by_name`` loaders.

    Per module (the key component before the leaf): ``weight`` -> kernel
    (+bias) for convs and dense layers; ``scale`` -> gamma (+beta), plus
    moving_mean/moving_variance where the module holds ``mean`` and
    ``var`` (the frozen batch norm; a channel scale has none).

    Returns the written layer names. Raises on a module name at two places
    (Keras layer names are unique).
    """
    import h5py

    modules: Dict[str, Dict[str, np.ndarray]] = {}
    seen: Dict[str, Tuple[str, ...]] = {}
    for key, val in state_dict.items():
        path = tuple(key.split("."))
        if len(path) < 2:
            continue
        prefix, mod = path[:-1], path[-2]
        if mod in seen and seen[mod] != prefix:
            raise ValueError(
                f"save_keras_h5: duplicate module name {mod!r} at {seen[mod]} "
                f"and {prefix} — Keras layer names must be unique")
        seen[mod] = prefix
        modules.setdefault(mod, {})[path[-1]] = val.detach().cpu().float().numpy()

    written = []
    with h5py.File(h5_path, "w") as f:
        for lname, leaves in modules.items():
            g = f.create_group(lname)
            wnames = []

            def put(keras_short, arr):
                wn = f"{lname}/{keras_short}:0"
                g.create_dataset(wn, data=np.asarray(arr, np.float32))
                wnames.append(wn.encode())

            if "weight" in leaves:
                put("kernel", _kernel_to_keras(leaves["weight"]))
                if "bias" in leaves:
                    put("bias", leaves["bias"])
            elif "scale" in leaves:
                put("gamma", leaves["scale"])
                if "bias" in leaves:
                    put("beta", leaves["bias"])
                if "mean" in leaves and "var" in leaves:
                    put("moving_mean", leaves["mean"])
                    put("moving_variance", leaves["var"])
            else:
                continue  # no recognizable weights
            g.attrs["weight_names"] = wnames
            written.append(lname)
        f.attrs["layer_names"] = [n.encode() for n in written]
        f.attrs["backend"] = b"tensorflow"
        f.attrs["keras_version"] = b"2.0.8"
    return written
