"""PyTorch/CUDA port of faster_rcnn_tpu for NVIDIA Hopper (H100).

The module layout mirrors ``faster_rcnn_tpu`` so each counterpart is easy to
find. The package imports torch, numpy and the standard library only. Its
kernels (``csrc/*.cu``) are built with nvcc at their first launch.
"""

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU. Raises when CUDA is asked for and no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "faster_rcnn_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
