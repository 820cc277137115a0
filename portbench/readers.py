"""What the per-layer metric readers (``metrics/<name>.py``) share. Each
reader takes ``t``, one rank's trace digest (harness.per_layer_raw), and
returns its number, or None where the trace has nothing for it."""

from __future__ import annotations

import re

import numpy as np

from portbench.counts import kernels
from portbench.counts.peaks import BF16_FLOPS

KERNELS = {
    "k1_fwd": r"\broi_align_kernel\b",
    "k1_bwd": r"\broi_align_bwd_kernel\b",
    "k2": r"\bconv1_mma_kernel\b",
    "k3": r"\bnms_kernel\b",
    "k4": r"\btopk_(select|count|scatter|sort_chunks|merge)\b",
}


def device_seconds(t: dict, pattern: str) -> float:
    rx = re.compile(pattern)
    return sum(s for name, s in t["kernels"] if rx.search(name))


def roofline_pct(t: dict, kernel: str):
    """100 x the least time of the traced launches of ``kernel`` (from their
    recorded inputs) over their device time in the trace."""
    calls = t["inputs"].get(kernel, [])
    spent = device_seconds(t, KERNELS[kernel])
    if not calls or spent <= 0:
        return None
    if kernel == "k1_fwd":
        least = sum(kernels.roi_align_fwd(shape, rois, p, elem) for shape, rois, p, elem in calls)
    elif kernel == "k1_bwd":
        least = sum(kernels.roi_align_bwd(*c) for c in calls)
    elif kernel == "k2":
        least = sum(kernels.stem_conv(*c) for c in calls)
    elif kernel == "k3":
        least = sum(kernels.nms(shape, keep, valid, tile, enough)
                    for shape, keep, valid, tile, enough in calls)
    else:
        least = sum(kernels.topk(b, n, k) for b, n, k in calls)
    return 100.0 * least / spent


def enqueue_ms(t: dict):
    return float(np.median(t["enqueue_s"])) * 1e3 if t["enqueue_s"] else None


def mfu_pct(t: dict):
    """100 x model FLOPs of the traced steps' images over the chip's bf16
    peak for the traced window."""
    if t["window_s"] <= 0 or not t["traced_steps"]:
        return None
    work = t["flops_per_image"] * t["images_per_step"] * t["traced_steps"]
    return 100.0 * work / (BF16_FLOPS * t["window_s"])


def idle_pct(t: dict):
    if t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def mark_ms(t: dict, name: str):
    return t["marks_ms"].get(name)
