#!/usr/bin/env python3
"""Time the port's K1 backward kernel (faster_rcnn_tpu_torch/csrc/roi_align.cu,
``roi_align_bwd_kernel``) alone on one CUDA card, at the train step's shape.

    python3 scripts/bench_roi_align_bwd_cuda.py [--save FILE | --load FILE]

Two inputs: the cotangent and ROIs that the joint train step gives the
kernel (ResNet-50 at kitti_config(), B=16, 64 ROIs an image over a
38x94x1024 bf16 map, captured as chip_smoke.py captures them), and a hot
row: the same cotangent with every ROI of an image the same 3x2 box, so
that two rows of each image take all of its hits. Each goes through
``chip_smoke.check_roi_align_bwd``: against the plain version in bf16 and
f32, two calls bit for bit, the bf16 result against the f32 one rounded
once, the kernel's time from CUDA events, the bound. The script adds the
device time of one launch from torch.profiler (every kernel the call runs)
and the entries per map pixel (the cotangent rows the kernel sums there,
with and without coincident taps merged; the largest row and column; the
columns it splits); the check reports the hits per map row. It prints the card's name and
power limit, then one JSON line per case. ``--save`` writes the inputs,
``--load`` times saved ones instead of capturing, so that two checkouts of
the repo (this script copied into the other one's scripts/) are timed on the
same inputs in one run.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from faster_rcnn_tpu_torch.ops import roi_align_cuda  # noqa: E402
try:
    from faster_rcnn_tpu_torch.ops.roi_align_taps import entries_per_column  # noqa: E402
except ImportError:  # a checkout from before the module, timed with --load
    entries_per_column = None

HOT_ROI = (40.0, 15.0, 43.0, 17.0)  # 3 columns x 2 rows: taps on rows 15 and 16 only


def capture() -> dict:
    """{label: (grad, rois, feature_shape, pool_size)}."""
    train = chip_smoke.KittiTrain(np.random.RandomState(0), torch.device("cuda"))
    calls, _ = train.capture()
    (grad, rois, shape, p), _ = calls["roi_align_bwd"][0]
    del train, calls
    torch.cuda.empty_cache()
    hot = torch.tensor(HOT_ROI, device=rois.device).expand_as(rois).contiguous()
    return {"train step": (grad, rois, tuple(shape), p), "hot row": (grad, hot, tuple(shape), p)}


def device_us(args, reps: int = 10) -> dict:
    """Device time of each kernel one call runs, per call."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            roi_align_cuda.roi_align_backward(*args)
        torch.cuda.synchronize()
    return {e.key[:40]: us / reps for e in prof.key_averages()
            if (us := getattr(e, "device_time_total", 0)) > 0}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    group = ap.add_mutually_exclusive_group()
    group.add_argument("--save", help="write the captured inputs to this file")
    group.add_argument("--load", help="time the inputs saved in this file")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_roi_align_bwd_cuda: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    if opts.load:
        cases = {label: (g.cuda(), r.cuda(), tuple(shape), p)
                 for label, (g, r, shape, p) in torch.load(opts.load).items()}
    else:
        cases = capture()
        if opts.save:
            torch.save({label: (g.cpu(), r.cpu(), shape, p)
                        for label, (g, r, shape, p) in cases.items()}, opts.save)
    ok = True
    for label, args in cases.items():
        case = chip_smoke.check_roi_align_bwd(label, *args)  # autograd: not in inference mode
        with torch.inference_mode():
            case["device_us_per_call"] = device_us(args)
        if entries_per_column is not None:
            case["entries"] = entries_per_column(args[1], args[2][1], args[2][2], args[3])
        ok &= case["ok"]
        print(json.dumps(case), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
