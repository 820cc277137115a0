#!/usr/bin/env python3
"""Time the port's K1 forward kernel (faster_rcnn_tpu_torch/csrc/roi_align.cu,
``roi_align_kernel``) alone on one CUDA card, at the four shapes the paths
give it.

    python3 scripts/bench_roi_align_cuda.py [--save FILE | --load FILE]

The inputs are captured as chip_smoke.py captures them, from one uncounted
call of each path at kitti_config() (seeded random weights, untrained, so
the RPN's proposals are shorter than a trained one's: chip_smoke.py's
phases after training steps read the kernel on those; 608x1504 canvases,
38x94 maps):

  * annotate: VGG16 detection of one frame (B=1, 300 proposals, C=512);
  * step 2: VGG16's detector step on the frozen RPN (B=16, 64 ROIs, C=512);
  * detect: ResNet-50 detection (B=16, 300 proposals, C=1024);
  * joint: ResNet-50's joint step (B=16, 64 ROIs, C=1024).

Each runs in the path's dtype (bf16) and again on the same values in f32.
Per case: the values whose bits differ from the plain version
(``roi_align_cuda.roi_align_plain``), the kernel's ms from CUDA events over
back-to-back calls, the device us of one launch from torch.profiler, the
plain version's ms, the bound (the touched map pixels read once, the ROIs,
the output written once, over 3.35 TB/s; chip_smoke.check_roi_align's) and
the share of the bound the device time reaches, and the kernel's 16-byte
loads per output vector on these ROIs (4 at most; fewer where cells share
tap rows: roi_align_taps.forward_loads). No PyTorch call computes the same
function, so there is no library time. It prints the card's name
and power limit, then one JSON line a case, and exits 1 if any bit differs.

``--save`` writes the captured inputs, ``--load`` times saved ones instead of
capturing, so that two checkouts of the repo (this script copied into the
other one's scripts/) are timed on the same inputs in one run.
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
from faster_rcnn_tpu_torch import _build  # noqa: E402
from faster_rcnn_tpu_torch.ops import roi_align_cuda  # noqa: E402
try:
    from faster_rcnn_tpu_torch.ops.roi_align_taps import forward_loads  # noqa: E402
except ImportError:  # a checkout from before it, timed with --load
    forward_loads = None


def _first_call(calls: dict) -> tuple:
    (feat, rois, p), _ = calls["roi_align"][0]
    return feat.detach().contiguous(), rois.contiguous(), p


def capture(dev) -> dict:
    """{label: (features, rois, pool_size)}: K1 forward's input on each path."""
    rng = np.random.RandomState(0)
    cases = {}
    run = chip_smoke.KittiDetect(rng, dev, b=1, cfg=chip_smoke.vgg_kitti_config(),
                                 path="vgg16_detect")
    cases["annotate B=1 VGG16"] = _first_call(run.capture()[0])
    del run
    four = chip_smoke.FourStep(rng, dev)
    four.models[1] = four.build(1)[0].requires_grad_(False)
    _, _, fn = four.build(2)
    calls: dict = {}
    with chip_smoke.recording(calls):
        fn(four.batch, four.gen)
    cases["step 2 B=16 VGG16"] = _first_call(calls)
    del four, fn, calls
    run = chip_smoke.KittiDetect(rng, dev)
    cases["detect B=16 ResNet-50"] = _first_call(run.capture()[0])
    del run
    train = chip_smoke.KittiTrain(rng, dev)
    cases["joint B=16 ResNet-50"] = _first_call(train.capture()[0])
    del train
    torch.cuda.empty_cache()
    return cases


def measure(label: str, feat: torch.Tensor, rois: torch.Tensor, p: int) -> dict:
    run = lambda: roi_align_cuda.roi_align(feat, rois, p)  # noqa: E731
    got = run()
    want = roi_align_cuda.roi_align_plain(feat, rois, p)
    bits = chip_smoke._bits_differing(got, want)
    err = (got.float() - want.float()).abs().max().item()
    del want
    ms = chip_smoke.time_ms(run, 20)
    device = chip_smoke.profiled_device_us(run, "roi_align_kernel")
    plain = chip_smoke.time_ms(lambda: roi_align_cuda.roi_align_plain(feat, rois, p), 3, warmup=1)
    _, h, w, c = feat.shape
    pixels = chip_smoke.touched_pixels(rois, h, w, p)
    nbytes = (pixels * c + got.numel()) * feat.element_size() + rois.numel() * 4
    bound, by = chip_smoke.bound_ms(nbytes, chip_smoke.LERP_OPS * got.numel(),
                                    chip_smoke.F32_FLOPS)
    mean = device["mean_us"]
    return {"case": label, "dtype": str(feat.dtype).replace("torch.", ""),
            "features": list(feat.shape), "rois": list(rois.shape), "pool": p,
            "bits_differing": bits, "max_abs_err": err, "ms": ms, "device_us": mean,
            "device_us_least": device["min_us"], "launches_traced": device["launches"],
            "plain_ms": plain, "library_ms": None, "bound_us": bound * 1e3, "bound_by": by,
            "bound_share": None if mean is None else bound * 1e3 / mean,
            "map_pixels_read": pixels, "bytes": nbytes,
            "loads_per_vector": forward_loads and forward_loads(rois, h, p)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    group = ap.add_mutually_exclusive_group()
    group.add_argument("--save", help="write the captured inputs to this file")
    group.add_argument("--load", help="time the inputs saved in this file")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_roi_align_cuda: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    _build.lib()
    for line in _build.build_info.get("ptxas", {}).get("roi_align.cu", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"[ptxas roi_align.cu] {line.strip()}", file=sys.stderr, flush=True)
    if opts.load:
        cases = {label: (f.to(dev), r.to(dev), p) for label, (f, r, p) in
                 torch.load(opts.load).items()}
    else:
        cases = capture(dev)
        if opts.save:
            torch.save({label: (f.cpu(), r.cpu(), p) for label, (f, r, p) in cases.items()},
                       opts.save)
    ok = True
    with torch.inference_mode():
        for label, (feat, rois, p) in cases.items():
            for f in (feat, feat.float()):
                case = measure(label, f, rois, p)
                ok &= case["bits_differing"] == 0
                print(json.dumps(case), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
