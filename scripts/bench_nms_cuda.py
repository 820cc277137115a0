#!/usr/bin/env python3
"""Time the port's K3 NMS kernel (faster_rcnn_tpu_torch/csrc/nms.cu) alone on
one CUDA card, at the three shapes of the paths.

    python3 scripts/bench_nms_cuda.py [--save FILE | --load FILE]

The inputs are captured from the paths as chip_smoke.py captures them
(ResNet-50 at kitti_config(), B=16, seeded random weights and images): the
detect call's proposal NMS (16 x 8192, tile 512, IoU 0.7, enough 300) and
final NMS (16 x 384, tile 128, IoU 0.5, enough 300), and the joint train
step's proposal NMS (16 x 6144, tile 512, IoU 0.7, enough 2000) on its first
step and on a step after 10 more. Each goes through
``chip_smoke.check_nms``: bit for bit against the plain version, the
kernel's time from CUDA events over 20 calls, the bound, the tile phases
and the cluster occupancy. The script adds the device time of one launch
from torch.profiler and, for every cluster size from 1 to 8, the clusters
the card holds at once and the kernel's time and exactness when launched
on clusters of that size (the wrapper picks one; this shows why). It
prints the card's name and power limit, then one JSON line per case.
``--save`` writes the captured inputs, ``--load`` times saved ones instead
of capturing, so that two checkouts of the repo can be timed on the same
inputs in one run (the cluster sizes only where the kernel has them).
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
from faster_rcnn_tpu_torch.ops import nms, nms_cuda  # noqa: E402

LATER = 10  # train steps between the first step's capture and the later one's


def capture() -> dict:
    """{label: (args, kw)} of the paths' NMS calls."""
    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    run = chip_smoke.KittiDetect(rng, dev)
    calls, _ = run.capture()
    cases = dict(zip(("detect proposal NMS", "detect final NMS"), calls["nms"]))
    del run, calls
    train = chip_smoke.KittiTrain(rng, dev)
    calls, _ = train.capture()
    cases["train proposal NMS, step 1"] = calls["nms"][0]
    with chip_smoke.uncounted():
        for _ in range(LATER):
            train.step(train.batch, train.gen)
    calls, _ = train.capture()
    cases[f"train proposal NMS, step {LATER + 2}"] = calls["nms"][0]
    del train, calls
    torch.cuda.empty_cache()
    return cases


def device_us(args, kw, reps: int = 10) -> dict:
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            nms_cuda.nms_keep_mask(*args, **kw)
        torch.cuda.synchronize()
    return {e.key[:40]: us / reps for e in prof.key_averages()
            if (us := getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)) > 0}


def by_cluster(args, kw) -> dict:
    """{c: clusters held at once, ms and exactness on clusters of c}."""
    (boxes, valid, iou), tile, enough = args, kw["tile"], kw["enough"]
    b, n = valid.shape
    want = nms.nms_sorted_mask_blocked(boxes, valid, iou, tile=tile, enough=enough)
    keep = torch.empty_like(valid)
    out = {}
    for c in range(1, nms_cuda.MAX_CLUSTER + 1):
        def run():
            _build.launch("nms", "frcnn_nms_keep_mask", boxes, boxes.data_ptr(),
                          valid.data_ptr(), keep.data_ptr(), b, n, tile, float(iou), enough, c)
        with chip_smoke.uncounted():
            run()
            torch.cuda.synchronize()
            ok = bool(torch.equal(keep, want))
            ms = chip_smoke.time_ms(run, 20)
        out[c] = {"max_active_clusters": nms_cuda.max_active_clusters(boxes.device, n, tile,
                                                                      enough, c),
                  "ms": ms, "ok": ok}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    group = ap.add_mutually_exclusive_group()
    group.add_argument("--save", help="write the captured inputs to this file")
    group.add_argument("--load", help="time the inputs saved in this file")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_nms_cuda: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    if opts.load:
        cases = {label: ([t.cuda() if isinstance(t, torch.Tensor) else t for t in args], kw)
                 for label, (args, kw) in torch.load(opts.load).items()}
    else:
        cases = capture()
        if opts.save:
            torch.save({label: ([t.cpu() if isinstance(t, torch.Tensor) else t for t in args], kw)
                        for label, (args, kw) in cases.items()}, opts.save)
    ok = True
    for label, (args, kw) in cases.items():
        with torch.inference_mode():
            case = chip_smoke.check_nms(label, args, kw)
            case["device_us_per_launch"] = device_us(args, kw)
            if hasattr(nms_cuda, "max_active_clusters"):
                case["by_cluster"] = by_cluster(args, kw)
                ok &= all(v["ok"] for v in case["by_cluster"].values())
        ok &= case["ok"]
        print(json.dumps(case), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
