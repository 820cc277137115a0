#!/usr/bin/env python3
"""Time the port's K2 stem-conv kernel (faster_rcnn_tpu_torch/csrc/conv1.cu,
bf16 entry) alone on one CUDA card.

    python3 scripts/bench_conv1_cuda.py

At the paths' canvas (16 x 608 x 1504 x 3 bf16, seeded uniform pixels and
lecun-scaled weights) it runs ``chip_smoke.check_conv1``: K2 against its
plain version (within 1e-2 of max|ref|) and on integer inputs (bit for
bit), K2's and cuDNN bf16's time from CUDA events, and the bound. It adds
the device time of one K2 launch from torch.profiler, and prints the card's
name and power limit, then one JSON line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from faster_rcnn_tpu_torch.ops import conv1_cuda  # noqa: E402

SHAPE = (16, 608, 1504, 3)


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_conv1_cuda: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    x = (torch.rand(SHAPE, generator=g, device="cuda") * 2 - 1).to(torch.bfloat16)
    w = (torch.randn((7, 7, 3, 64), generator=g, device="cuda") / 147 ** 0.5).to(torch.bfloat16)
    case = chip_smoke.check_conv1("alone", x, w)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            conv1_cuda.conv1(x, w)
        torch.cuda.synchronize()
    case["device_us_per_launch"] = {
        e.key[:40]: us / 10 for e in prof.key_averages()
        if (us := getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)) > 0}
    print(json.dumps(case), flush=True)
    return 0 if case["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
