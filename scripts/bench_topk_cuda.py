#!/usr/bin/env python3
"""Time the port's K4 top-k kernel (faster_rcnn_tpu_torch/csrc/topk.cu)
against torch.sort(stable=True) on one CUDA card.

    python3 scripts/bench_topk_cuda.py [reps]

At the four shapes of the paths (16 rows of 64,296 scores; k = 128, 256,
6000, 8000) on chip_smoke.topk_adversarial's rows, it checks K4 bit for bit
against the stable sort, then times the two in turns (sort, kernel, kernel,
sort; CUDA events over ``reps`` calls each) and prints one JSON line per
shape, the time of each of K4's launches from torch.profiler, and the card's
name and power limit.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import time_ms, topk_adversarial  # noqa: E402
from faster_rcnn_tpu_torch.ops import sort, sort_cuda  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_topk_cuda: no CUDA device", file=sys.stderr)
        return 2
    reps = int(sys.argv[1]) if len(sys.argv) > 1 else 50
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    for k in (128, 256, 6000, 8000):
        x = torch.tensor(topk_adversarial(k), device="cuda")
        v, i = sort_cuda.topk_sorted(x, k)
        pv, pi = sort.topk_sorted_plain(x, k)
        same = torch.equal(i, pi) and torch.equal(v.view(torch.int32), pv.view(torch.int32))
        lib = lambda: torch.sort(x, dim=-1, descending=True, stable=True)  # noqa: E731
        ker = lambda: sort_cuda.topk_sorted(x, k)  # noqa: E731
        t = [time_ms(f, reps) for f in (lib, ker, ker, lib)]
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                ker()
            torch.cuda.synchronize()
        launches = {}
        for e in prof.key_averages():
            us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
            if us > 0:
                name = re.search(r"topk_\w+", e.key)
                launches[name.group(0) if name else e.key[:24]] = round(us / 10, 2)
        print(json.dumps({"shape": list(x.shape), "k": k, "bit_exact": same,
                          "kernel_ms": [t[1], t[2]], "sort_ms": [t[0], t[3]],
                          "launch_us": launches}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
