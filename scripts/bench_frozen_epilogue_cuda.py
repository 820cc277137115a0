#!/usr/bin/env python3
"""Time the port's frozen epilogue (faster_rcnn_tpu_torch/csrc/frozen_epilogue.cu)
alone on one CUDA card.

    python3 scripts/bench_frozen_epilogue_cuda.py

At the ResNet-50 paths' shapes (chip_smoke.EPILOGUE_CASES: the stem's map,
stage 2's, stage 5's over 300 ROIs at B=16, bf16) it runs
``chip_smoke.check_frozen_epilogue``: the kernel against its plain version
bit for bit on seeded maps with NaN, infinities, signed zeros, subnormals
and near-largest values, the kernel's time from CUDA events and its device
time a launch from torch.profiler, the plain version's time and the bound.
It prints the card's name and power limit, then one JSON line, and exits 1
if any bit differs.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_frozen_epilogue_cuda: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    chip_smoke.phase_build()
    with torch.inference_mode():
        cases = [chip_smoke.check_frozen_epilogue(label, shape, *variant, torch.device("cuda"))
                 for label, shape, *variant in chip_smoke.EPILOGUE_CASES]
    print(json.dumps(cases), flush=True)
    return 0 if all(c["ok"] for c in cases) else 1


if __name__ == "__main__":
    sys.exit(main())
