"""Readings for the limits of ``correct``, made on the chip at a cell's own
size: the control (the plain reference computed in float8 e4m3, the
precision below the configuration's bf16, put in the system's place), the
system with a fault planted under its timed path (portbench/faults.py), or
the sound system (``sound``: a run's own set-up, window and check, many
seeds to one process), on each seed given. One JSON line a seed.

    python3 -m portbench.control --workload <cell> --what fp8 --seeds 1 2 3
    python3 -m portbench.control --workload <cell> --what half --seeds 1 2 3
    python3 -m portbench.control --workload <cell> --what sound --seeds 1 2 3"""

from __future__ import annotations

import argparse
import json
import sys
import time

from portbench import faults, harness
from portbench.run import ROOT


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--what", required=True, help="fp8, sound, or a fault: " + ", ".join(
        sorted(set(faults.TRAIN) | set(faults.DETECT))))
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    a = p.parse_args(argv)
    harness.env_for_caches(ROOT)
    found = harness.find_cell(ROOT, a.workload)
    import torch
    chips = found["cell"]["chips"]
    fault = None if a.what == "sound" else a.what
    for seed in a.seeds:
        t = time.time()
        if a.what == "fp8":
            ctx = harness.Ctx(found, seed, a.seconds, False, torch.device("cuda", 0))
            checks = harness.mode(found["mix"]).control(ctx, "fp8")
        elif chips == 1:
            ctx = harness.Ctx(found, seed, a.seconds, False, torch.device("cuda", 0),
                              t0=time.time(), fault=fault)
            checks = harness.run_rank(ctx)["checks"]
        else:
            args = {"seed": seed, "seconds": a.seconds, "trace": False, "t0": time.time(),
                    "fault": fault}
            ranks = harness.run_ranks(found, args, chips, "nccl")
            checks = {k: max(r["checks"][k] for r in ranks) for k in found["limits"]}
        print(json.dumps({"workload": a.workload, "what": a.what, "seed": seed,
                          "seconds": time.time() - t, "checks": checks}, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
