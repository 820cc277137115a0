"""One run of one cell of the port's benchmark.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads, warms up, measures for ``--seconds``, checks the timed path's
outputs against the plain reference, and prints the result as the last
line of standard output, each compared number beside its limit as the last
lines of standard error. A cell on several chips runs one process a card.
Without a CUDA card, or with fewer than the cell asks for, it exits with
code 3 and prints no result."""

from __future__ import annotations

import time

T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

from portbench import harness  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    harness.env_for_caches(ROOT)
    found = harness.find_cell(ROOT, a.workload)
    chips = found["cell"]["chips"]

    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f"portbench: {a.workload} needs {chips} CUDA card(s), this machine has {have}",
              file=sys.stderr)
        return 3
    args = {"seed": a.seed, "seconds": a.seconds, "trace": bool(a.trace), "t0": T0}
    if chips == 1:
        ctx = harness.Ctx(found, a.seed, a.seconds, bool(a.trace), torch.device("cuda", 0),
                          t0=T0)
        ranks = [harness.run_rank(ctx)]
    else:
        ranks = harness.run_ranks(found, args, chips, "nccl")
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips}
    out, lines, bad = harness.result(found, ranks, T0, bool(a.trace), device)
    bad = sorted(set(bad) | ({m.split(".")[0] for m in sys.modules} & set(harness.FORBIDDEN)))
    if bad:
        print(f"portbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 4
    for r in ranks:
        print(f"rank {r['rank']}: " + json.dumps(r["stats"]), flush=True)
        extra = {k: v for k, v in r["checks"].items() if k not in found["limits"]}
        if extra:
            print(f"rank {r['rank']} check details: " + json.dumps(extra, default=str), flush=True)
    for line in lines:
        print(line, file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
