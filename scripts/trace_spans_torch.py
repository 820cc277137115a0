"""The port's spans on the benchmark's cells, on one card.

For each cell: the device ms of each stage of a detect call or joint step,
from the CUDA events at its span's edges; the host's waits on the device
(the blocking runtime calls inside each call, each with the span and the
aten operation it sits in, and the host ms spent in them); the kernel
launches a call; the share of the traced device time launched outside every
call; the traced window's idle gaps by what the host was doing
(portbench.harness.digest); the ResNet branches a call runs through the
frozen epilogue and through the modules; and what recording costs the host
when on: a span opened and closed on its own, and calls timed with
recording off and on, in alternating blocks.

    python3 scripts/trace_spans_torch.py [--cells CELL ...] [--calls 10]
        [--rounds 20] [--block 5] [--seed N] [--out chiprun_out/trace_spans.json]

The cells' configurations, weights and inputs are the benchmark's
(portbench). ``--tiny`` runs the same on the CPU at the benchmark tests'
size, where no span has a device time.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import glob
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from faster_rcnn_tpu_torch import _build  # noqa: E402
from faster_rcnn_tpu_torch.utils import profiling  # noqa: E402
from portbench import harness, inputs, port, weights  # noqa: E402

CELLS = ("r50_kitti.detect_b16", "vgg16_kitti.detect_b16", "r50_kitti.train_joint_b16")


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "no nvidia-smi"


class Cell:
    """One cell's system as the benchmark builds it: ``prepare(i)`` makes
    what call ``i`` takes outside the call (a train step's draws), ``call``
    runs it and ``finish`` does what the caller does after it (a detect
    call's readback)."""

    def __init__(self, name: str, seed: int, dev, tiny: bool):
        if tiny:
            from portbench.tests import tiny as tiny_cells
            found = tiny_cells.found(name)
        else:
            found = harness.find_cell(ROOT, name)
        self.spec, self.mix, self.dev, self.seed = found["spec"], found["mix"], dev, seed
        self.model = port.model(self.spec, weights.make_weights(self.spec, seed, dev), dev)
        n = min(4, self.mix["distinct_batches"])
        self.detect = self.mix["mode"] == "detect"
        if self.detect:
            self.fn = port.detect_fn(self.spec, self.model, dev)
            self.batches = [inputs.frames(self.spec, self.mix, seed, i, dev).cpu().numpy()
                            for i in range(n)]
            self.hw = inputs.frame_hw(self.spec, self.mix)
            self.root = "frcnn.detect"
        else:
            self.fn, _ = port.train_step(self.spec, self.model, dev)
            self.batches = [inputs.train_batch(self.spec, self.mix, seed, i, dev)
                            for i in range(n)]
            self.root = "frcnn.train.joint"

    def prepare(self, i: int):
        if self.detect:
            return self.batches[i % len(self.batches)], self.hw
        return (self.batches[i % len(self.batches)],
                inputs.draws(self.spec, self.mix["batch"], self.seed, i, self.dev, port.Draws))

    def call(self, args):
        return self.fn(*args)

    def finish(self, out) -> None:
        if self.detect:
            out.valid.cpu()

    def sync(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)


def traced(cell: Cell, calls: int) -> dict:
    """``calls`` calls under utils/profiling.device_trace: the spans and
    runtime calls it writes beside the trace, digested, and the ResNet
    branches a call takes through the frozen epilogue and through the
    modules (``_build.FROZEN_BRANCHES``)."""
    before = dict(_build.FROZEN_BRANCHES)
    with tempfile.TemporaryDirectory() as d:
        with profiling.device_trace(d) as prof:
            with torch.profiler.record_function(harness.Tracer.NAME):
                for i in range(calls):
                    out = cell.call(cell.prepare(i))
                    cell.finish(out)
        branches = {k: (v - before[k]) / calls for k, v in _build.FROZEN_BRANCHES.items()}
        with open(sorted(glob.glob(os.path.join(d, "spans_*.json")))[-1]) as f:
            found = json.load(f)
        dig = harness.digest(prof)
        span_names = {s["name"] for c in found["calls"] for s in c["spans"]}
        on_device = sorted({e.name() for e in prof.profiler.kineto_results.events()
                            if e.device_type() == torch.autograd.DeviceType.CUDA
                            and e.name() in span_names | {harness.Tracer.NAME}})
    mine = [c for c in found["calls"] if c["name"] == cell.root]
    stages = collections.defaultdict(list)
    root_ms, sums = [], []
    for c in mine:
        root = c["spans"][0]
        root_ms.append(root["device_ms"])
        kids = [s for s in c["spans"] if s["parent"] == root["id"]]
        for s in kids:
            stages[s["name"]].append(s["device_ms"])
        if root["device_ms"] is not None:
            sums.append(sum(s["device_ms"] for s in kids) / root["device_ms"])
    sites = collections.Counter((s["call"], s["span"], s["op"]) for c in mine
                                for s in c["sync_sites"])
    waits = collections.defaultdict(float)
    for c in mine:
        for s in c["sync_sites"]:
            waits[(s["call"], s["span"], s["op"])] += s["wait_ms"] / len(mine)

    def mean(xs):
        xs = [x for x in xs if x is not None]
        return sum(xs) / len(xs) if xs else None

    return {
        "calls": len(mine),
        "stage_device_ms": {k: mean(v) for k, v in stages.items()},
        "call_device_ms": mean(root_ms),
        "stages_over_call": [min(sums), max(sums)] if sums else None,
        "call_host_ms": mean([(c["end_ns"] - c["start_ns"]) / 1e6 for c in mine]),
        "host_syncs": mean([c["syncs"] for c in mine]),
        "sync_wait_ms": mean([c["sync_wait_ms"] for c in mine]),
        "launches": mean([c["launches"] for c in mine]),
        "frozen_branches": branches,
        "sync_sites": [{"call": k[0], "span": k[1], "op": k[2], "per_call": v / len(mine),
                        "wait_ms": waits[k]} for k, v in sites.most_common()],
        "outside_ms": found["outside_ms"], "device_ms": found["device_ms"],
        "spans_on_the_device_timeline": on_device,
        "window_s": dig["window_s"], "busy_s": dig["busy_s"],
        "idle_pct": 100.0 * (1 - dig["busy_s"] / dig["window_s"]),
        "breakdown": dig["breakdown"],
    }


def span_cost(dev, n: int = 5000) -> dict:
    """Host us of one span opened and closed on ``dev``: with recording off;
    on, making its CUDA events (``first_on_us``); and on again, reusing the
    events the first recording resolved (``on_us``)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)  # the CUDA context, before the clock starts
    out = {}
    for key in ("off_us", "first_on_us", "on_us"):
        with contextlib.nullcontext() if key == "off_us" else profiling.recording():
            t = time.perf_counter()
            for _ in range(n):
                with profiling.scope("span_cost", device=dev):
                    pass
            out[key] = (time.perf_counter() - t) / n * 1e6
    return out


def cost(cell: Cell, rounds: int, block: int) -> dict:
    """Host ms a call, with recording off and on, in alternating blocks of
    ``block`` calls (off first in even rounds, on first in odd ones): the
    call to its return (``enqueue``) and the block's calls with their
    readback up to the device's end, over the calls (``wall``); and each
    round's on block against its off block (``paired``: the quartiles of
    on / off - 1 over the rounds)."""
    got = {False: {"enqueue": [], "wall": []}, True: {"enqueue": [], "wall": []}}
    for r in range(rounds):
        for on in ((False, True) if r % 2 == 0 else (True, False)):
            args = [cell.prepare(i) for i in range(block)]
            cell.sync()
            with profiling.recording() if on else contextlib.nullcontext():
                t0 = time.perf_counter()
                for a in args:
                    t = time.perf_counter()
                    out = cell.call(a)
                    got[on]["enqueue"].append(time.perf_counter() - t)
                    cell.finish(out)
                cell.sync()
                got[on]["wall"].append((time.perf_counter() - t0) / block)
    out = {}
    for k in ("enqueue", "wall"):
        off = statistics.median(got[False][k]) * 1e3
        on = statistics.median(got[True][k]) * 1e3
        out[k] = {"off_ms": off, "on_ms": on, "on_over_off": on / off,
                  "off_all_ms": [x * 1e3 for x in got[False][k]],
                  "on_all_ms": [x * 1e3 for x in got[True][k]]}
    rel = [a / b - 1 for a, b in zip(got[True]["wall"], got[False]["wall"])]
    out["paired"] = statistics.quantiles(rel, n=4) if len(rel) > 1 else rel
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--cells", nargs="*", default=list(CELLS))
    p.add_argument("--calls", type=int, default=10)
    p.add_argument("--rounds", type=int, default=20)
    p.add_argument("--block", type=int, default=5)
    p.add_argument("--seed", type=int, default=3_100_000_016)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--out", default="chiprun_out/trace_spans.json")
    a = p.parse_args(argv)
    harness.env_for_caches(ROOT)
    dev = torch.device("cpu") if a.tiny else torch.device("cuda", 0)
    result = {"card": card(), "torch": torch.__version__,
              "profiler_flag": hasattr(torch.autograd.profiler, "_is_profiler_enabled"),
              "fast_range": hasattr(torch._C._profiler, "_RecordFunctionFast"), "cells": {}}
    result["span_cost"] = span_cost(dev)
    print(json.dumps({k: v for k, v in result.items() if k != "cells"}), flush=True)
    for name in a.cells:
        t0 = time.perf_counter()
        cell = Cell(name, a.seed, dev, a.tiny)
        for i in range(3):
            cell.finish(cell.call(cell.prepare(i)))
        cell.sync()
        got = {"traced": traced(cell, a.calls), "cost": cost(cell, a.rounds, a.block)}
        got["seconds"] = time.perf_counter() - t0
        result["cells"][name] = got
        tr = got["traced"]
        print(name, json.dumps({k: tr[k] for k in (
            "calls", "stage_device_ms", "call_device_ms", "stages_over_call", "call_host_ms",
            "host_syncs", "sync_wait_ms", "launches", "frozen_branches", "idle_pct",
            "spans_on_the_device_timeline")}), flush=True)
        print(name, "sync sites", json.dumps(tr["sync_sites"]), flush=True)
        print(name, "outside", tr["outside_ms"], "of", tr["device_ms"], "device ms", flush=True)
        print(name, "idle gaps", json.dumps(tr["breakdown"]["idle_gaps"]), flush=True)
        print(name, "cost", json.dumps(
            {k: {x: v[x] for x in ("off_ms", "on_ms", "on_over_off")} if k != "paired" else v
             for k, v in got["cost"].items()}), flush=True)
        del cell
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(result, f, indent=1, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
