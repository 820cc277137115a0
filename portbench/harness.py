"""What every cell's run shares: finding the cell, its configuration, its
mix and its metrics by name; one rank's set-up, window, trace and check;
and the result line.

A cell is an entry of ``workloads`` in BENCHMARK.json; its limits live in
``portbench/workloads/<cell>.json``, its configuration in
``portbench/configs/<config>.json``, its mix in
``portbench/traffic/<traffic>.json`` (whose ``mode`` names the driver in
``portbench/modes/``), and each per-layer metric's reader in
``portbench/metrics/<metric>.py``."""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "faster_rcnn_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(root: Path, name: str) -> dict:
    """The cell ``name`` with everything its files say: ``cell`` (its
    BENCHMARK.json entry), ``limits``, ``spec``, ``mix`` and the metrics it
    reports (``end_to_end``, ``per_layer``)."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {c["name"]: c for c in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no cell {name!r} in BENCHMARK.json: {sorted(cells)}")
    cell = cells[name]
    here = root / "portbench"
    own = load_json(here / "workloads" / f"{name}.json")
    for key in ("config", "traffic", "chips"):
        if own[key] != cell[key]:
            raise SystemExit(f"{name}: BENCHMARK.json says {key}={cell[key]!r}, its file "
                             f"{own[key]!r}")

    def mine(m):
        return "workloads" not in m or name in m["workloads"]

    return {"cell": cell, "limits": own["limits"], "root": str(root),
            "spec": load_json(here / "configs" / f"{cell['config']}.json"),
            "mix": load_json(here / "traffic" / f"{cell['traffic']}.json"),
            "end_to_end": [m for m in bench["end_to_end"] if mine(m)],
            "per_layer": [m for m in bench["per_layer"] if mine(m)]}


def reader(metric: str, root=None):
    """The module that reads per-layer metric ``metric`` from a trace."""
    path = (HERE if root is None else Path(root) / "portbench") / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def mode(mix: dict):
    return importlib.import_module(f"portbench.modes.{mix['mode']}")


def quantile(values, q: float) -> float:
    """The q-quantile of all values, linear between order statistics."""
    return float(np.quantile(np.asarray(values, np.float64), q))


@dataclasses.dataclass
class Ctx:
    """One rank's run: the cell's files, the run's arguments, its device."""

    found: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    rank: int = 0
    world: int = 1
    t0: float = 0.0               # the run's start, time.time()
    fault: str | None = None      # a planted fault (the faults test), else None

    @property
    def spec(self):
        return self.found["spec"]

    @property
    def mix(self):
        return self.found["mix"]

    @property
    def on_card(self) -> bool:
        return getattr(self.device, "type", str(self.device)) == "cuda"

    def sync(self) -> None:
        import torch
        if self.on_card:
            torch.cuda.synchronize(self.device)

    def fault_wrap(self, fn, opt=None):
        if self.fault is None:
            return fn
        from portbench import faults
        return faults.plant(self.fault, fn, self.spec, opt)


class Tracer:
    """Traces the window's first ``n`` calls: torch.profiler over CPU and
    CUDA inside one annotation, CUDA events at the step's stage marks, and
    the kernel launches' inputs for their byte counts."""

    NAME = "portbench.window"

    def __init__(self, ctx: Ctx, n: int):
        self.ctx, self.n = ctx, n
        self.active = False
        self.steps, self.marks, self.inputs = 0, [], {}
        self._stack = None
        self._step = []

    def before(self, i: int) -> None:
        import contextlib

        import torch
        from portbench import port
        if i == 0:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.ctx.on_card:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._stack = contextlib.ExitStack()
            self.prof = self._stack.enter_context(torch.profiler.profile(activities=acts))
            self._stack.enter_context(torch.profiler.record_function(self.NAME))
            self._stack.enter_context(port.kernel_inputs(self.inputs))
            self._launched = dict(port.LAUNCHES)
            self.active = True
        if self.active:
            self._step = []
            self.mark("start")

    def mark(self, name: str) -> None:
        import torch
        if self.ctx.on_card:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._step.append((name, ev))

    def after(self, i: int) -> None:
        if not self.active:
            return
        self.marks.append(self._step)
        self.steps += 1
        if self.steps == self.n:
            self.close()

    def close(self) -> None:
        """Stop tracing; ``launches`` holds the port's own count of each
        kernel's launches over the traced calls (a sanity count)."""
        if self.active:
            from portbench import port
            self.ctx.sync()
            self._stack.close()
            self.launches = {k: v - self._launched.get(k, 0) for k, v in port.LAUNCHES.items()}
            self.active = False

    def stage_ms(self) -> dict:
        """Mean ms between each mark and the one before it, over the traced
        steps that made marks past the start."""
        out: dict = {}
        steps = [s for s in self.marks if len(s) > 1]
        for s in steps:
            for (_, a), (name, b) in zip(s, s[1:]):
                out[name] = out.get(name, 0.0) + a.elapsed_time(b) / len(steps)
        return out


def digest(prof, name: str = Tracer.NAME) -> dict:
    """The traced window from a profile: its length, the seconds in which
    any device operation ran, each device operation's (name, seconds), the
    ten longest in total, and the longest idle gaps by the host operation
    running at their start."""
    import torch
    events = list(prof.profiler.kineto_results.events())
    cuda = torch.autograd.DeviceType.CUDA
    win = [e for e in events if e.name() == name and e.device_type() != cuda]
    lo = min(e.start_ns() for e in win)
    hi = max(e.start_ns() + e.duration_ns() for e in win)
    dev, host = [], []
    for e in events:
        s, t = e.start_ns(), e.start_ns() + e.duration_ns()
        if t <= lo or s >= hi or e.name() == name:
            continue
        (dev if e.device_type() == cuda else host).append((e.name(), max(s, lo), min(t, hi)))
    busy, gaps, cur = 0, [], None
    for _, s, t in sorted(dev, key=lambda x: x[1]):
        if cur is None or s > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
                gaps.append((cur[1], s))
            else:
                gaps.append((lo, s))
            cur = [s, t]
        else:
            cur[1] = max(cur[1], t)
    if cur is not None:
        busy += cur[1] - cur[0]
        gaps.append((cur[1], hi))
    totals: dict = {}
    for n, s, t in dev:
        totals[n] = totals.get(n, 0.0) + (t - s) / 1e9
    hs = np.array([h[1] for h in host], np.int64) if host else np.zeros(0, np.int64)
    he = np.array([h[2] for h in host], np.int64) if host else np.zeros(0, np.int64)
    by_host: dict = {}
    for s, t in sorted(gaps, key=lambda g: g[0] - g[1])[:200]:
        cover = np.nonzero((hs <= s) & (he > s))[0]
        what = host[cover[np.argmax(hs[cover])]][0] if len(cover) else "host: no operation"
        by_host[what] = by_host.get(what, 0.0) + (t - s) / 1e9
    top = sorted(totals.items(), key=lambda kv: -kv[1])[:10]
    return {"window_s": (hi - lo) / 1e9, "busy_s": busy / 1e9,
            "kernels": [(n, (t - s) / 1e9) for n, s, t in dev],
            "breakdown": {"device_ops": [[n[:160], v] for n, v in top],
                          "idle_gaps": [[n[:160], v] for n, v in
                                        sorted(by_host.items(), key=lambda kv: -kv[1])[:10]]}}


def host_inputs(raw: dict) -> dict:
    """The recorded kernel inputs, on the host."""
    out = {}
    for k, calls in raw.items():
        conv = []
        for c in calls:
            conv.append(tuple(x.detach().cpu().numpy() if hasattr(x, "detach") else x for x in c))
        out[k] = conv
    return out


def run_rank(ctx: Ctx) -> dict:
    """One rank's run: set-up, the window, the traced per-layer numbers (with
    ``--trace 1``), the peak memory, then the check. Returns this rank's
    share of the result."""
    drv = mode(ctx.mix)
    st = drv.setup(ctx)
    ctx.sync()
    setup_end = time.time()
    win = drv.window(ctx, st)
    out = {"rank": ctx.rank, "setup_end": setup_end, "peak": win["peak"], "e2e": win["e2e"],
           "stats": win["stats"], "attempted": win.get("calls", win.get("steps")), "failed": 0}
    tracer = win.get("tracer")
    if tracer is not None:
        tracer.close()
        out["trace"] = per_layer_raw(ctx, win, tracer)
        out["stats"]["traced_launches"] = tracer.launches
    out["checks"] = drv.check(ctx, st, win)
    out["modules"] = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    return out


def per_layer_raw(ctx: Ctx, win: dict, tracer: Tracer) -> dict:
    """This rank's value of each per-layer metric of the cell (None where
    its reader finds nothing), and the trace's busy time and window."""
    from portbench.counts import flops
    d = digest(tracer.prof)
    train = ctx.mix["mode"] == "train"
    t = {"mode": ctx.mix["mode"], "chips": ctx.world, "spec": ctx.spec, "mix": ctx.mix,
         "images_per_step": ctx.mix["batch"] // ctx.world, "traced_steps": tracer.steps,
         "window_s": d["window_s"], "busy_s": d["busy_s"], "kernels": d["kernels"],
         "enqueue_s": win["enq"], "marks_ms": tracer.stage_ms(),
         "inputs": host_inputs(tracer.inputs),
         "flops_per_image": flops.per_image(
             ctx.spec, train, ctx.spec["num_rois"] if train else ctx.spec["infer_post_nms"])}
    values = {m["name"]: reader(m["name"], ctx.found["root"]).read(t)
              for m in ctx.found["per_layer"]}
    return {"values": values, "busy_s": d["busy_s"], "window_s": d["window_s"],
            "breakdown": d["breakdown"]}


def combine(found: dict, ranks: list) -> dict:
    """Every rank's numbers into the run's: per-layer values by each
    reader's ``COMBINE`` rule (``max``: the worst rank's; ``mean``)."""
    out = {}
    for m in found["per_layer"]:
        vals = [r["trace"]["values"][m["name"]] for r in ranks]
        vals = [v for v in vals if v is not None]
        if not vals:
            continue
        rule = getattr(reader(m["name"], found["root"]), "COMBINE", "max")
        out[m["name"]] = max(vals) if rule == "max" else sum(vals) / len(vals)
    return out


def verdict(limits: dict, checks: list) -> tuple:
    """(correct, each compared number, the worst rank's, beside its limit)
    from every rank's checks: correct where each is finite and within."""
    out = {name: {"value": max(c[name] for c in checks), "limit": limit}
           for name, limit in limits.items()}
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in out.values()), out


def result(found: dict, ranks: list, t0: float, trace: bool, device: dict) -> tuple:
    """(the result line's object, the checks' lines for standard error, the
    forbidden modules any rank loaded)."""
    r0 = ranks[0]
    correct, checks = verdict(found["limits"], [r["checks"] for r in ranks])
    bad = sorted({m for r in ranks for m in r["modules"]})
    if trace:
        units = {m["name"]: m["unit"] for m in found["per_layer"]}
        metrics = {k: {"value": v, "unit": units[k]} for k, v in combine(found, ranks).items()}
        device = dict(device,
                      busy_s=sum(r["trace"]["busy_s"] for r in ranks) / len(ranks),
                      window_s=max(r["trace"]["window_s"] for r in ranks))
    else:
        e2e = dict(r0["e2e"])
        e2e["peak_mem_gb"] = max(r["peak"] for r in ranks) / 1e9
        e2e["setup_s"] = max(r["setup_end"] for r in ranks) - t0
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in found["end_to_end"]}
    out = {"correct": correct, "attempted": r0["attempted"], "failed": r0["failed"],
           "metrics": metrics, "device": dict(device, memory_peak_bytes=max(r["peak"]
                                                                          for r in ranks))}
    if trace:
        worst = max(ranks, key=lambda r: r["trace"]["window_s"] - r["trace"]["busy_s"])
        out["breakdown"] = worst["trace"]["breakdown"]
    out["checks"] = checks
    lines = [f"check {k}: {c['value']!r} (limit {c['limit']!r})" for k, c in checks.items()]
    return out, lines, bad


def env_for_caches(root: Path) -> None:
    """Every build and kernel cache at a fixed place inside the checkout."""
    cache = root / ".portbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ.setdefault("USE_FLAX", "0")


def spawned(rank: int, world: int, found: dict, args: dict, store: str, out_dir: str,
            backend: str) -> None:
    """One rank of a multi-chip cell, in its own process: its card, the
    process group over a file store, the port's kernels built by rank 0
    first, then its run; its share written to ``out_dir/rank<r>.json``."""
    import torch
    import torch.distributed as dist
    os.environ["LOCAL_RANK"] = str(rank)
    if backend == "nccl":
        torch.cuda.set_device(rank)
        device = torch.device("cuda", rank)
    else:
        device = torch.device("cpu")
    dist.init_process_group(backend, store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        if backend == "nccl":
            from faster_rcnn_tpu_torch.parallel import multihost
            multihost.build_kernels_once()
        ctx = Ctx(found, args["seed"], args["seconds"], args["trace"], device, rank, world,
                  args["t0"], args.get("fault"))
        share = run_rank(ctx)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(share, f, default=float)
    finally:
        dist.destroy_process_group()


def run_ranks(found: dict, args: dict, world: int, backend: str) -> list:
    """Every rank's share of a multi-chip run, one process a rank; the
    store and the shares in a fresh directory under TMPDIR, removed after."""
    import shutil
    import tempfile

    import torch.multiprocessing as mp
    tmp = tempfile.mkdtemp(prefix="portbench_")
    try:
        mp.spawn(spawned, args=(world, found, args, os.path.join(tmp, "store"), tmp, backend),
                 nprocs=world, join=True)
        return [load_json(Path(tmp) / f"rank{r}.json") for r in range(world)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
