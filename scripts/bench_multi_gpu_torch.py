#!/usr/bin/env python3
"""Time the port's multi-GPU paths against one card, in one call.

    python3 scripts/bench_multi_gpu_torch.py [--ranks N]

It starts one NCCL process per visible card (at most 4; ``--ranks`` fewer),
joined by a FileStore rendezvous in a temporary directory, and runs at
``kitti_config()`` (608x1504 canvases, seeded random weights):

  * the ResNet-50 joint step, data-parallel, at global B=16 (16/N a card)
    and at global B=64 (64/N a card);
  * VGG16's step 2 (the detector on a frozen RPN) at global B=16, with the
    fc head split over 2 cards when N is even (data N/2 x model 2);
  * batch-sharded ResNet-50 detection at B=16 and B=64;
  * ``train_cached``'s joint step, data-parallel, 8 steps a chunk, on 64
    KITTI-synthetic frames that every rank caches whole.

Before each, rank 0 runs the same work alone (the one-card rate: the same
global batch, weights and draws on one card) while the other ranks wait on
a gloo barrier, off their cards. Per run: images/s (host clock between two
synchronizes over the timed steps; the slowest rank's time), step ms, peak
memory per rank, the launches of every kernel per rank over the timed
steps, the host's own time in each call (until it returns, its kernels
enqueued), for the joint step the device's busy share over one more step
traced by ``torch.profiler``, and the losses of every step beside the
one-card run's on the same global batch and draws. First, a check in f32 (TF32 off) at 2 images a
card from bias-only RPN outputs: the data-parallel joint step against one
card's on the whole batch (chip_smoke's limits: losses within 1e-4,
parameters within 1e-3 of their largest change, 2e-2 in the RPN head), a
``train_cached`` chunk of one joint step, data-parallel, against one card's
on the same plan and draws (the same limits), and the sharded detect
against one card's (the same detections); the script fails if any
disagrees. Beside them, not checked, the floor of the cached comparison:
one card's chunk against itself run with cuDNN's default algorithms, and
for the 8 tensors furthest from one card's, their gap beside their floor.
The check turns TF32 off and cuDNN's deterministic algorithms on, and
puts both back as they were. Apart, the all-reduce of the joint step's
trainable f32 gradients alone: bytes, ms (CUDA events over 20 calls), and
bus bandwidth (bytes x 2(N-1)/N over the time). It prints the card's name
and power limit, one JSON line per run, and writes everything to
chiprun_out/bench_multi_gpu.json.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import (OUT_DIR, _agreement, _bias_only_rpn, _model,  # noqa: E402
                        _mp_init, _step_agreement, _train_once, device_busy, kitti_batch,
                        kitti_train_batch, vgg_kitti_config)
from faster_rcnn_tpu_torch import _build, inference  # noqa: E402
from faster_rcnn_tpu_torch.config import kitti_config  # noqa: E402
from faster_rcnn_tpu_torch.data import kitti_synth  # noqa: E402
from faster_rcnn_tpu_torch.data.voc import KITTI_CLASS_MAPPING, load_dataset  # noqa: E402
from faster_rcnn_tpu_torch.models.detector import FasterRCNN, init_model  # noqa: E402
from faster_rcnn_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from faster_rcnn_tpu_torch.parallel import multihost, sharding  # noqa: E402
from faster_rcnn_tpu_torch.parallel.freeze import make_optimizer, param_labels  # noqa: E402
from faster_rcnn_tpu_torch.train import device_cache, pipeline, trainer  # noqa: E402

MAX_RANKS = 4
CHECK_B = 2                          # images a card in the f32 check
WARMUP, TIMED = 2, 5
DETECT_TIMED = 3
CACHED_CHUNK, CACHED_CHUNKS = 8, 4   # the first chunk is the warm-up
CACHED_FRAMES = 64
ALLREDUCE_REPS = 20


class Ctx:
    """A rank's card, its data-parallel mesh, and a gloo group to wait on."""

    def __init__(self, rank: int, world: int, tmp: str):
        self.mesh, self.dev = _mp_init(rank, world, os.path.join(tmp, "store"))
        self.rank, self.world, self.tmp = rank, world, tmp
        model = 2 if world % 2 == 0 else 1
        self.tp_mesh = mesh_lib.create_mesh(data=world // model, model=model)
        self.cpu_group = dist.new_group(backend="gloo")

    def wait(self) -> None:
        """Every rank meets here, the waiting ones on the host."""
        dist.barrier(group=self.cpu_group)

    def one_card(self, fn):
        """``fn()`` on rank 0 alone, the others waiting; rank 0's result."""
        out = fn() if self.rank == 0 else None
        self.wait()
        return out


def timed(fn, warmup: int, n: int, trace: bool = False) -> dict:
    """``fn()`` ``warmup`` + ``n`` times; the last ``n`` timed on the host
    between two synchronizes, with the launches of each kernel and the peak
    memory over them, and the host's own time in each call (``host_ms``:
    until the call returns, its kernels enqueued); with ``trace``, one more
    call under ``torch.profiler`` and the device's busy share over it.
    Returns the results of every call as well."""
    results = [fn() for _ in range(warmup)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    host = []
    for _ in range(n):
        t1 = time.perf_counter()
        results.append(fn())
        host.append(time.perf_counter() - t1)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    out = {"sec": sec, "launches": dict(_build.LAUNCHES), "host_ms": 1e3 * sum(host) / n,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    if trace:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            results.append(fn())
            torch.cuda.synchronize()
        out["traced"] = device_busy(prof)
    out["results"] = results
    return out


def _metrics(results) -> list:
    return [{k: float(v) for k, v in m.items()} for m in results]


def joint(ctx: Ctx, b: int, mesh) -> dict:
    """The ResNet-50 joint step at global batch ``b``: data-parallel over
    ``mesh``, or on this card alone (``mesh`` None)."""
    cfg = kitti_config()
    model = init_model(0, cfg, ctx.dev)
    opt = make_optimizer(model, cfg.model.network, cfg.model.freeze_blocks, 1e-3, momentum=0.9,
                         clip_grad_norm=10.0, mesh=mesh)
    step = pipeline.make_joint_train_step(cfg, model, opt, device=ctx.dev)
    batch = kitti_train_batch(np.random.RandomState(0), b, cfg)
    if mesh is not None:
        mesh_lib.replicated(mesh, model.state_dict())
        batch = mesh_lib.shard_batch(mesh, batch)
    batch = {k: torch.as_tensor(v, device=ctx.dev) for k, v in batch.items()}
    gen = torch.Generator(device=ctx.dev).manual_seed(0)

    def draws():
        if mesh is None:
            return pipeline.draw_samples(cfg, b, gen)
        return multihost.global_draws(cfg, b, gen, mesh)

    out = timed(lambda: step(batch, draws()), WARMUP, TIMED, trace=True)
    out["metrics"] = _metrics(out.pop("results"))[:WARMUP + TIMED]
    out["trainable_f32_bytes"] = sum(p.numel() * p.element_size() for _, p, _ in opt.params)
    return out


def step2(ctx: Ctx, b: int, mesh) -> dict:
    """VGG16's step 2 at global batch ``b`` on the frozen RPN of another
    seed's weights: over ``mesh`` (its fc head split when the mesh has a
    model axis), or on this card alone."""
    cfg = vgg_kitti_config()
    model = init_model(0, cfg, ctx.dev)
    rpn = init_model(1, cfg, ctx.dev).requires_grad_(False)
    batch = kitti_train_batch(np.random.RandomState(2), b, cfg)
    if mesh is not None:
        mesh_lib.replicated(mesh, model.state_dict())
        mesh_lib.replicated(mesh, rpn.state_dict())
        if mesh.model > 1:
            sharding.shard_vgg_head(model, mesh)
        batch = mesh_lib.shard_batch(mesh, batch)
    fb, fm = trainer.step_freeze_spec(2, cfg)
    opt = make_optimizer(model, "vgg16", fb, 1e-3, momentum=0.9, freeze_modules=fm,
                         clip_grad_norm=10.0, mesh=mesh)
    step = pipeline.make_det_train_step(cfg, model, opt, rpn, freeze_blocks=fb,
                                        freeze_modules=fm, device=ctx.dev)
    batch = {k: torch.as_tensor(v, device=ctx.dev) for k, v in batch.items()}
    gen = torch.Generator(device=ctx.dev).manual_seed(3)

    def draws():
        if mesh is None:
            return pipeline.draw_samples(cfg, b, gen)
        return multihost.global_draws(cfg, b, gen, mesh)

    out = timed(lambda: step(batch, draws()), WARMUP, TIMED)
    out["metrics"] = _metrics(out.pop("results"))
    out["layout"] = [1, 1] if mesh is None else [mesh.data, mesh.model]
    return out


def detect(ctx: Ctx, b: int, mesh) -> dict:
    """ResNet-50 detection of a B=``b`` batch, sharded over ``mesh`` or on
    this card alone; the detections of the last call."""
    cfg = kitti_config()
    model = init_model(0, cfg, ctx.dev)
    fn = inference.make_detect_fn(cfg, model, ctx.dev, mesh=mesh)
    img, hw = kitti_batch(np.random.RandomState(1), b, cfg)
    images, img_hw = torch.tensor(img, device=ctx.dev), torch.tensor(hw, device=ctx.dev)
    out = timed(lambda: fn(images, img_hw), WARMUP, DETECT_TIMED)
    dets = out.pop("results")[-1]
    out["dets"] = [t.cpu() for t in dets]
    return out


def cached(ctx: Ctx, root: str, mesh) -> dict:
    """train_cached's joint step on the frames at ``root``, CACHED_CHUNKS
    chunks of CACHED_CHUNK steps at global B=16: each chunk's rate from
    the host clock at its end (its one read of the metrics)."""
    cfg = kitti_config()
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, phases=((CACHED_CHUNK * CACHED_CHUNKS, 1e-3),), batch_size=16,
        clip_grad_norm=10.0, save_frequency=10 ** 6))
    records = _records(root)
    stamps = []
    work = os.path.join(ctx.tmp, f"cached_{'dp' if mesh is not None else 'one'}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = device_cache.train_cached(
        "joint", cfg, records, KITTI_CLASS_MAPPING, work, chunk_steps=CACHED_CHUNK,
        log_cb=lambda msg: stamps.append((time.perf_counter(), msg)), device=ctx.dev,
        multihost=mesh is not None)
    total = time.perf_counter() - t0
    chunks = [t for t, msg in stamps if "steps {" in msg]
    rates = [CACHED_CHUNK * 16 / (b - a) for a, b in zip(chunks, chunks[1:])]
    return {"run_sec": total, "chunk_img_per_s": rates, "peak_gb":
            torch.cuda.max_memory_allocated() / 1e9, "final_metrics": res.final_metrics,
            "img_per_s": CACHED_CHUNK * 16 * (len(chunks) - 1) / (chunks[-1] - chunks[0])
            if ctx.rank == 0 else None}


def _records(root: str) -> list:
    records, _ = load_dataset([root], "train", flip=False, resize_min=600, resize_max=1500)
    return records


def f32_check(ctx: Ctx, root: str, mesh) -> dict:
    """One joint step, one detect call and one ``train_cached`` chunk of
    one joint step in f32 (TF32 off) at CHECK_B images a card, from
    bias-only RPN outputs (chip_smoke's whole-path checks): over ``mesh``,
    or on this card alone on the whole batch (the cached chunk: on the same
    plan and draws). cuDNN runs its deterministic algorithms: so one card
    repeats itself, and what differs is the data-parallel sum. On one card
    the chunk runs once more with cuDNN's default algorithms, whose sums
    run in other orders (``cached_default_algos``): how far that moves the
    parameters is the comparison's floor of rounding. Returns the step's
    and the chunks' (metrics, parameters, labels) and the detections. The
    flags are as before on return."""
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    base = kitti_config()
    cfg = base.replace(model=dataclasses.replace(base.model, compute_dtype="float32"))
    state = _bias_only_rpn(init_model(1, cfg, "cpu").state_dict(), cfg.anchors.num_anchors)
    b = CHECK_B * ctx.world
    rng = np.random.RandomState(5)
    batch = kitti_train_batch(rng, b, cfg)
    draws = pipeline.draw_samples(cfg, b, torch.Generator(device=ctx.dev).manual_seed(1))
    step = _train_once(cfg, state, ctx.dev, batch, draws, plain=False, mesh=mesh)
    img, hw = kitti_batch(rng, b, cfg)
    dets = inference.make_detect_fn(cfg, _model(cfg, state, ctx.dev), ctx.dev, mesh=mesh)(img, hw)
    ccfg = cfg.replace(train=dataclasses.replace(
        cfg.train, phases=((1, 1e-3),), batch_size=b, clip_grad_norm=10.0,
        save_frequency=10 ** 6))
    fb, fm = trainer.step_freeze_spec("joint", cfg)
    labels = param_labels(FasterRCNN(cfg), cfg.model.network, fb, fm)

    def cached(work: str) -> tuple:
        res = device_cache.train_cached(
            "joint", ccfg, _records(root), KITTI_CLASS_MAPPING, os.path.join(ctx.tmp, work),
            init_params=state, chunk_steps=1, log_cb=lambda *_: None, device=ctx.dev,
            multihost=mesh is not None)
        return res.final_metrics, {n: v.cpu() for n, v in res.params.items()}, labels

    out = {"state": state, "step": step, "dets": dets}
    if mesh is not None:
        out["cached"] = cached("cached_f32_dp")
    else:
        out["cached"] = cached("cached_f32_one")
        torch.backends.cudnn.deterministic = False
        out["cached_default_algos"] = cached("cached_f32_one_default_algos")
    (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.deterministic) = flags
    return out


def _ratios(before: dict, got: tuple, want: tuple) -> dict:
    """Per trainable tensor, max|got - want| over its largest change on the
    ``want`` side (``_step_agreement``'s measure)."""
    (_, gp, labels), (_, wp, _) = got, want
    out = {}
    for n, lab in labels.items():
        if lab == "train":
            delta = (wp[n] - before[n]).abs().max().item()
            err = (gp[n] - wp[n]).abs().max().item()
            out[n] = err / delta if delta > 0 else (0.0 if err == 0 else float("inf"))
    return out


def allreduce(ctx: Ctx, nbytes: int) -> dict:
    """The all-reduce of ``nbytes`` of f32 gradients over every rank, alone:
    ms a call from CUDA events, and the bus bandwidth."""
    buf = torch.ones(nbytes // 4, device=ctx.dev)
    for _ in range(3):
        dist.all_reduce(buf, group=ctx.mesh.data_group)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ALLREDUCE_REPS):
        dist.all_reduce(buf, group=ctx.mesh.data_group)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / ALLREDUCE_REPS
    n = ctx.world
    bus = nbytes * 2 * (n - 1) / n / (ms / 1e3) if n > 1 else None
    return {"bytes": nbytes, "ms": ms, "bus_GB_per_s": None if bus is None else bus / 1e9}


def _rank(rank: int, world: int, tmp: str, root: str) -> None:
    ctx = Ctx(rank, world, tmp)
    out = {}

    def pair(name, fn, *args):
        one = ctx.one_card(lambda: fn(ctx, *args, None))
        torch.cuda.empty_cache()
        many = fn(ctx, *args, ctx.tp_mesh if name == "step2_b16" else ctx.mesh)
        ctx.wait()
        torch.cuda.empty_cache()
        out[name] = {"one_card": one, "distributed": many}

    one = ctx.one_card(lambda: f32_check(ctx, root, None))
    many = f32_check(ctx, root, ctx.mesh)
    if rank == 0:  # the sharded detections are the whole batch's on every rank
        out["f32_check"] = {"train": _step_agreement(one["state"], many["step"], one["step"]),
                            "detect": _agreement(many["dets"], one["dets"]),
                            "cached": _step_agreement(one["state"], many["cached"],
                                                      one["cached"]),
                            "cached_floor": _step_agreement(
                                one["state"], one["cached_default_algos"], one["cached"])}
        gap = _ratios(one["state"], many["cached"], one["cached"])
        floor = _ratios(one["state"], one["cached_default_algos"], one["cached"])
        out["f32_check"]["cached_top"] = [(n, gap[n], floor[n]) for n in
                                          sorted(gap, key=gap.get, reverse=True)[:8]]
    del one, many
    ctx.wait()
    torch.cuda.empty_cache()
    pair("joint_b16", joint, 16)
    out["allreduce"] = allreduce(ctx, out["joint_b16"]["distributed"]["trainable_f32_bytes"])
    pair("joint_b64", joint, 64)
    pair("step2_b16", step2, 16)
    pair("detect_b16", detect, 16)
    pair("detect_b64", detect, 64)
    pair("cached_joint", cached, root)
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    ctx.wait()
    dist.destroy_process_group()


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-12)


def summarize(ranks: list, world: int) -> dict:
    """Per run: the one-card and distributed img/s (the slowest rank's
    time), their ratio, step ms, peak memory per rank, launches per rank,
    and the largest relative loss gap to the one-card run over the steps."""
    summary = {}
    for name in ranks[0]:
        if name == "allreduce":
            summary[name] = [r[name] for r in ranks]
            continue
        if name == "f32_check":
            c = ranks[0][name]
            summary[name] = {"train_ok": c["train"]["ok"],
                             "loss_rel_err": c["train"]["loss_rel_err"],
                             "worst_param_ratio": c["train"]["worst_param_ratio"],
                             "cached_ok": c["cached"]["ok"],
                             "cached_loss_rel_err": c["cached"]["loss_rel_err"],
                             "cached_worst_param_ratio": c["cached"]["worst_param_ratio"],
                             "cached_metrics": c["cached"]["metrics"],
                             "cached_floor_worst_param_ratio":
                                 c["cached_floor"]["worst_param_ratio"],
                             "cached_top_gap_and_floor": c["cached_top"],
                             "detect_valid_equal": c["detect"]["valid_a"] == c["detect"]["valid_b"],
                             "detect_close_frac": c["detect"]["close_frac"]}
            continue
        one = ranks[0][name]["one_card"]
        many = [r[name]["distributed"] for r in ranks]
        if name == "cached_joint":
            rate_one, rate = one["img_per_s"], many[0]["img_per_s"]
            entry = {"chunk_img_per_s_one_card": one["chunk_img_per_s"],
                     "chunk_img_per_s": many[0]["chunk_img_per_s"],
                     "final_metrics_one_card": one["final_metrics"],
                     "final_metrics": many[0]["final_metrics"],
                     "loss_rel_gap": max(_rel(many[0]["final_metrics"][k], v)
                                         for k, v in one["final_metrics"].items()
                                         if k != "num_valid_images")}
        else:
            b = int(name.split("_b")[1])
            n = DETECT_TIMED if name.startswith("detect") else TIMED
            rate_one = b * n / one["sec"]
            rate = b * n / max(m["sec"] for m in many)
            entry = {"step_ms_one_card": one["sec"] / n * 1e3,
                     "step_ms": max(m["sec"] for m in many) / n * 1e3,
                     "host_ms_one_card": one["host_ms"],
                     "host_ms_per_rank": [m["host_ms"] for m in many],
                     "launches_per_rank": [m["launches"] for m in many],
                     "launches_one_card": one["launches"]}
            if "metrics" in one:
                entry["loss_rel_gap_by_step"] = [
                    max(_rel(g[k], w[k]) for k in w if k != "num_valid_images")
                    for g, w in zip(many[0]["metrics"], one["metrics"])]
                entry["metrics_first_last"] = [many[0]["metrics"][0], many[0]["metrics"][-1]]
                entry["metrics_one_card_first_last"] = [one["metrics"][0], one["metrics"][-1]]
            if "traced" in one:
                entry["busy_one_card"] = one["traced"]["busy_share"]
                entry["busy_per_rank"] = [m["traced"]["busy_share"] for m in many]
            if "layout" in many[0]:
                entry["layout_data_model"] = many[0]["layout"]
            if "dets" in one:
                same = [bool(torch.equal(m["dets"][3], one["dets"][3])) and
                        bool(torch.equal(m["dets"][2], one["dets"][2])) for m in many]
                entry["valid_and_classes_equal_one_card"] = same
                entry["max_box_gap"] = max(
                    float((m["dets"][0] - one["dets"][0])[one["dets"][3]].abs().max())
                    if bool(one["dets"][3].any()) else 0.0 for m in many)
        entry.update(img_per_s_one_card=rate_one, img_per_s=rate,
                     ratio=rate / rate_one if rate_one else None,
                     peak_gb_per_rank=[m["peak_gb"] for m in many],
                     peak_gb_one_card=one["peak_gb"])
        summary[name] = entry
    return summary


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ranks", type=int, default=None)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("bench_multi_gpu_torch: no CUDA device", file=sys.stderr)
        return 2
    world = min(MAX_RANKS, torch.cuda.device_count(), args.ranks or MAX_RANKS)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()
    print("\n".join(smi), flush=True)
    _build.build()  # once, before the ranks start
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "kitti")
        kitti_synth.build_kitti_synth_dataset(root, KITTI_CLASS_MAPPING, n_train=CACHED_FRAMES,
                                              n_val=0)
        torch.multiprocessing.start_processes(_rank, args=(world, tmp, root), nprocs=world,
                                              join=True, start_method="spawn")
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                 for r in range(world)]
    summary = summarize(ranks, world)
    for name, entry in summary.items():
        print(json.dumps({"run": name, "world": world, **(
            entry if isinstance(entry, dict) else {"ranks": entry})}), flush=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "bench_multi_gpu.json"), "w") as f:
        json.dump({"cards": smi, "world": world, "seconds": time.perf_counter() - t0,
                   "summary": summary,
                   "ranks": [{k: {kk: (vv if kk != "distributed" else
                                       {a: b for a, b in vv.items() if a != "dets"})
                                  for kk, vv in v.items()} if isinstance(v, dict) and
                              "one_card" in v else v for k, v in r.items()}
                             for r in ranks]}, f, indent=1, default=str)
    print(json.dumps({"world": world, "seconds": time.perf_counter() - t0,
                      "card": smi[0]}), flush=True)
    check = summary["f32_check"]
    if not (check["train_ok"] and check["cached_ok"] and check["detect_valid_equal"]
            and check["detect_close_frac"] == 1.0):
        print(f"bench_multi_gpu_torch: the f32 check failed: {check}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
