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
one-card run's on the same global batch and draws. First, a check in f32
(TF32 off, cuDNN's deterministic algorithms, both put back as they were
after) at 2 images a card from bias-only RPN outputs: the data-parallel
joint step against one card's on the whole batch (chip_smoke's limits:
losses within 1e-4, parameters within 1e-3 of their largest change, 2e-2 in
the RPN head), the sharded detect against one card's (the same
detections), and a ``train_cached`` chunk of one joint step, data-parallel,
clipped at 10 and not clipped, against its split-batch reference: the same
chunk on card 0 alone with the batch cut into N shards of 2, in N processes
joined by gloo (split_reference), so that each shard's convolutions run at
the batch a rank sees. The chunk's updates before the parameters round
them (SGD's first trace, read from its checkpoint) are held at the same
limits; its parameters, element by element, within what the updates' gap
and the step's two f32 roundings allow; and, where it is not clipped, its
parameters within 1e-3 of their largest change. Clipped, the updates are
small enough beside the parameters that one rounding of a parameter
falling the other way can pass 1e-3 of a tensor's largest change, so
there its parameters' gaps print with that rounding quantum beside them.
The script fails if any disagrees. Beside the gate, not checked: the
chunk against one card's on the whole batch, the split reference against
that (the gap the split alone makes), and for the 8 tensors furthest from
the whole batch, the three gaps and the quantum side by side. Apart, the
all-reduce of the joint step's trainable f32 gradients alone: bytes, ms
(CUDA events over 20 calls), and bus bandwidth (bytes x 2(N-1)/N over the
time). It prints the card's name and power limit, one JSON line per run,
and writes everything to chiprun_out/bench_multi_gpu.json.
"""

from __future__ import annotations

import argparse
import contextlib
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
from faster_rcnn_tpu_torch.utils import checkpoint as ckpt_lib  # noqa: E402

MAX_RANKS = 4
CHECK_B = 2                          # images a card in the f32 check
CHECK_CLIPS = (10.0, 0.0)            # the cached chunk's clips there (0: none)
CHECK_LR = 1e-3                      # and its learning rate
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


@contextlib.contextmanager
def f32_flags():
    """TF32 off and cuDNN's deterministic algorithms on, so that one card
    repeats itself; the flags as before on exit."""
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic) = flags


def f32_config() -> tuple:
    """kitti_config() in f32 and its seeded weights with bias-only RPN
    outputs (chip_smoke's whole-path checks)."""
    base = kitti_config()
    cfg = base.replace(model=dataclasses.replace(base.model, compute_dtype="float32"))
    return cfg, _bias_only_rpn(init_model(1, cfg, "cpu").state_dict(), cfg.anchors.num_anchors)


def cached_f32(cfg, state, root: str, b: int, dev, work: str, clip: float,
               multihost: bool) -> tuple:
    """A ``train_cached`` chunk of one joint step at global batch ``b`` from
    ``state``, the gradient clipped at ``clip`` (0: not clipped):
    (metrics, parameters, labels, SGD's trace)."""
    ccfg = cfg.replace(train=dataclasses.replace(
        cfg.train, phases=((1, CHECK_LR),), batch_size=b, clip_grad_norm=clip,
        save_frequency=10 ** 6))
    fb, fm = trainer.step_freeze_spec("joint", cfg)
    labels = param_labels(FasterRCNN(cfg), cfg.model.network, fb, fm)
    res = device_cache.train_cached(
        "joint", ccfg, _records(root), KITTI_CLASS_MAPPING, work, init_params=state,
        chunk_steps=1, log_cb=lambda *_: None, device=dev, multihost=multihost)
    # SGD's trace after its first step is the averaged, clipped gradient:
    # the update before the parameters round it
    opt = ckpt_lib.restore(os.path.join(work, "stepjoint"))["optimizer"]
    trace = {n: st["trace"].cpu() for n, st in opt["state"].items()}
    return res.final_metrics, {n: v.cpu() for n, v in res.params.items()}, labels, trace


def f32_check(ctx: Ctx, root: str, mesh) -> dict:
    """One joint step, one detect call and one ``train_cached`` chunk of
    one joint step (clipped at 10 as the paths clip, and not clipped, as
    the joint step here) in f32 at CHECK_B images a card, from bias-only RPN
    outputs: over ``mesh``, or on this card alone on the whole batch (the
    cached chunk: on the same plan and draws), under f32_flags(). Returns
    the step's and the chunks' (metrics, parameters, labels) and the
    detections."""
    with f32_flags():
        cfg, state = f32_config()
        b = CHECK_B * ctx.world
        rng = np.random.RandomState(5)
        batch = kitti_train_batch(rng, b, cfg)
        draws = pipeline.draw_samples(cfg, b, torch.Generator(device=ctx.dev).manual_seed(1))
        step = _train_once(cfg, state, ctx.dev, batch, draws, plain=False, mesh=mesh)
        img, hw = kitti_batch(rng, b, cfg)
        dets = inference.make_detect_fn(cfg, _model(cfg, state, ctx.dev), ctx.dev,
                                        mesh=mesh)(img, hw)
        run = "one" if mesh is None else "dp"
        cached = {clip: cached_f32(cfg, state, root, b, ctx.dev,
                                   os.path.join(ctx.tmp, f"cached_f32_{run}_clip{clip:g}"), clip,
                                   mesh is not None) for clip in CHECK_CLIPS}
    return {"state": state, "step": step, "dets": dets, "cached": cached}


def _split_rank(rank: int, shards: int, tmp: str, root: str) -> None:
    torch.cuda.set_device(0)
    store = dist.FileStore(os.path.join(tmp, "split_store"), shards)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=shards)
    with f32_flags():
        cfg, state = f32_config()
        out = {clip: cached_f32(cfg, state, root, CHECK_B * shards, torch.device("cuda", 0),
                                os.path.join(tmp, f"cached_f32_split_clip{clip:g}"), clip, True)
               for clip in CHECK_CLIPS}
    if rank == 0:
        torch.save(out, os.path.join(tmp, "split.pt"))
    dist.barrier()
    dist.destroy_process_group()


def split_reference(root: str, shards: int, tmp: str) -> None:
    """The reference of the data-parallel cached chunk: the same chunk with
    its global batch cut into ``shards`` shards of CHECK_B images, on card 0
    alone. ``train_cached(multihost=True)`` runs unchanged in ``shards``
    processes on that card, joined by gloo (which all-reduces CUDA
    tensors), so each shard's convolutions run at the batch a rank of the
    N-card run sees, under the same algorithms, and the gradients are
    averaged as there; only the order of the sum over the shards differs.
    Writes {clip: (metrics, parameters, labels)} to ``tmp``/split.pt."""
    torch.multiprocessing.start_processes(_split_rank, args=(shards, tmp, root), nprocs=shards,
                                          join=True, start_method="spawn")


def _quantum(before: torch.Tensor, want: torch.Tensor) -> float:
    """One f32 unit in the last place of the tensor's largest parameter over
    its largest change: what one rounding of ``before`` plus an update,
    falling the other way, adds to ``_ratios``' measure at most."""
    _, exp = torch.frexp(want.abs().max())
    delta = (want - before).abs().max().item()
    return float(torch.ldexp(torch.ones(()), exp - 24)) / delta if delta else float("inf")


def _update_agreement(got: dict, want: dict, metrics_got: dict, metrics_want: dict) -> dict:
    """The first step's updates before rounding (SGD's traces), per tensor
    max|got - want| over max|want|: within 1e-3, 2e-2 in the RPN head, and
    the losses within 1e-4 (chip_smoke._step_agreement's limits)."""
    loss_err = max(abs(metrics_got[k] - w) / max(abs(w), 1e-12) for k, w in metrics_want.items())
    worst = {"rpn_head": (0.0, ""), "rest": (0.0, "")}
    for n, w in want.items():
        delta, err = w.abs().max().item(), (got[n] - w).abs().max().item()
        ratio = err / delta if delta > 0 else (0.0 if err == 0 else float("inf"))
        group = "rpn_head" if n.startswith("rpn_head.") else "rest"
        if ratio >= worst[group][0]:
            worst[group] = (ratio, n)
    ok = (loss_err <= 1e-4 and set(got) == set(want) and worst["rpn_head"][0] <= 2e-2
          and worst["rest"][0] <= 1e-3)
    return {"ok": ok, "loss_rel_err": loss_err, "worst_update_ratio": worst}


def _ulp(x: torch.Tensor) -> torch.Tensor:
    """The f32 spacing above |x|, element by element, as f64."""
    x = x.abs().float()
    return (torch.nextafter(x, torch.full_like(x, float("inf"))) - x).double()


def _rounding_agreement(got: tuple, want: tuple) -> dict:
    """The first SGD step sets p = fl(p0 + fl(-lr * trace)) (weight decay 0,
    the trace the clipped gradient): two roundings. So where two runs'
    traces differ by d, their parameters differ, element by element, by at
    most lr |d| + ulp(lr max|trace|) + ulp(max|p|), each ulp the f32
    spacing there. Per trainable tensor the largest of |got - want| over
    that bound: at most 1 if the parameters differ only as their traces do,
    element by element."""
    (_, gp, _, gt), (_, wp, _, wt) = got, want
    worst = (0.0, "")
    for n in wt:  # the trainable tensors
        t = torch.maximum(gt[n].abs(), wt[n].abs())
        bound = (CHECK_LR * (gt[n].double() - wt[n].double()).abs() + _ulp(CHECK_LR * t)
                 + _ulp(torch.maximum(gp[n].abs(), wp[n].abs())))
        ratio = ((gp[n].double() - wp[n].double()).abs() / bound).max().item()
        if ratio >= worst[0]:
            worst = (ratio, n)
    return {"ok": worst[0] <= 1.0 and set(gt) == set(wt), "worst_rounding_ratio": worst}


def f32_verdict(one: dict, many: dict, split: dict) -> dict:
    """The f32 check: the data-parallel joint step and detections against
    one card's on the whole batch; the data-parallel cached chunk against
    the split-batch reference, clipped and not (``cached_clip*``): its
    updates before rounding, its parameters element by element within
    what those updates' gap and two roundings allow (``rounding``), and
    its parameters within 1e-3 of their largest change (``params``; in the
    gate for the chunk that is not clipped). The clip at 10 shrinks the
    updates until one parameter's rounding falling the other way (a
    quantum) can exceed 1e-3 of a tensor's largest change, which the
    element-by-element bound allows for. Beside them, not checked, against
    one card's chunk on the whole batch, with the 8 tensors furthest from
    that one: (name, their gap, the split reference's gap to it, their gap
    to the split reference, their rounding quantum)."""
    before = one["state"]
    out = {"train": _step_agreement(before, many["step"], one["step"]),
           "detect": _agreement(many["dets"], one["dets"])}
    for clip in CHECK_CLIPS:
        got, whole, ref = many["cached"][clip], one["cached"][clip], split[clip]
        gap, floor, vs_split = (_ratios(before, got, whole), _ratios(before, ref, whole),
                                _ratios(before, got, ref))
        params = _step_agreement(before, got[:3], ref[:3])
        update = _update_agreement(got[3], ref[3], got[0], ref[0])
        rounding = _rounding_agreement(got, ref)
        ok = (update["ok"] and rounding["ok"] and not params["frozen_moved"]
              and (clip > 0 or params["ok"]))
        out[f"cached_clip{clip:g}"] = {
            "gate": dict(update, ok=ok), "rounding": rounding, "params": params,
            "whole_batch": _step_agreement(before, got[:3], whole[:3]),
            "split_vs_whole_batch": _step_agreement(before, ref[:3], whole[:3]),
            "worst_vs_split": (lambda n: (vs_split[n], n, _quantum(before[n], ref[1][n])))(
                max(vs_split, key=vs_split.get)),
            "top": [(n, gap[n], floor[n], vs_split[n], _quantum(before[n], whole[1][n]))
                    for n in sorted(gap, key=gap.get, reverse=True)[:8]]}
    return out


def _ratios(before: dict, got: tuple, want: tuple) -> dict:
    """Per trainable tensor, max|got - want| over its largest change on the
    ``want`` side (``_step_agreement``'s measure)."""
    (_, gp, labels), (_, wp, _) = got[:3], want[:3]
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
        split = torch.load(os.path.join(tmp, "split.pt"), weights_only=False)
        out["f32_check"] = f32_verdict(one, many, split)
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
                             "detect_valid_equal": c["detect"]["valid_a"] == c["detect"]["valid_b"],
                             "detect_close_frac": c["detect"]["close_frac"]}
            for clip in CHECK_CLIPS:
                k = f"cached_clip{clip:g}"
                summary[name][k] = {
                    "ok": c[k]["gate"]["ok"], "loss_rel_err": c[k]["gate"]["loss_rel_err"],
                    "worst_update_ratio": c[k]["gate"]["worst_update_ratio"],
                    "worst_rounding_ratio": c[k]["rounding"]["worst_rounding_ratio"],
                    "params_ok": c[k]["params"]["ok"],
                    "worst_param_ratio": c[k]["params"]["worst_param_ratio"],
                    "worst_vs_split_and_quantum": c[k]["worst_vs_split"],
                    "whole_batch_worst_param_ratio": c[k]["whole_batch"]["worst_param_ratio"],
                    "whole_batch_loss_rel_err": c[k]["whole_batch"]["loss_rel_err"],
                    "split_vs_whole_batch_worst_param_ratio":
                        c[k]["split_vs_whole_batch"]["worst_param_ratio"],
                    "metrics": c[k]["params"]["metrics"],
                    "top_gap_floor_vs_split_quantum": c[k]["top"]}
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
        split_reference(root, world, tmp)
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
    if not (check["train_ok"] and check["detect_valid_equal"] and check["detect_close_frac"] == 1.0
            and all(check[f"cached_clip{clip:g}"]["ok"] for clip in CHECK_CLIPS)):
        print(f"bench_multi_gpu_torch: the f32 check failed: {check}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
