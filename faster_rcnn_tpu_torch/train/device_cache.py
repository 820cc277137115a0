"""Device-resident dataset and chunked multi-step training.

Counterpart of faster_rcnn_tpu/train/device_cache.py. The whole dataset
lives on the device as raw uint8 canvases, one tensor per orientation
bucket, and training runs in chunks of K steps:

    batch  = gather(images, idx)            # on the device, no host copy
    batch  = hflip(batch) where flip bit    # on-device flip augmentation
    ...the unmodified step function of train/pipeline.py...

Per chunk the host sends a (K, B) int32 index tensor and a (K, B) flip
tensor, and reads the chunk's metrics back once. PyTorch has no
``lax.scan``: a chunk is a Python loop over the step function, with no host
synchronisation inside it, so the host enqueues the K steps while the card
runs them.

Augmentation: the reference's per-record flip doubling (args_util.py:24-26)
becomes a per-sample flip bit. Pixels mirror within the image's valid width
(the padding columns mirror within the padding), and boxes map x -> w - x
as ``GtBox.hflip`` does.

Data parallel (``multihost=True``, one process per card): as the JAX
package's replicated cache and batch-over-'data' scan, every process
builds the whole cache on its own card and walks the same plan, and
gathers only its own rows of each global batch, with its rows of the
global draws; the step reduces the gradients and metrics over the
processes, so a chunk equals the single-process chunk on the same plan.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from faster_rcnn_tpu_torch import resolve_device
from faster_rcnn_tpu_torch.config import FasterRcnnConfig
from faster_rcnn_tpu_torch.data.pipeline import canvas_for, prepare_example
from faster_rcnn_tpu_torch.data.voc import ImageRecord
from faster_rcnn_tpu_torch.parallel import mesh as mesh_lib
from faster_rcnn_tpu_torch.parallel import multihost as mh
from faster_rcnn_tpu_torch.train import pipeline
from faster_rcnn_tpu_torch.train import trainer
from faster_rcnn_tpu_torch.train.schedule import total_iterations

_FIELDS = ("images", "gt_boxes", "gt_class", "gt_valid", "img_hw")


@dataclasses.dataclass
class DeviceBucket:
    """One orientation bucket, wholly on the device."""

    canvas: Tuple[int, int]
    images: torch.Tensor    # (N, H, W, 3) uint8 RGB
    gt_boxes: torch.Tensor  # (N, G, 4) f32
    gt_class: torch.Tensor  # (N, G) i32
    gt_valid: torch.Tensor  # (N, G) bool
    img_hw: torch.Tensor    # (N, 2) i32

    @property
    def n(self) -> int:
        return int(self.images.shape[0])

    @property
    def nbytes(self) -> int:
        return sum(getattr(self, k).nbytes for k in _FIELDS)


def build_device_dataset(
    records: Sequence[ImageRecord],
    class_mapping: Dict[str, int],
    cfg: FasterRcnnConfig,
    upload_chunk: int = 64,
    device=None,
) -> Dict[Tuple[int, int], DeviceBucket]:
    """Decode and canvas-pad every record once (uint8) and upload it, per
    bucket, in chunks of ``upload_chunk`` records: each chunk is stacked in
    pinned host memory and copied without blocking. Runs on CUDA unless
    ``device="cpu"``.

    Records must be UNFLIPPED (flips happen on the device by the flip bit);
    flipped records are rejected to avoid double augmentation.
    """
    device = resolve_device(device)
    buckets: Dict[Tuple[int, int], List[ImageRecord]] = {}
    for r in records:
        if r.flipped:
            raise ValueError(
                "build_device_dataset expects unflipped records; use "
                "load_dataset(flip=False) — flip augmentation happens on device"
            )
        buckets.setdefault(canvas_for(r, cfg), []).append(r)

    def upload(parts: Dict[str, list]) -> Dict[str, torch.Tensor]:
        host = {k: torch.from_numpy(np.stack(v)) for k, v in parts.items()}
        if device.type == "cuda":
            return {k: v.pin_memory().to(device, non_blocking=True) for k, v in host.items()}
        return host

    out: Dict[Tuple[int, int], DeviceBucket] = {}
    for canvas, recs in buckets.items():
        parts: Dict[str, list] = {k: [] for k in _FIELDS}
        dev_chunks: List[Dict[str, torch.Tensor]] = []
        for i, r in enumerate(recs):
            ex = prepare_example(r, class_mapping, cfg, canvas, uint8=True)
            for k in _FIELDS:
                parts[k].append(ex["image" if k == "images" else k])
            if len(parts["images"]) == upload_chunk or i == len(recs) - 1:
                dev_chunks.append(upload(parts))
                parts = {k: [] for k in _FIELDS}
        out[canvas] = DeviceBucket(canvas=canvas, **{
            k: torch.cat([c[k] for c in dev_chunks]) for k in _FIELDS})
    return out


def _gather(images: torch.Tensor, ids: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """``out[b, y, x] = images[ids[b], y, cols[b, x]]``: one gather on the
    images' device."""
    rows = torch.arange(images.shape[1], device=images.device)
    return images[ids[:, None, None], rows[None, :, None], cols[:, None, :]]


def _flip_columns(w: torch.Tensor, flip: torch.Tensor, cw: int) -> torch.Tensor:
    """(B, cw) source column of each output column. A flipped sample of
    valid width ``w`` takes column ``w-1-j`` for ``j < w`` and ``cw-1-j+w``
    for ``j >= w``: JAX's mirror of the whole canvas rolled left by
    ``cw - w`` (device_cache.py:117). Unflipped samples keep ``j``."""
    j = torch.arange(cw, device=w.device)
    w = w.long()[:, None]
    mirrored = torch.where(j < w, w - 1 - j, cw - 1 - j + w)
    return torch.where(flip[:, None], mirrored, j)


def _flip_boxes(gt_boxes, gt_valid, w, flip) -> torch.Tensor:
    """x -> w - x on the valid boxes of flipped samples; the rest as given."""
    wf = w.float()[:, None]
    flipped = torch.stack([wf - gt_boxes[..., 2], gt_boxes[..., 1],
                           wf - gt_boxes[..., 0], gt_boxes[..., 3]], dim=-1)
    return torch.where((flip[:, None] & gt_valid)[..., None], flipped, gt_boxes)


def flip_batch(images, gt_boxes, gt_valid, img_hw, flip):
    """Mirror the flipped samples of a batch within their valid width:
    JAX's ``_flip_batch`` (device_cache.py:103-131), bit for bit. Returns
    (images, gt_boxes)."""
    b, w = images.shape[0], img_hw[:, 1]
    cols = _flip_columns(w, flip, images.shape[2])
    ids = torch.arange(b, device=images.device)
    return _gather(images, ids, cols), _flip_boxes(gt_boxes, gt_valid, w, flip)


def gather_batch(bucket: DeviceBucket, ids: torch.Tensor, flip: torch.Tensor) -> dict:
    """A step's batch from the bucket: records ``ids`` (B,), flipped where
    ``flip`` (B,) is set, gathered and flipped in one pass on the device."""
    hw = bucket.img_hw[ids]
    gt_valid = bucket.gt_valid[ids]
    cols = _flip_columns(hw[:, 1], flip, bucket.images.shape[2])
    return {"image": _gather(bucket.images, ids, cols),
            "gt_boxes": _flip_boxes(bucket.gt_boxes[ids], gt_valid, hw[:, 1], flip),
            "gt_class": bucket.gt_class[ids], "gt_valid": gt_valid, "img_hw": hw}


DrawSource = Union[torch.Generator, Sequence[pipeline.Draws]]


def make_scan_train_fn(step_fn: Callable) -> Callable:
    """Wrap a step function (the product of ``make_rpn_train_step``,
    ``make_det_train_step`` or ``make_joint_train_step``, called unmodified)
    into ``run(bucket, idx (K, B), flip (K, B), draws) -> metrics`` that
    runs the K steps of a chunk: each step's batch is gathered on the
    device, and its draws come from ``draws``, a generator drawn in order
    (through ``pipeline.draw_samples``) or a sequence of K
    ``pipeline.Draws``. The metrics come back stacked, (K,) tensors on the
    device; nothing in the loop waits for the card."""

    def run(bucket: DeviceBucket, idx: torch.Tensor, flip: torch.Tensor,
            draws: DrawSource) -> dict:
        steps = []
        for k in range(idx.shape[0]):
            batch = gather_batch(bucket, idx[k], flip[k])
            steps.append(step_fn(batch, draws if isinstance(draws, torch.Generator)
                                 else draws[k]))
        return {name: torch.stack([m[name] for m in steps]) for name in steps[0]}

    return run


def epoch_schedule(
    buckets: Dict[Tuple[int, int], DeviceBucket],
    total_steps: int,
    batch_size: int,
    seed: int,
    flip_augment: bool = True,
) -> List[Tuple[Tuple[int, int], np.ndarray, np.ndarray]]:
    """Host-side sampling plan: per-bucket (canvas, idx (K,B), flip (K,B)).

    Epochs shuffle the (record, flip) pairs of each bucket, mirroring the
    TrainLoader's continuous round-robin; steps are allocated to buckets
    proportionally to their size so every image is visited.
    """
    rng = np.random.RandomState(seed)
    sizes = {c: b.n * (2 if flip_augment else 1) for c, b in buckets.items()}
    total = sum(sizes.values())
    # Largest-remainder apportionment: per-bucket steps sum EXACTLY to
    # total_steps (int(round(...)) per bucket could drift by a few steps and
    # silently starve small buckets).  Every non-empty bucket gets >= 1 step
    # whenever total_steps >= number of buckets.
    canvases = list(buckets)
    quotas = np.array([total_steps * sizes[c] / total for c in canvases])
    alloc = np.floor(quotas).astype(int)
    if total_steps >= len(canvases):
        alloc = np.maximum(alloc, 1)
    while alloc.sum() > total_steps:  # min-1 bump can overshoot; trim largest
        over = np.where(alloc > 1, alloc - quotas, -np.inf)  # keep the min-1 floor
        alloc[int(np.argmax(over))] -= 1
    remainder = quotas - alloc
    for _ in range(total_steps - int(alloc.sum())):
        j = int(np.argmax(remainder))
        alloc[j] += 1
        remainder[j] -= 1.0
    assert alloc.sum() == total_steps, (alloc, total_steps)
    plan: List[Tuple[Tuple[int, int], np.ndarray, np.ndarray]] = []
    for canvas, steps in zip(canvases, (int(a) for a in alloc)):
        b = buckets[canvas]
        if steps == 0:
            continue
        need = steps * batch_size
        pool: List[Tuple[int, int]] = []
        while len(pool) < need:
            pairs = [
                (i, f) for i in range(b.n)
                for f in ((0, 1) if flip_augment else (0,))
            ]
            order = rng.permutation(len(pairs))
            pool.extend(pairs[j] for j in order)
        arr = np.array(pool[:need], np.int32).reshape(steps, batch_size, 2)
        plan.append((canvas, arr[..., 0], arr[..., 1].astype(bool)))
    return plan


def chunk_generator(seed: int, step, chunk_idx: int, device) -> torch.Generator:
    """The draws' generator of one chunk, a pure function of (seed, step,
    chunk index): the counterpart of ``fold_in(PRNGKey(seed + 1000 * step),
    chunk_idx)`` (device_cache.py:357, :394), with "joint" as step 5. A
    resumed run replays the remaining chunks' draws."""
    base = seed + 1000 * (step if isinstance(step, int) else 5)
    return torch.Generator(device=device).manual_seed((base << 32) + chunk_idx)


def train_cached(
    step,
    cfg: FasterRcnnConfig,
    records: Sequence[ImageRecord],
    class_mapping: Dict[str, int],
    workdir: str,
    batch_size: Optional[int] = None,
    rpn_params: Optional[Dict[str, torch.Tensor]] = None,
    init_params: Optional[Dict[str, torch.Tensor]] = None,
    seed: int = 0,
    chunk_steps: int = 50,
    log_cb=print,
    devices=None,
    save_frequency: Optional[int] = None,
    device=None,
    multihost: bool = False,
) -> trainer.TrainResult:
    """Drive one training step (1..4 or "joint") from the device cache.

    The same model, optimizer, freeze spec, learning-rate schedule and
    ``rpn_params`` handoff as ``trainer.train_one_step``, and the same
    checkpoints in ``workdir/step{step}``, so ``cli.detect`` and the 4-step
    handoff read them unchanged:

      * checkpoints every ``save_frequency`` steps at chunk boundaries, at
        the end, and on SIGTERM/SIGINT (taken at the end of the chunk that
        is running);
      * auto-resume from the latest checkpoint: the sampling plan and each
        chunk's draws are pure functions of (seed, step, chunk index), so a
        resumed run replays the remaining schedule and ends in the state an
        uninterrupted one ends in;
      * buckets interleave chunk by chunk, so the learning-rate schedule
        advances as under the mixed-batch loader.

    Runs on CUDA unless ``device="cpu"``. ``devices`` (the JAX package's
    data-parallel mesh of one process's devices) may name one device: the
    port runs one process per card, and ``multihost=True`` trains
    data-parallel over the processes of a ``torchrun`` launch (the module
    docstring), ``batch_size`` being the global batch. A launch of several
    processes without it raises.
    """
    if devices is not None:
        devices = list(devices)
        if len(devices) > 1:
            raise ValueError(
                "train_cached takes one device a process: for data parallelism launch one "
                "process per card with torchrun and pass multihost=True")
        device = devices[0] if devices else device
    device = resolve_device(device)
    mesh = trainer.data_parallel_mesh(multihost, "train_cached", device)
    batch_size = batch_size or cfg.train.batch_size
    save_frequency = save_frequency or cfg.train.save_frequency
    model, opt, step_fn_for = trainer.setup_step(step, cfg, init_params, rpn_params, seed,
                                                 device, mesh)
    if mesh is not None:
        log_cb = log_cb if mh.rank() == 0 else (lambda *_: None)
        lb = mh.local_batch_size(batch_size, mesh.data)
        rows = slice(mesh.data_index * lb, (mesh.data_index + 1) * lb)

    buckets = build_device_dataset(records, class_mapping, cfg, device=device)
    total = total_iterations(cfg.train.phases)
    plan = epoch_schedule(buckets, total, batch_size, seed=seed + 17,
                          flip_augment=cfg.data.flip_augment)

    ckpt_dir = os.path.join(workdir, f"step{step}")
    start = trainer.restore_state(ckpt_dir, model, opt)
    if mesh is not None:  # one set of weights, whatever each rank's init drew
        mesh_lib.replicated(mesh, model.state_dict())
    if start:
        log_cb(f"[cached step {step}] resumed from iteration {start}")

    scan_fns: Dict = {}
    metrics: Dict[str, float] = {}
    current = {"iter": start, "saved": start}

    def save(n: int) -> None:
        trainer.save_state(ckpt_dir, n, model, opt, mesh)
        current["saved"] = n

    def on_signal(signum):
        if current["iter"] > current["saved"]:  # not already on disk
            log_cb(f"[cached step {step}] signal {signum}: checkpointing at "
                   f"iter {current['iter']}")
            # no meeting: the other processes may not be stopping
            trainer.save_state(ckpt_dir, current["iter"], model, opt, mesh, meet=False)

    done = chunk_idx = 0
    with trainer.Preemption(on_signal) as guard:
        # interleave buckets chunk by chunk, so the learning-rate schedule's
        # position advances roughly as under the mixed-batch loader
        cursors = [[canvas, idx, flip, 0] for canvas, idx, flip in plan]
        while any(c[3] < c[1].shape[0] for c in cursors):
            for c in cursors:
                canvas, idx, flip, pos = c
                if pos >= idx.shape[0]:
                    continue
                k = min(chunk_steps, idx.shape[0] - pos)
                gen = chunk_generator(seed, step, chunk_idx, device)
                chunk_idx += 1
                c[3] = pos + k
                done += k
                if done <= start:  # already covered by the restored checkpoint
                    continue
                if canvas not in scan_fns:
                    scan_fns[canvas] = make_scan_train_fn(step_fn_for(canvas)[0])
                t0 = time.perf_counter()
                guard.busy()
                ids, fl, draws = idx[pos:pos + k], flip[pos:pos + k], gen
                if mesh is not None:  # this rank's rows of each global batch and draws
                    cfg_c = step_fn_for(canvas)[1]
                    ids, fl = ids[:, rows], fl[:, rows]
                    draws = [mh.global_draws(cfg_c, batch_size, gen, mesh) for _ in range(k)]
                mstack = scan_fns[canvas](
                    buckets[canvas],
                    torch.from_numpy(np.ascontiguousarray(ids)).to(device, non_blocking=True),
                    torch.from_numpy(np.ascontiguousarray(fl)).to(device, non_blocking=True),
                    draws)
                # the chunk's one read of the card: every metric's last value
                last = torch.stack([v[-1].double() for v in mstack.values()]).tolist()
                current["iter"] = done
                guard.idle()
                metrics = dict(zip(mstack, last))
                rate = k * batch_size / (time.perf_counter() - t0)
                log_cb(f"[cached step {step}] {done}/{total} steps {metrics} "
                       f"({rate:.2f} img/s)")
                if done - current["saved"] >= save_frequency and done < total:
                    guard.busy()
                    save(done)
                    guard.idle()
        if done > current["saved"] or current["saved"] == 0:
            guard.busy()
            save(done)
            guard.idle()
    return trainer.TrainResult(params=model.state_dict(), batch_stats={},
                               final_metrics=metrics)

