"""Training orchestration: the 4-step alternating scheme in one module.

Counterpart of faster_rcnn_tpu/train/trainer.py:

  step 1  RPN: backbone + RPN head from a fresh model, low blocks frozen;
  step 2  a fresh detector (own backbone + head) on step 1's frozen RPN;
  step 3  RPN again: step 2's backbone, all frozen; a fresh RPN head;
  step 4  detector head only: step 3's backbone and RPN head, on step 3's
          frozen RPN.

Weights move between steps as state dicts, merged by top-level module
(:func:`merge_params`). :func:`train_one_step` runs one step (or the joint
step) from the host loader (data/pipeline.TrainLoader) with checkpoints,
auto-resume and a checkpoint on SIGTERM/SIGINT (train/device_cache.py's
``train_cached`` runs a step from the device-resident dataset with the same
setup, checkpoints and signals); :func:`run_four_step_training` chains the
steps. As in the JAX package, iteration counts are in batches,
and the learning-rate phases are a function of the optimizer's count.

``multihost=True`` trains data-parallel, one process per card under
``torchrun`` (parallel/multihost.py): each process loads its share of the
records at the local batch size and steps on its rows of each global
batch's draws, the gradients and metrics are reduced over the processes,
rank 0 logs and writes the checkpoints, and every process meets the others
after each write, so that what any of them reads next is on disk.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import time
from typing import Callable, Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from faster_rcnn_tpu_torch import resolve_device
from faster_rcnn_tpu_torch.config import FasterRcnnConfig
from faster_rcnn_tpu_torch.data.pipeline import TrainLoader
from faster_rcnn_tpu_torch.data.voc import ImageRecord
from faster_rcnn_tpu_torch.models.detector import FasterRCNN, init_model
from faster_rcnn_tpu_torch.parallel import mesh as mesh_lib
from faster_rcnn_tpu_torch.parallel import multihost as mh
from faster_rcnn_tpu_torch.parallel.freeze import make_optimizer
from faster_rcnn_tpu_torch.train import pipeline
from faster_rcnn_tpu_torch.train.schedule import schedule_from_phases, total_iterations
from faster_rcnn_tpu_torch.utils import checkpoint as ckpt_lib

ALL_BLOCKS = {"vgg16": (1, 2, 3, 4, 5), "resnet50": (1, 2, 3, 4), "resnet101": (1, 2, 3, 4)}


def step_freeze_spec(step, cfg: FasterRcnnConfig):
    """(freeze_blocks, freeze_modules) of a training step: 1-4 or "joint"."""
    net = cfg.model.network
    if step == 1:
        return cfg.model.freeze_blocks, ("det_head",)
    if step == 2:
        return cfg.model.freeze_blocks, ("rpn_head",)
    if step == 3:  # whole backbone frozen (train_rpn_step3.py:60-81)
        return ALL_BLOCKS[net], ("det_head", "backbone")
    if step == 4:  # heads only
        return ALL_BLOCKS[net], ("backbone", "rpn_head")
    if step == "joint":  # everything trains together
        return cfg.model.freeze_blocks, ()
    raise ValueError(step)


def merge_params(dst: Dict[str, torch.Tensor], src: Dict[str, torch.Tensor],
                 top_keys: Sequence[str]) -> Dict[str, torch.Tensor]:
    """``dst`` with every entry of ``src`` under the top-level modules
    ``top_keys`` (e.g. "backbone": every ``backbone.*`` name) taken from
    ``src``. Both are state dicts of :class:`FasterRCNN`."""
    out = dict(dst)
    out.update({k: v for k, v in src.items() if k.split(".", 1)[0] in top_keys})
    return out


@dataclasses.dataclass
class TrainResult:
    """What a step hands on. ``params`` is the model's state dict: its
    parameters and buffers, the frozen batch-norm statistics among them.
    ``batch_stats`` is always ``{}``: the JAX package keeps those statistics
    in a collection of their own, which has no counterpart where they are
    buffers; the field stays so that callers read the same names."""

    params: Dict[str, torch.Tensor]
    batch_stats: Dict
    final_metrics: Dict[str, float]


def _model(cfg: FasterRcnnConfig, state: Optional[Dict[str, torch.Tensor]], seed: int,
           device: torch.device) -> FasterRCNN:
    """A model on ``device``: ``state`` loaded, or the seeded init."""
    if state is None:
        return init_model(seed, cfg, device)
    with torch.device(device):
        model = FasterRCNN(cfg)
    model.load_state_dict(state)
    return model.eval()


def _draws(cfg: FasterRcnnConfig, batch_size: int, generator: torch.Generator):
    """One iteration's sampler draws, from the step's generator."""
    return pipeline.draw_samples(cfg, batch_size, generator)


def data_parallel_mesh(multihost: bool, what: str, device: torch.device):
    """The data-parallel mesh of a ``multihost`` run (over the process
    group of parallel/multihost.maybe_initialize, which this calls), None
    for a run on one process. Refuses a single-process run under a
    multi-process launch."""
    if not multihost:
        mh.check_not_launched_alone(what)
        return None
    mh.maybe_initialize(require=True, device=device)
    return mesh_lib.create_mesh()


class _Transfer(NamedTuple):
    tensors: Dict[str, torch.Tensor]
    done: Optional[torch.cuda.Event]  # recorded on the copy stream


def _put(batch: Dict[str, np.ndarray], device: torch.device, stream) -> _Transfer:
    """Start a host batch's copy to ``device``: pinned, ``non_blocking``, on
    the side ``stream``. The pinned buffers need no keeping: PyTorch's
    caching host allocator, which ``pin_memory()`` draws from, records an
    event on the copy stream for a non-blocking copy and reuses the block
    only once the copy is done. On the CPU the arrays go through as
    tensors, and ``train/pipeline._batch_on`` copies nothing."""
    if device.type != "cuda":
        return _Transfer({k: torch.from_numpy(v) for k, v in batch.items()}, None)
    with torch.cuda.stream(stream):
        tensors = {k: torch.from_numpy(v).pin_memory().to(device, non_blocking=True)
                   for k, v in batch.items()}
        done = torch.cuda.Event()
        done.record(stream)
    return _Transfer(tensors, done)


def _take(transfer: _Transfer, device: torch.device) -> Dict[str, torch.Tensor]:
    """The batch's device tensors, for a step on the current stream: that
    stream waits for the copy, and the tensors (allocated on the copy
    stream) are marked as used by it, so that the caching allocator does not
    hand their memory to the copy stream again while the step reads them."""
    if transfer.done is not None:
        compute = torch.cuda.current_stream(device)
        compute.wait_event(transfer.done)
        for t in transfer.tensors.values():
            t.record_stream(compute)
    return transfer.tensors


def setup_step(step, cfg: FasterRcnnConfig, init_params, rpn_params, seed: int,
               device: torch.device, mesh=None):
    """What a training step runs: (the model, ``init_params`` loaded or the
    seeded init; the step's freeze-aware optimizer; ``step_fn_for(canvas)
    -> (step function, config)``, one of each per canvas, the
    landscape/portrait buckets). Steps 2 and 4 run the frozen RPN of
    ``rpn_params``. On a ``mesh`` the step functions are data-parallel."""
    is_rpn_step = step in (1, 3) or step == "joint"
    if not is_rpn_step and rpn_params is None:
        raise ValueError(f"step {step} needs the frozen RPN's rpn_params")
    model = _model(cfg, init_params, seed, device)
    freeze_blocks, freeze_modules = step_freeze_spec(step, cfg)
    opt = make_optimizer(
        model, cfg.model.network, freeze_blocks, schedule_from_phases(cfg.train.phases),
        optimizer=cfg.train.optimizer, momentum=cfg.train.momentum,
        weight_decay=cfg.model.weight_decay, freeze_modules=freeze_modules,
        clip_grad_norm=cfg.train.clip_grad_norm, mesh=mesh)
    rpn_model = None if is_rpn_step else _model(cfg, rpn_params, seed, device).requires_grad_(False)

    step_fns: Dict = {}

    def step_fn_for(canvas):
        if canvas not in step_fns:
            cfg_c = cfg.replace(
                data=dataclasses.replace(cfg.data, canvas_h=canvas[0], canvas_w=canvas[1]))
            fkw = dict(freeze_blocks=freeze_blocks, freeze_modules=freeze_modules, device=device)
            if step == "joint":
                fn = pipeline.make_joint_train_step(cfg_c, model, opt, **fkw)
            elif is_rpn_step:
                fn = pipeline.make_rpn_train_step(cfg_c, model, opt, **fkw)
            else:
                fn = pipeline.make_det_train_step(cfg_c, model, opt, rpn_model,
                                                  heads_only=step == 4, **fkw)
            step_fns[canvas] = (fn, cfg_c)
        return step_fns[canvas]

    return model, opt, step_fn_for


def save_state(ckpt_dir: str, n: int, model: FasterRCNN, opt, mesh=None,
               meet: bool = True) -> None:
    """The checkpoint of iteration ``n``: the model's and the optimizer's
    state dicts and the count (``cli.detect`` and the handoff read
    ``model``). In a data-parallel run (``mesh``) rank 0 writes it (every
    rank holds the same state) and, with ``meet``, all ranks wait for the
    write. A mesh that splits VGG16's fc head is refused: rank 0 holds only
    its shards of the head and of their optimizer state, and no training
    entry point splits it (parallel/sharding.py)."""
    if mesh is not None and mesh.model > 1:
        raise ValueError(f"save_state on a {mesh.data}x{mesh.model} mesh: a checkpoint of "
                         "a split fc head would hold one rank's shards")
    if mesh is None or mh.rank() == 0:
        ckpt_lib.save(ckpt_dir, n, {"model": model.state_dict(),
                                    "optimizer": opt.state_dict(), "count": n}, wait=True)
    if mesh is not None and meet:
        mh.barrier()


def restore_state(ckpt_dir: str, model: FasterRCNN, opt) -> int:
    """Load the latest checkpoint in ``ckpt_dir`` into ``model`` and
    ``opt``; its iteration, or 0 when there is none."""
    start = ckpt_lib.latest_step(ckpt_dir)
    if start is None:
        return 0
    restored = ckpt_lib.restore(ckpt_dir, start)
    model.load_state_dict(restored["model"])
    opt.load_state_dict(restored["optimizer"])
    return start


class Preemption:
    """SIGTERM/SIGINT for a training run, as a context manager: the signal
    calls ``on_signal(signum)`` (which checkpoints) and raises
    ``SystemExit(128 + signum)``. One that arrives while the run is
    :meth:`busy` (a step or a save: the model is updated in place) is
    handled when :meth:`idle` says it has ended, with the state it leaves.
    Outside the main thread no handler can be set, and none is."""

    def __init__(self, on_signal: Callable[[int], None]):
        self.on_signal = on_signal
        self._busy, self._pending, self._prev = False, None, {}

    def __enter__(self) -> "Preemption":
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._prev[sig] = signal.signal(sig, self._handle)
            except ValueError:  # non-main thread
                pass
        return self

    def __exit__(self, *exc) -> None:
        for sig, h in self._prev.items():
            signal.signal(sig, h)

    def _handle(self, signum, frame) -> None:
        if self._busy:  # mid-step or mid-save: handled as it ends
            self._pending = signum
            return
        self.on_signal(signum)
        raise SystemExit(128 + signum)

    def busy(self) -> None:
        self._busy = True

    def idle(self) -> None:
        self._busy = False
        if self._pending is not None:
            self._handle(self._pending, None)


def train_one_step(
    step,
    cfg: FasterRcnnConfig,
    records: Sequence[ImageRecord],
    class_mapping: Dict[str, int],
    workdir: str,
    init_params: Optional[Dict[str, torch.Tensor]] = None,
    rpn_params: Optional[Dict[str, torch.Tensor]] = None,
    batch_size: Optional[int] = None,
    save_frequency: Optional[int] = None,
    log_every: int = 20,
    max_steps: Optional[int] = None,
    seed: int = 0,
    uint8_pipeline: bool = False,
    device=None,
    multihost: bool = False,
) -> TrainResult:
    """Run one of the 4 training steps (1-4, or "joint") to completion, with
    auto-resume (faster_rcnn_tpu's ``train_one_step``, trainer.py:77-287).

    ``init_params`` is the starting state dict (the handoff from earlier
    steps), the seeded init if None; ``rpn_params`` the frozen RPN's, for
    the proposals of steps 2 and 4. ``uint8_pipeline`` ships raw uint8 RGB
    canvases and preprocesses on the device (the CLI's default). Runs on
    CUDA unless ``device="cpu"``.

    Checkpoints (``<workdir>/step<step>/<iteration>/``) hold the model's and
    the optimizer's state dicts and the count, every ``save_frequency``
    iterations and at the last. A run that finds one resumes from the latest:
    the model, the optimizer's state and its count, hence the learning-rate
    schedule. The loader and the draws' generator start again from the
    beginning, as the JAX trainer restarts its loader and key, so a resumed
    run does not repeat an uninterrupted one's batches and draws. On SIGTERM
    or SIGINT the current state is checkpointed and ``SystemExit(128 +
    signum)`` raised; a signal that arrives while a step or a save runs (the
    model is updated in place) is handled as it ends, with the state it
    leaves.

    Each iteration's batch is copied to the device on a side stream while
    the step before runs, as the JAX trainer's one-batch lookahead.

    ``multihost=True``: data parallel over the processes of a ``torchrun``
    launch (the module docstring); ``batch_size`` is the global batch. A
    launch of several processes without it raises.
    """
    device = resolve_device(device)
    mesh = data_parallel_mesh(multihost, "train_one_step", device)
    batch_size = batch_size or cfg.train.batch_size
    save_frequency = save_frequency or cfg.train.save_frequency
    model, opt, step_fn_for = setup_step(step, cfg, init_params, rpn_params, seed, device, mesh)
    primary = mesh is None or mh.rank() == 0

    ckpt_dir = os.path.join(workdir, f"step{step}")  # "stepjoint" for joint mode
    start_iter = restore_state(ckpt_dir, model, opt)
    if mesh is not None:  # one set of weights, whatever each rank's init drew
        mesh_lib.replicated(mesh, model.state_dict())
    if start_iter and primary:
        print(f"[step {step}] resumed from iteration {start_iter} "
              f"(optimizer count {opt.count})")
    total = max_steps if max_steps is not None else total_iterations(cfg.train.phases)

    if mesh is not None:
        records = mh.shard_records_for_host(records)
    local_bs = batch_size if mesh is None else mh.local_batch_size(batch_size, mesh.data)
    loader = TrainLoader(records, class_mapping, cfg, local_bs, seed=seed,
                         uint8=uint8_pipeline)
    it = iter(loader)
    step_id = step if isinstance(step, int) else 5  # "joint"
    gen = torch.Generator(device=device).manual_seed(seed + 1000 * step_id)
    copy_stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    # Preemption safety: on SIGTERM/SIGINT checkpoint the current state
    # before exiting, so that auto-resume continues from here.
    current = {"iter": start_iter}

    def on_signal(signum):
        print(f"[step {step}] signal {signum}: checkpointing at iter {current['iter']}")
        # no meeting: the other processes may not be stopping
        save_state(ckpt_dir, current["iter"], model, opt, mesh, meet=False)

    metrics = {}
    t0 = time.time()
    with Preemption(on_signal) as guard:
        try:
            canvas, host_batch = next(it)
            pending = (canvas, _put(host_batch, device, copy_stream))
            for i in range(start_iter, total):
                canvas, transfer = pending
                fn, cfg_c = step_fn_for(canvas)
                batch = _take(transfer, device)
                guard.busy()
                draws = (_draws(cfg_c, batch_size, gen) if mesh is None
                         else mh.global_draws(cfg_c, batch_size, gen, mesh))
                metrics = fn(batch, draws)
                current["iter"] = i + 1
                guard.idle()
                # the next batch's copy rides under this step's kernels
                nxt_canvas, nxt_host = next(it)
                pending = (nxt_canvas, _put(nxt_host, device, copy_stream))

                if (i + 1) % log_every == 0 and primary:
                    m = {k: float(v) for k, v in metrics.items()}
                    rate = (i + 1 - start_iter) * batch_size / (time.time() - t0)
                    print(f"[step {step}] iter {i+1}/{total} {m} ({rate:.2f} img/s)")
                    os.makedirs(ckpt_dir, exist_ok=True)
                    with open(os.path.join(ckpt_dir, "metrics.jsonl"), "a") as f:
                        f.write(json.dumps({"iter": i + 1, "img_per_sec": round(rate, 2), **m})
                                + "\n")
                if (i + 1) % save_frequency == 0 or (i + 1) == total:
                    guard.busy()
                    save_state(ckpt_dir, i + 1, model, opt, mesh)
                    guard.idle()
        finally:
            it.close()  # stop the loader's prefetch workers (they'd leak otherwise)
    return TrainResult(params=model.state_dict(), batch_stats={},
                       final_metrics={k: float(v) for k, v in metrics.items()})


def run_four_step_training(
    cfg: FasterRcnnConfig,
    records: Sequence[ImageRecord],
    class_mapping: Dict[str, int],
    workdir: str,
    steps: Sequence = (1, 2, 3, 4),
    use_device_cache: bool = False,
    **kw,
) -> Dict:
    """Drive steps 1..4 (or "joint") with the reference's weight handoff
    (trainer.py:290-354); ``kw`` goes to :func:`train_one_step`. A step that
    is not run here hands over its latest checkpoint.

    ``use_device_cache=True`` runs each step through
    ``train/device_cache.train_cached`` instead of the host loader: the
    records must then be unflipped (flips run on the device), and the
    loader's options (``uint8_pipeline``, ``log_every``, ``max_steps``) are
    rejected rather than ignored."""
    if use_device_cache:
        from faster_rcnn_tpu_torch.train.device_cache import train_cached

        bad = [k for k in ("uint8_pipeline", "log_every", "max_steps") if kw.get(k)]
        if bad:
            raise ValueError(f"device-cache training does not support: {bad}")
        kw = {k: v for k, v in kw.items() if k in ("batch_size", "save_frequency", "seed",
                                                   "devices", "chunk_steps", "device",
                                                   "multihost")}
        train_fn = train_cached
    else:
        train_fn = train_one_step
    resolve_device(kw.get("device"))  # no card: raise before any work
    meet = bool(kw.get("multihost"))
    results: Dict = {}
    fresh = init_model(cfg.train.seed, cfg, "cpu").state_dict()

    step1 = step2 = step3 = None
    for s in steps:
        if s == "joint":
            r = train_fn("joint", cfg, records, class_mapping, workdir, **kw)
        elif s == 1:
            r = train_fn(1, cfg, records, class_mapping, workdir, **kw)
            step1 = r.params
        elif s == 2:
            rpn = step1 if step1 is not None else _load_step_params(workdir, 1, meet)
            r = train_fn(2, cfg, records, class_mapping, workdir,
                         init_params=fresh, rpn_params=rpn, **kw)
            step2 = r.params
        elif s == 3:
            det2 = step2 if step2 is not None else _load_step_params(workdir, 2, meet)
            # backbone from step 2, rpn head fresh (train_rpn_step3.py:92-93)
            init = merge_params(fresh, det2, ["backbone"])
            r = train_fn(3, cfg, records, class_mapping, workdir, init_params=init, **kw)
            step3 = r.params
        elif s == 4:
            rpn3 = step3 if step3 is not None else _load_step_params(workdir, 3, meet)
            init = merge_params(fresh, rpn3, ["backbone", "rpn_head"])
            r = train_fn(4, cfg, records, class_mapping, workdir,
                         init_params=init, rpn_params=rpn3, **kw)
        else:
            raise ValueError(s)
        results[s] = r
    return results


def _load_step_params(workdir: str, step, meet: bool = False) -> Dict[str, torch.Tensor]:
    """A step's latest checkpointed model state dict, on the CPU (the
    handoff, and the detect CLI's weights). In a multi-process run
    (``meet``) every rank reads the file rank 0 wrote: all of them first
    meet, so that no rank reads before an earlier step's write has ended."""
    if meet:
        mh.barrier()
    return ckpt_lib.restore(os.path.join(workdir, f"step{step}"))["model"]
