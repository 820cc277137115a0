"""Multi-process training: one process per card, launched by ``torchrun``.

Counterpart of faster_rcnn_tpu/parallel/multihost.py. Where the JAX package
runs one controller per host over a global device mesh, the port runs one
process per card over ``torch.distributed``: NCCL between cards, ``gloo``
on the CPU. The recipe:

  * every process calls :func:`maybe_initialize` once, first (the train
    CLI's ``--multihost`` does so at the top of ``main``): it reads the
    ``torchrun`` environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR``, ``MASTER_PORT``), makes the local card current and
    joins the process group;
  * each process loads only its share of the dataset
    (:func:`shard_records_for_host`) at the local batch size
    (:func:`local_batch_size`);
  * every process draws the whole global batch's sampler draws from the
    same seeded generator and keeps its own rows (:func:`global_draws`), so
    which image gets which draws does not depend on the world size.

With ``require=False`` and no ``torchrun`` environment nothing is
initialized, which is how the single-process paths run.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from faster_rcnn_tpu_torch import _build, resolve_device
from faster_rcnn_tpu_torch.data import native_loader
from faster_rcnn_tpu_torch.train import pipeline

ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def is_initialized() -> bool:
    """True once this process has joined a process group."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def launched_world_size() -> int:
    """The world size the launcher set (``WORLD_SIZE``), 1 without one."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def check_not_launched_alone(what: str) -> None:
    """Raise when the process runs under a multi-process launcher but was
    asked for a single-process run: N independent trainers would each take
    the whole dataset and write the same checkpoints."""
    if launched_world_size() > 1 and not is_initialized():
        raise RuntimeError(
            f"{what}: WORLD_SIZE={launched_world_size()} says this process is one of a "
            "multi-process launch, but multihost is off; pass --multihost (multihost=True) "
            "so that the processes train together, or launch one process")


def maybe_initialize(require: bool = False, device=None) -> bool:
    """Join the process group the ``torchrun`` environment describes.

    Must run before any tensor is made on a card: with ``device`` CUDA (the
    default) it makes card ``LOCAL_RANK`` current, then initializes NCCL;
    with ``device="cpu"`` it initializes ``gloo``. Returns True when the
    process is in a process group (this call's, or one already made).

    ``require=True`` (the train CLI's ``--multihost``) raises on a missing
    or broken environment instead of degenerating to N independent
    single-process trainers. Without ``require`` and without ``WORLD_SIZE``
    it does nothing and returns False.
    """
    if is_initialized():
        _check_matches_environment()
        return True
    if "WORLD_SIZE" not in os.environ and not require:
        return False
    missing = [k for k in ENV if k not in os.environ]
    if missing:
        raise RuntimeError(
            f"multihost requested but the launcher's environment lacks {missing}: run "
            "under torchrun (torchrun --nproc_per_node N -m faster_rcnn_tpu_torch.cli.train "
            "--multihost ...), which sets RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and "
            "MASTER_PORT")
    try:
        r, world, local = (int(os.environ[k]) for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"))
    except ValueError as e:
        raise RuntimeError(
            f"multihost: RANK, WORLD_SIZE and LOCAL_RANK must be integers: {e}") from e
    if not 0 <= r < world:
        raise RuntimeError(f"multihost: RANK={r} is not in [0, WORLD_SIZE={world})")
    dev = resolve_device(device)
    if dev.type == "cuda":
        if local >= torch.cuda.device_count():
            raise RuntimeError(f"multihost: LOCAL_RANK={local} but this host has "
                               f"{torch.cuda.device_count()} CUDA devices")
        torch.cuda.set_device(local)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method="env://",
                            rank=r, world_size=world)
    if dev.type == "cuda":
        build_kernels_once()
    return True


def _check_matches_environment() -> None:
    for key, have in (("RANK", dist.get_rank()), ("WORLD_SIZE", dist.get_world_size())):
        if key in os.environ and int(os.environ[key]) != have:
            raise RuntimeError(f"the process group has {key.lower()} {have}, the "
                               f"environment {key}={os.environ[key]}")


def barrier() -> None:
    """All processes of the group meet here (nothing without a group)."""
    if not is_initialized():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def build_kernels_once() -> None:
    """Local rank 0 builds the CUDA kernels' library and the native image
    loader first; the others wait, then load what it built. Without this
    every process would run nvcc (and g++) at its first launch, all of them
    on the host's cores at once."""
    if local_rank() == 0:
        _build.build()
        native_loader.available()
    barrier()


def shard_records_for_host(records: Sequence, *, process_index: Optional[int] = None,
                           process_count: Optional[int] = None) -> list:
    """This process's share of the dataset: round-robin by index,
    ``records[rank::world]``."""
    pi = rank() if process_index is None else process_index
    pc = world_size() if process_count is None else process_count
    return list(records)[pi::pc]


def local_batch_size(global_batch_size: int, process_count: Optional[int] = None) -> int:
    """The batch each process trains on: the global batch over the world."""
    pc = world_size() if process_count is None else process_count
    if global_batch_size % pc:
        raise ValueError(
            f"global batch {global_batch_size} not divisible by process count {pc}")
    return global_batch_size // pc


def global_draws(cfg, global_batch_size: int, generator: torch.Generator, mesh):
    """One step's sampler draws for this process's rows of the global
    batch: every process draws the whole global batch's ``Draws`` from
    ``generator`` (seeded alike everywhere) and keeps rows ``[d*lb,
    (d+1)*lb)``, ``d`` its index along the data axis of ``mesh``. The
    counterpart of ``global_keys``."""
    d, n = mesh.data_index, mesh.data
    lb = local_batch_size(global_batch_size, n)
    draws = pipeline.draw_samples(cfg, global_batch_size, generator)
    return pipeline.Draws(*(t[d * lb:(d + 1) * lb].clone() for t in draws))
