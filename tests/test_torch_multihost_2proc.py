"""The port's multi-process training on the CPU: two ``gloo`` processes.

The counterpart of tests/test_multihost_2proc.py. Two processes, started
with ``torch.multiprocessing`` and joined by a ``file://`` rendezvous
under the test's temporary directory (no TCP port, which could collide
across the test workers), run ``cli.train --multihost`` on a tree of 8
images with identical pixels and boxes, so that the global batch does not
depend on how the records shard over the processes; the run must reproduce
the single-process run's metrics within reduction-order noise. Beside it,
the pure helpers of parallel/multihost.py and the refusals: a launch of
several processes without ``--multihost``, and ``--multihost`` without a
launch.

This module imports no JAX: its functions are also the bodies of the
processes that tests/test_torch_parallel.py starts (:func:`run_ranks`).
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from PIL import Image as PilImage

from faster_rcnn_tpu_torch.cli import train as ttrain
from faster_rcnn_tpu_torch.cli.common import config_from_args
from faster_rcnn_tpu_torch.config import FasterRcnnConfig
from faster_rcnn_tpu_torch.data.voc import VOC_CLASS_MAPPING, load_dataset
from faster_rcnn_tpu_torch.inference import make_detect_fn
from faster_rcnn_tpu_torch.models.detector import FasterRCNN
from faster_rcnn_tpu_torch.parallel import mesh as mesh_lib
from faster_rcnn_tpu_torch.parallel import multihost as mh
from faster_rcnn_tpu_torch.parallel import sharding
from faster_rcnn_tpu_torch.parallel.freeze import make_optimizer
from faster_rcnn_tpu_torch.train import device_cache, pipeline, trainer
from faster_rcnn_tpu_torch.utils import checkpoint as ckpt_lib

WORLD = 2

ANNOTATION = ("<annotation><filename>{name}.jpg</filename><size><width>{w}</width>"
              "<height>{h}</height><depth>3</depth></size>{objects}</annotation>")
OBJECT = ("<object><name>{cls}</name><difficult>0</difficult><bndbox><xmin>{x1}</xmin>"
          "<ymin>{y1}</ymin><xmax>{x2}</xmax><ymax>{y2}</ymax></bndbox></object>")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def write_voc_tree(root: str, n: int, identical: bool, w: int = 120, h: int = 90) -> None:
    """A VOC tree of ``n`` 120x90 JPEGs with one dog box each: all the same
    pixels and box (``identical``), or each its own seeded pixels and box."""
    for d in ("JPEGImages", "Annotations", os.path.join("ImageSets", "Main")):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    names = [f"{i:06d}" for i in range(n)]
    for i, name in enumerate(names):
        rng = np.random.RandomState(7 if identical else i)
        arr = (rng.rand(h, w, 3) * 255).astype(np.uint8)
        x1, y1 = (21, 21) if identical else (rng.randint(1, 40), rng.randint(1, 30))
        arr[y1:y1 + 40, x1:x1 + 40] = (200, 60, 60)
        PilImage.fromarray(arr).save(os.path.join(root, "JPEGImages", name + ".jpg"))
        obj = OBJECT.format(cls="dog", x1=x1, y1=y1, x2=x1 + 39, y2=y1 + 39)
        with open(os.path.join(root, "Annotations", name + ".xml"), "w") as f:
            f.write(ANNOTATION.format(name=name, w=w, h=h, objects=obj))
    with open(os.path.join(root, "ImageSets", "Main", "trainval.txt"), "w") as f:
        f.write("\n".join(names) + "\n")


def records(root: str, cfg: FasterRcnnConfig):
    recs, _ = load_dataset([root], "trainval", flip=False, resize_min=cfg.data.resize_min,
                           resize_max=cfg.data.resize_max)
    return recs


# ---------------------------------------------------------------------------
# the processes
# ---------------------------------------------------------------------------


def _rank_main(rank: int, world: int, init: str, legs: list, out: str, env: dict) -> None:
    torch.set_num_threads(1)
    os.environ.update({k: str(v).replace("{rank}", str(rank)) for k, v in env.items()})
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    try:
        results = {name: LEGS[name.split("/")[0]](**kw) for name, kw in legs}
        torch.save(results, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(tmp, legs: list, env: dict | None = None, world: int = WORLD,
              meanwhile=None) -> tuple:
    """Run ``legs``, a list of (name in LEGS, keyword arguments), in order in
    each of ``world`` gloo processes, and ``meanwhile()`` here while they
    run; "name/label" runs leg ``name`` once more under another key. Returns
    (every rank's {name: result}, what ``meanwhile``
    returned). ``env`` is set in each process, "{rank}" in a value replaced
    by its rank. A failure in any process fails the call."""
    out = os.path.join(str(tmp), "ranks")
    os.makedirs(out, exist_ok=True)
    init = "file://" + os.path.join(out, "rendezvous")
    ctx = mp.start_processes(_rank_main, args=(world, init, legs, out, env or {}),
                             nprocs=world, join=False, start_method="spawn")
    try:
        here = meanwhile() if meanwhile is not None else None
    finally:
        while not ctx.join():
            pass
    got = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
           for r in range(world)]
    shutil.rmtree(out)
    return got, here


def _model(cfg, state) -> FasterRCNN:
    """A model of ``state``, a state dict or the file that holds one."""
    model = FasterRCNN(cfg)
    model.load_state_dict(torch.load(state) if isinstance(state, str) else state)
    return model


def _rows(mesh, draws: pipeline.Draws) -> pipeline.Draws:
    return pipeline.Draws(**mesh_lib.shard_batch(mesh, draws._asdict()))


def _fingerprint(model) -> dict:
    return {n: p.detach().double().sum().item() for n, p in model.named_parameters()}


def leg_dp_joint(cfg, state, batch, draws, opt_kw):
    """The joint step, data-parallel: each rank's rows of the global batch
    and of each step's global draws. Returns the metrics of each step, the
    parameters after the last on rank 0, and every rank's fingerprint."""
    mesh = mesh_lib.create_mesh()
    assert mesh.data_group is None and mesh.model_group is None  # the default group
    model = _model(cfg, state)
    opt = make_optimizer(model, cfg.model.network, cfg.model.freeze_blocks, mesh=mesh, **opt_kw)
    step = pipeline.make_joint_train_step(cfg, model, opt, device="cpu")
    part = mesh_lib.shard_batch(mesh, batch)
    metrics = [{k: v.clone() for k, v in step(part, _rows(mesh, d)).items()} for d in draws]
    params = ({n: p.detach().clone() for n, p in model.named_parameters()}
              if dist.get_rank() == 0 else None)
    return {"metrics": metrics, "params": params, "fingerprint": _fingerprint(model),
            "local_batch": len(part["image"])}


def leg_tp_det(cfg, state, rpn_state, batch, draws, opt_kw, spec_step=2):
    """The detector step on a 1 x WORLD mesh, VGG16's fc head split over
    the model row. Returns the metrics, the shards' shapes, and on rank 0
    the gathered trainable parameters of the detector head and backbone
    block 5."""
    mesh = mesh_lib.create_mesh(data=1, model=WORLD)
    model = sharding.shard_vgg_head(_model(cfg, state), mesh)
    rpn = _model(cfg, rpn_state).requires_grad_(False)
    fb, fm = trainer.step_freeze_spec(spec_step, cfg)
    opt = make_optimizer(model, cfg.model.network, fb, freeze_modules=fm, mesh=mesh, **opt_kw)
    step = pipeline.make_det_train_step(cfg, model, opt, rpn, freeze_blocks=fb,
                                        freeze_modules=fm, device="cpu")
    metrics = [{k: v.clone() for k, v in step(batch, d).items()} for d in draws]
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters() if ".fc" in n}
    full = sharding.gather_params(dict(model.named_parameters()), mesh)
    keep = {n: p.detach().clone() for n, p in full.items()
            if n.startswith(("det_head.", "backbone.block5")) and opt.labels[n] == "train"}
    return {"metrics": metrics, "shapes": shapes,
            "params": keep if dist.get_rank() == 0 else None}


def leg_dp_cached(cfg, data, workdir, batch_size, chunk_steps):
    """train_cached's joint step, data-parallel. Returns the final metrics;
    the parameters are in rank 0's checkpoint."""
    res = device_cache.train_cached("joint", cfg, records(data, cfg), VOC_CLASS_MAPPING, workdir,
                                    batch_size=batch_size, chunk_steps=chunk_steps,
                                    log_cb=lambda *_: None, device="cpu", multihost=True)
    return {"final_metrics": res.final_metrics}


def leg_detect(cfg, state, images, img_hw):
    """Batch-sharded detection of the whole batch, and of 3 of its images
    (which 2 processes cannot split); rank 1 starts from other weights,
    which the detect function replaces by rank 0's."""
    mesh = mesh_lib.create_mesh()
    model = _model(cfg, state)
    if dist.get_rank() != 0:
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(0.5)
    detect = make_detect_fn(cfg, model, "cpu", mesh=mesh)
    try:
        detect(images[:3], img_hw[:3])
        refused = False
    except ValueError:
        refused = True
    return {"dets": [t.clone() for t in detect(images, img_hw)], "refused": refused}


def leg_handoff(cfg, data, workdir, batch_size, max_steps):
    """Steps 3 and 4 of the 4-step scheme through run_four_step_training,
    data-parallel, step 3 from the step-2 checkpoint in ``workdir``.
    Returns the final metrics of each step, and the handoff's checks: the
    frozen leaves of step 4 equal step 3's output bit for bit, and the
    detector head moved."""
    res = trainer.run_four_step_training(cfg, records(data, cfg), VOC_CLASS_MAPPING, workdir,
                                         steps=(3, 4), batch_size=batch_size,
                                         max_steps=max_steps, device="cpu", multihost=True)
    p3, p4 = res[3].params, res[4].params
    init4 = trainer.merge_params(
        trainer._model(cfg, None, cfg.train.seed, torch.device("cpu")).state_dict(), p3,
        ["backbone", "rpn_head"])
    frozen = [k for k in p4 if k.startswith(("backbone.", "rpn_head."))]
    head = [k for k in p4 if k.startswith("det_head.") and p4[k].is_floating_point()]
    return {"final_metrics": {s: r.final_metrics for s, r in res.items()},
            "frozen_kept": all(torch.equal(p4[k], p3[k]) for k in frozen), "n_frozen": len(frozen),
            "head_moved": sum(not torch.equal(p4[k], init4[k]) for k in head)}


def tiny_config_from_args(args):
    """cli.common.config_from_args at tiny_config's sampler sizes (256 ->
    64 proposals, 16 ROIs an image) and in float32 compute (the RPN's 3x3
    conv stays bf16, as in both packages), as the JAX package's two-process
    test trains (tests/multihost_worker.mh_test_cfg): in bf16 each
    process's rounding of its own rows, amplified over the steps, would hide
    what the comparison is about, the distributed mechanics."""
    cfg = config_from_args(args)
    return cfg.replace(
        model=dataclasses.replace(cfg.model, compute_dtype="float32"),
        rpn=dataclasses.replace(cfg.rpn, train_pre_nms=256, train_post_nms=64),
        det=dataclasses.replace(cfg.det, num_rois=16))


def leg_cli(argv):
    """cli.train's main, under the launcher's environment, at
    :func:`tiny_config_from_args`."""
    ttrain.config_from_args = tiny_config_from_args
    res = ttrain.main(argv)
    return {s: r.final_metrics for s, r in res.items()}


def leg_env_init():
    """maybe_initialize from the environment alone: leaves the group of
    _rank_main and joins the one RANK, WORLD_SIZE, MASTER_ADDR and
    MASTER_PORT describe."""
    dist.destroy_process_group()
    assert not mh.is_initialized()
    joined = mh.maybe_initialize(require=True, device="cpu")
    out = {"joined": joined, "rank": dist.get_rank(), "world": dist.get_world_size(),
           "backend": dist.get_backend()}
    t = torch.ones(1)
    dist.all_reduce(t)
    out["sum"] = float(t)
    return out


LEGS = {"dp_joint": leg_dp_joint, "tp_det": leg_tp_det, "dp_cached": leg_dp_cached,
        "detect": leg_detect, "handoff": leg_handoff, "cli": leg_cli, "env_init": leg_env_init}


# ---------------------------------------------------------------------------
# cli.train --multihost on two processes
# ---------------------------------------------------------------------------


CLI = ["--network", "resnet50", "--resize_dims", "64,96", "--phases", "3:1e-4",
       "--batch_size", "4", "--step", "joint", "--save_frequency", "1000", "--device", "cpu",
       "--no-flip"]


def test_two_process_cli_train_matches_one_process(tmp_path, monkeypatch):
    """cli.train --multihost on two processes (global batch 4, 2 a process)
    against cli.train on one, on 8 identical images, both at
    :func:`tiny_config_from_args`: both processes report the same globally
    reduced metrics, within 1e-5, and those of the one process's run within
    its JAX counterpart's 2e-3 (the reductions sum in other orders)."""
    monkeypatch.setattr(ttrain, "config_from_args", tiny_config_from_args)
    data = str(tmp_path / "VOC")
    write_voc_tree(data, 8, identical=True)
    env = {"RANK": "{rank}", "LOCAL_RANK": "{rank}", "WORLD_SIZE": WORLD,
           "MASTER_ADDR": "unused", "MASTER_PORT": "0"}
    try:
        got, local = run_ranks(
            tmp_path, [("cli", {"argv": ["--voc_paths", data, "--workdir",
                                         str(tmp_path / "work2"), "--multihost", *CLI]})], env,
            meanwhile=lambda: ttrain.main(["--voc_paths", data, "--workdir",
                                           str(tmp_path / "work1"), *CLI]))
        assert ckpt_lib.latest_step(str(tmp_path / "work2" / "stepjoint")) == 3
    finally:
        shutil.rmtree(tmp_path / "work1", ignore_errors=True)
        shutil.rmtree(tmp_path / "work2", ignore_errors=True)
    m0, m1 = got[0]["cli"]["joint"], got[1]["cli"]["joint"]
    want = local["joint"].final_metrics
    assert set(m0) == set(want) and m0["num_valid_images"] == want["num_valid_images"] == 4
    for k, v in want.items():
        assert np.isclose(m1[k], m0[k], rtol=1e-5, atol=0), (k, m0, m1)
        assert np.isclose(m0[k], v, rtol=2e-3, atol=1e-5), (k, m0, want)


def test_maybe_initialize_joins_the_group_its_environment_names(tmp_path):
    """The environment's own rendezvous (MASTER_PORT 0: the store takes a
    free port), one process: gloo on the CPU, rank 0 of 1."""
    env = {"RANK": 0, "LOCAL_RANK": 0, "WORLD_SIZE": 1, "MASTER_ADDR": "localhost",
           "MASTER_PORT": 0}
    (got,), _ = run_ranks(tmp_path, [("env_init", {})], env, world=1)
    assert got["env_init"] == {"joined": True, "rank": 0, "world": 1, "backend": "gloo",
                               "sum": 1.0}


# ---------------------------------------------------------------------------
# one process: the helpers and the refusals
# ---------------------------------------------------------------------------


def test_shard_records_for_host_is_round_robin():
    recs = list(range(10))
    assert mh.shard_records_for_host(recs, process_index=1, process_count=3) == [1, 4, 7]
    shards = [mh.shard_records_for_host(recs, process_index=i, process_count=4)
              for i in range(4)]
    assert sorted(sum(shards, [])) == recs
    assert mh.shard_records_for_host(recs) == recs  # one process: everything


def test_local_batch_size():
    assert mh.local_batch_size(16, 4) == 4
    assert mh.local_batch_size(16) == 16
    with pytest.raises(ValueError, match="not divisible"):
        mh.local_batch_size(6, 4)


def test_global_draws_are_rows_of_the_global_batch_draws():
    """Each process's draws are its rows of the global batch's, drawn from
    the same seed, so which image gets which draws does not depend on the
    world size; each row is its own copy, not a view of the whole."""
    cfg = FasterRcnnConfig()
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, canvas_h=64, canvas_w=96))
    whole = pipeline.draw_samples(cfg, 4, torch.Generator().manual_seed(3))
    mesh = mesh_lib.Mesh(np.arange(2).reshape(2, 1), 1, 0, None, None)
    got = mh.global_draws(cfg, 4, torch.Generator().manual_seed(3), mesh)
    for w, g in zip(whole, got):
        assert torch.equal(g, w[2:4]) and g.untyped_storage().size() == g.nbytes
    with pytest.raises(ValueError, match="not divisible"):
        mh.global_draws(cfg, 3, torch.Generator().manual_seed(3), mesh)


def test_maybe_initialize_without_an_environment(monkeypatch):
    for k in mh.ENV:
        monkeypatch.delenv(k, raising=False)
    assert mh.maybe_initialize(device="cpu") is False
    with pytest.raises(RuntimeError, match="torchrun"):
        mh.maybe_initialize(require=True, device="cpu")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="lacks"):
        mh.maybe_initialize(device="cpu")  # a broken launch is an error, required or not
    for k, v in (("RANK", "x"), ("LOCAL_RANK", "0"), ("MASTER_ADDR", "a"), ("MASTER_PORT", "1")):
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="integers"):
        mh.maybe_initialize(require=True, device="cpu")
    monkeypatch.setenv("RANK", "2")
    with pytest.raises(RuntimeError, match="not in"):
        mh.maybe_initialize(require=True, device="cpu")
    assert not mh.is_initialized()


def test_a_checkpoint_of_a_split_head_is_refused(tmp_path):
    """save_state on a mesh that splits the fc head raises before writing:
    rank 0 holds only its shards."""
    mesh = mesh_lib.Mesh(np.arange(2).reshape(1, 2), 0, 0, None, None)
    with pytest.raises(ValueError, match="split fc head"):
        trainer.save_state(str(tmp_path / "ck"), 1, torch.nn.Linear(2, 2), None, mesh)
    assert not (tmp_path / "ck").exists()


def test_create_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="maybe_initialize"):
        mesh_lib.create_mesh()


def test_a_multi_process_launch_without_multihost_raises(tmp_path, monkeypatch):
    """WORLD_SIZE > 1 with no --multihost: the train CLI, train_one_step and
    train_cached refuse, before any work; --multihost outside a launch
    fails too."""
    data = str(tmp_path / "VOC")
    write_voc_tree(data, 2, identical=False)
    work = str(tmp_path / "work")
    argv = ["--voc_paths", data, "--workdir", work] + CLI
    for k in mh.ENV:
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        ttrain.main(argv + ["--multihost"])
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="multihost is off"):
        ttrain.main(argv)
    with pytest.raises(RuntimeError, match="multihost is off"):
        ttrain.main(argv + ["--device_cache"])
    assert not os.path.exists(work)
