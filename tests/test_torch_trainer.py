"""The port's trainer, checkpoints and optimizer state, on the CPU.

A tiny ResNet-50 (tiny_config shapes, float32) trains on a tiny VOC tree
through ``train/trainer.py``: the 4-step handoff, resume, the checkpoint on
SIGTERM, and ``utils/checkpoint.py`` with the optimizer's state dict. Each
run's workdir is removed when its test ends: a checkpoint of this model
with its momentum is about 0.2 GB. tests/test_torch_trainer_jax.py holds
the same trainer against faster_rcnn_tpu's.
"""

import dataclasses
import functools
import os
import shutil
import signal
import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image as PilImage
from torch import nn

from faster_rcnn_tpu_torch.data import pipeline as tdata
from faster_rcnn_tpu_torch.data.voc import VOC_CLASS_MAPPING, load_dataset
from faster_rcnn_tpu_torch.parallel.freeze import make_optimizer
from faster_rcnn_tpu_torch.train import pipeline as tpipe
from faster_rcnn_tpu_torch.train import trainer as ttrainer
from faster_rcnn_tpu_torch.utils import checkpoint as ckpt_lib
from tests.test_data import make_voc_tree
from tests.test_torch_models import port_config
from tests.test_torch_train import tiny_train_config

TINY_VOC = [
    ("000001", 120, 90, [("dog", False, 20, 20, 60, 60)]),
    ("000002", 120, 90, [("cat", False, 30, 10, 90, 70), ("dog", False, 5, 5, 40, 40)]),
    ("000003", 120, 90, [("person", False, 10, 30, 80, 85)]),
    ("000004", 120, 90, [("car", False, 50, 20, 110, 80)]),
]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def trainer_config():
    """tiny_train_config() (ResNet-50 in float32, stages 1-3 frozen) for the
    VOC classes, B=2, SGD at 0.02 for 4 iterations, weight decay 1e-4 and
    the clip at 10 (the step tests' optimizer). The JAX package's config."""
    cfg = tiny_train_config()
    return cfg.replace(
        model=dataclasses.replace(cfg.model, num_classes=len(VOC_CLASS_MAPPING),
                                  weight_decay=1e-4),
        train=dataclasses.replace(cfg.train, phases=((4, 0.02),), batch_size=2,
                                  clip_grad_norm=10.0))


def voc_records(root, cfg, load=load_dataset):
    """The tree's 4 images and their flips, resized for ``cfg``. The pixels
    are drawn from seeds (make_voc_tree seeds them with ``hash(name)``,
    which changes from process to process)."""
    if not os.path.isdir(root):
        make_voc_tree(root, TINY_VOC)
        for i, (name, w, h, _) in enumerate(TINY_VOC):
            pixels = np.random.RandomState(i).randint(0, 256, (h, w, 3)).astype(np.uint8)
            PilImage.fromarray(pixels).save(os.path.join(root, "JPEGImages", name + ".jpg"))
    recs, _ = load([root], "trainval", flip=True, resize_min=cfg.data.resize_min,
                   resize_max=cfg.data.resize_max)
    return recs


@pytest.fixture
def workdir(tmp_path):
    path = tmp_path / "work"
    yield str(path)
    shutil.rmtree(path, ignore_errors=True)


@pytest.fixture
def one_worker(monkeypatch):
    """The port's loader pinned to one worker: the batch order is then the
    seed's (with more, workers race to the queue, as in the JAX loader)."""
    monkeypatch.setattr(ttrainer, "TrainLoader",
                        functools.partial(tdata.TrainLoader, num_workers=1))


@pytest.fixture(scope="module")
def setting(tmp_path_factory):
    tc = port_config(trainer_config())
    return tc, voc_records(str(tmp_path_factory.mktemp("trainer") / "VOC"), tc)


def _equal(a, b, prefix):
    names = [k for k in a if k.startswith(prefix)]
    assert names
    return all(torch.equal(a[k], b[k]) for k in names)


def test_four_step_handoff(setting, workdir, one_worker):
    """Step 3 takes step 2's backbone, frozen; step 4 takes step 3's
    backbone and RPN head, frozen, and trains a fresh detector head (the
    JAX package's test_steps_3_4_handoff)."""
    tc, recs = setting
    res = ttrainer.run_four_step_training(tc, recs, VOC_CLASS_MAPPING, workdir,
                                          steps=(1, 2, 3, 4), batch_size=2, max_steps=2,
                                          device="cpu")
    assert set(res) == {1, 2, 3, 4}
    p = {s: r.params for s, r in res.items()}
    assert _equal(p[2], p[3], "backbone.")
    assert not _equal(p[1], p[3], "rpn_head.")  # retrained from the fresh head
    assert _equal(p[3], p[4], "backbone.") and _equal(p[3], p[4], "rpn_head.")
    cls = f"det_head.dense_class_{len(VOC_CLASS_MAPPING)}.weight"
    assert not torch.equal(p[2][cls], p[4][cls])
    for s, r in res.items():
        assert np.isfinite(r.final_metrics["loss"]) and r.batch_stats == {}
        assert ckpt_lib.latest_step(os.path.join(workdir, f"step{s}")) == 2
    loaded = ttrainer._load_step_params(workdir, 4)
    assert all(torch.equal(loaded[k], v) for k, v in p[4].items())


def _resumed(monkeypatch, tc, recs, workdir, max_steps):
    """train_one_step(1) up to ``max_steps``; returns (result, the optimizer
    state it restored or None)."""
    restored = []
    load = ttrainer.make_optimizer

    def spy(*a, **k):
        opt = load(*a, **k)
        orig = opt.load_state_dict
        opt.load_state_dict = lambda st: restored.append(st) or orig(st)
        return opt

    monkeypatch.setattr(ttrainer, "make_optimizer", spy)
    res = ttrainer.train_one_step(1, tc, recs, VOC_CLASS_MAPPING, workdir, batch_size=2,
                                  max_steps=max_steps, log_every=1, device="cpu")
    return res, (restored[0] if restored else None)


def test_resume_restores_model_optimizer_and_count(setting, workdir, one_worker, monkeypatch,
                                                   capsys):
    tc, recs = setting
    first, none = _resumed(monkeypatch, tc, recs, workdir, 2)
    assert none is None
    ck2 = ckpt_lib.restore(os.path.join(workdir, "step1"))
    assert ck2["count"] == 2 and ck2["optimizer"]["count"] == 2
    # a re-run after the last checkpoint does nothing more
    again, st = _resumed(monkeypatch, tc, recs, workdir, 2)
    assert st["count"] == 2 and "resumed from iteration 2" in capsys.readouterr().out
    assert all(torch.equal(again.params[k], v) for k, v in ck2["model"].items())
    # stopped at 2, resumed to 4: the traces and the count come back
    resumed, st = _resumed(monkeypatch, tc, recs, workdir, 4)
    traces = ck2["optimizer"]["state"]
    assert st["count"] == 2 and set(st["state"]) == set(traces) and traces
    assert all(torch.equal(st["state"][n]["trace"], t["trace"]) for n, t in traces.items())
    ck4 = ckpt_lib.restore(os.path.join(workdir, "step1"))
    assert ck4["count"] == 4 and ck4["optimizer"]["count"] == 4
    assert ckpt_lib.latest_step(os.path.join(workdir, "step1")) == 4
    with open(os.path.join(workdir, "step1", "metrics.jsonl")) as f:
        assert [int(line.split(",")[0].split(":")[1]) for line in f] == [1, 2, 3, 4]
    assert not any(torch.equal(resumed.params[n], ck2["model"][n]) for n in traces)


def test_sigterm_checkpoints_and_exits_143(setting, workdir, one_worker, monkeypatch):
    """SIGTERM raised inside the second iteration's step: the step ends,
    its state is checkpointed at iteration 2, and the run exits with 128 +
    15; the previous handler comes back and the loader's workers stop."""
    assert threading.current_thread() is threading.main_thread()
    tc, recs = setting
    calls = []
    draws = ttrainer._draws

    def draws_then_signal(*a):
        calls.append(1)
        if len(calls) == 2:
            signal.raise_signal(signal.SIGTERM)
        return draws(*a)

    monkeypatch.setattr(ttrainer, "_draws", draws_then_signal)
    before = signal.getsignal(signal.SIGTERM)
    with pytest.raises(SystemExit) as exc:
        ttrainer.train_one_step(1, tc, recs, VOC_CLASS_MAPPING, workdir, batch_size=2,
                                device="cpu")
    assert exc.value.code == 143 and len(calls) == 2
    assert ckpt_lib.latest_step(os.path.join(workdir, "step1")) == 2
    assert ckpt_lib.restore(os.path.join(workdir, "step1"))["optimizer"]["count"] == 2
    assert signal.getsignal(signal.SIGTERM) == before
    deadline = time.time() + 5
    while any(t.name == "TrainLoader-worker" for t in threading.enumerate()):
        assert time.time() < deadline, "loader workers still running"
        time.sleep(0.05)


def test_steps_run_on_cuda_unless_asked_for_the_cpu(setting, workdir, monkeypatch):
    tc, recs = setting
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrainer.train_one_step(1, tc, recs, VOC_CLASS_MAPPING, workdir)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrainer.run_four_step_training(tc, recs, VOC_CLASS_MAPPING, workdir)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrainer.run_four_step_training(tc, recs, VOC_CLASS_MAPPING, workdir,
                                        use_device_cache=True)
    with pytest.raises(ValueError, match="rpn_params"):
        ttrainer.train_one_step(2, tc, recs, VOC_CLASS_MAPPING, workdir, device="cpu")


def test_cpu_batches_go_through_as_they_are():
    """On the CPU the loader's arrays become tensors sharing their memory,
    and the step's _batch_on copies nothing."""
    batch = {"image": np.zeros((2, 8, 8, 3), np.uint8), "gt_boxes": np.ones((2, 4, 4), np.float32),
             "gt_class": np.zeros((2, 4), np.int64), "gt_valid": np.ones((2, 4), bool),
             "img_hw": np.full((2, 2), 8, np.int64)}
    cpu = torch.device("cpu")
    tensors = ttrainer._take(ttrainer._put(batch, cpu, None), cpu)
    for k, v in batch.items():
        assert tensors[k].data_ptr() == v.__array_interface__["data"][0]
    _, gt_boxes, gt_class, gt_valid, img_hw = tpipe._batch_on(tensors, cpu)
    for got, k in ((gt_boxes, "gt_boxes"), (gt_class, "gt_class"), (gt_valid, "gt_valid"),
                   (img_hw, "img_hw")):
        assert got.data_ptr() == tensors[k].data_ptr()


# ---------------------------------------------------------------------------
# checkpoints and the optimizer's state dict
# ---------------------------------------------------------------------------


def test_checkpoint_round_trip_and_keep(tmp_path):
    d = str(tmp_path / "ck")
    assert ckpt_lib.latest_step(d) is None
    with pytest.raises(FileNotFoundError):
        ckpt_lib.restore(d)
    tree = {"model": {"a": torch.arange(6.0).reshape(2, 3), "b": torch.ones(2, dtype=torch.int64)},
            "optimizer": {"kind": "sgd", "count": 7, "state": {"a": {"trace": torch.ones(2, 3)}}},
            "count": 7}
    for s in range(1, 6):
        ckpt_lib.save(d, s, dict(tree, count=s), keep=3)
    assert sorted(os.listdir(d)) == ["3", "4", "5"]
    got = ckpt_lib.restore(d)
    assert got["count"] == 5 and ckpt_lib.restore(d, 3)["count"] == 3
    assert torch.equal(got["model"]["a"], tree["model"]["a"])
    assert got["model"]["b"].dtype == torch.int64 and got["optimizer"]["kind"] == "sgd"
    ckpt_lib.save(d, 5, dict(tree, count=55), keep=3)  # the same step again replaces it
    assert ckpt_lib.restore(d)["count"] == 55 and sorted(os.listdir(d)) == ["3", "4", "5"]


def test_half_written_checkpoint_is_never_picked(tmp_path):
    d = tmp_path / "ck"
    ckpt_lib.save(str(d), 2, {"count": 2})
    (d / ".tmp-9-123").mkdir()  # a save killed mid-write
    (d / ".tmp-9-123" / "checkpoint.pt").write_bytes(b"\x80\x02trunc")
    (d / "10").mkdir()          # a step directory without its file
    assert ckpt_lib.latest_step(str(d)) == 2 and ckpt_lib.restore(str(d))["count"] == 2


class _Tiny(nn.Module):
    """Parameters named as the port's model names them: a trainable head,
    a frozen batch norm."""

    def __init__(self):
        super().__init__()
        self.det_head = nn.Linear(4, 3)
        self.backbone = nn.Module()
        self.backbone.bn_conv1 = nn.Linear(4, 4)


def _grads(model, seed):
    g = torch.Generator().manual_seed(seed)
    for p in model.parameters():
        if p.requires_grad:
            p.grad = torch.randn(p.shape, generator=g)


@pytest.mark.parametrize("kind", ["sgd", "adam"])
def test_optimizer_state_round_trips_onto_other_parameters(tmp_path, kind):
    """A checkpointed optimizer state loads into an optimizer over another
    model's parameters (on the CPU here; tests/test_torch_gpu.py loads one
    onto CUDA), and the two then take the same steps; the count carries the
    learning-rate schedule on."""
    torch.manual_seed(0)
    a = _Tiny()
    opt_a = make_optimizer(a, "resnet50", (), lambda c: 0.1 / (1 + c), optimizer=kind)
    for s in range(3):
        _grads(a, s)
        opt_a.step()
    ckpt_lib.save(str(tmp_path), 3, {"model": a.state_dict(), "optimizer": opt_a.state_dict()})
    restored = ckpt_lib.restore(str(tmp_path))
    b = _Tiny()
    b.load_state_dict(restored["model"])
    seen = []
    opt_b = make_optimizer(b, "resnet50", (), lambda c: seen.append(c) or 0.1 / (1 + c),
                           optimizer=kind)
    opt_b.load_state_dict(restored["optimizer"])
    assert opt_b.count == 3 and set(opt_b.state) == {"det_head.weight", "det_head.bias"}
    for name, st in opt_b.state.items():
        for k, v in st.items():
            assert torch.equal(v, opt_a.state[name][k])
    for s in (3, 4):
        _grads(a, s)
        _grads(b, s)
        opt_a.step()
        opt_b.step()
    assert seen == [3, 4]
    for (n, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), n
    with pytest.raises(ValueError):
        make_optimizer(_Tiny(), "resnet50", (), 0.1,
                       optimizer="adam" if kind == "sgd" else "sgd").load_state_dict(
                           opt_a.state_dict())
    bad = opt_a.state_dict()
    bad["state"]["backbone.bn_conv1.weight"] = bad["state"]["det_head.weight"]
    with pytest.raises(ValueError, match="does not train"):
        make_optimizer(_Tiny(), "resnet50", (), 0.1, optimizer=kind).load_state_dict(bad)
