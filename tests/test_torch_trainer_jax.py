"""The port's train_one_step against faster_rcnn_tpu's, on the CPU.

Both trainers run a tiny ResNet-50 (tests/test_torch_trainer.trainer_config)
on the same tiny VOC tree from the same weights (the port's seeded init
with redrawn batch norms, carried over by utils/convert), each with its
loader pinned to one worker, so that both see the same batches. The port
gets the draws that the JAX trainer's keys give (``trainer._draws`` is
replaced; the JAX trainer's key chain, trainer.py:207-208, :243-244). On
the JAX side the test replaces ``init_model`` (whose Flax trace costs some
20 s) by these weights, and ``TrainLoader`` by the one-worker loader; the
JAX package's files are untouched. Each JAX call compiles its step afresh.
"""

import functools
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from faster_rcnn_tpu.data import pipeline as jdata
from faster_rcnn_tpu.data import voc as jvoc
from faster_rcnn_tpu.models.detector import FasterRCNN as JaxFasterRCNN
from faster_rcnn_tpu.train import trainer as jtrainer
from faster_rcnn_tpu_torch.data import pipeline as tdata
from faster_rcnn_tpu_torch.data.voc import VOC_CLASS_MAPPING
from faster_rcnn_tpu_torch.models.detector import init_model
from faster_rcnn_tpu_torch.train import trainer as ttrainer
from faster_rcnn_tpu_torch.utils.convert import from_flax_numpy
from tests.test_torch_four_step import RPN_STEP_HELD, RPN_STEP_LOSS_RTOL
from tests.test_torch_models import port_config, redraw_norm_layers
from tests.test_torch_train import jax_draws, to_flax_numpy
from tests.test_torch_trainer import trainer_config, voc_records

B = 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setting(tmp_path_factory):
    """(JAX cfg, port cfg, JAX records, port records, weights, frozen RPN's
    weights), the weights as numpy Flax trees. The RPN's batch-norm
    statistics are the weights' own, as the JAX trainer pairs ``rpn_params``
    with its init's ``batch_stats`` (trainer.py:136-140)."""
    jcfg = trainer_config()
    tc = port_config(jcfg)
    root = str(tmp_path_factory.mktemp("trainer_jax") / "VOC")
    trecs = voc_records(root, tc)
    jrecs = voc_records(root, jcfg, load=jvoc.load_dataset)
    vnp = redraw_norm_layers(to_flax_numpy(init_model(0, tc, "cpu").state_dict()), 0)
    rpn = {"params": to_flax_numpy(init_model(1, tc, "cpu").state_dict())["params"],
           "batch_stats": vnp["batch_stats"]}
    return jcfg, tc, jrecs, trecs, vnp, rpn


@pytest.fixture
def workdirs(tmp_path):
    dirs = (str(tmp_path / "jax"), str(tmp_path / "port"))
    yield dirs
    for d in dirs:
        shutil.rmtree(d, ignore_errors=True)


@pytest.fixture
def patched(setting, monkeypatch):
    """One-worker loaders in both trainers, the weights in the JAX
    trainer's init_model, and JAX's draws in the port's trainer."""
    jcfg, tc, _, _, vnp, _ = setting
    monkeypatch.setattr(jtrainer, "TrainLoader",
                        functools.partial(jdata.TrainLoader, num_workers=1))
    monkeypatch.setattr(ttrainer, "TrainLoader",
                        functools.partial(tdata.TrainLoader, num_workers=1))
    monkeypatch.setattr(jtrainer, "init_model", lambda key, cfg: (JaxFasterRCNN(cfg), vnp))

    def use_jax_draws(step, seed):
        key = [jax.random.PRNGKey(seed + 1000 * (step if isinstance(step, int) else 5))]

        def draws(cfg, b, generator):
            key[0], sub = jax.random.split(key[0])
            return jax_draws(jax.random.split(sub, b), cfg, fold=step == "joint")

        monkeypatch.setattr(ttrainer, "_draws", draws)

    return use_jax_draws


def _metrics(workdir, step):
    with open(os.path.join(workdir, f"step{step}", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def run_both(setting, patched, workdirs, step, stops=(4,), seed=0):
    """Both trainers' step ``step``, run to each iteration count in
    ``stops`` in turn (each run after the first resumes from the one
    before). Returns (JAX metrics, port metrics, JAX params, port params,
    params before) with the parameters as port state dicts."""
    jcfg, tc, jrecs, trecs, vnp, rpn = setting
    jdir, tdir = workdirs
    det = step in (2, 4)
    for stop in stops:
        jres = jtrainer.train_one_step(
            step, jcfg, jrecs, jvoc.VOC_CLASS_MAPPING, jdir, init_params=vnp["params"],
            rpn_params=rpn["params"] if det else None, batch_size=B, log_every=1,
            max_steps=stop, seed=seed, devices=jax.devices()[:1])
        patched(step, seed)
        tres = ttrainer.train_one_step(
            step, tc, trecs, VOC_CLASS_MAPPING, tdir, init_params=from_flax_numpy(vnp),
            rpn_params=from_flax_numpy(rpn) if det else None, batch_size=B, log_every=1,
            max_steps=stop, seed=seed, device="cpu")
    jparams = from_flax_numpy({"params": jax.tree_util.tree_map(np.asarray, jres.params)})
    jax.clear_caches()
    return (_metrics(jdir, step), _metrics(tdir, step), jparams, tres.params,
            from_flax_numpy(vnp))


# A loss near 0 (a batch whose ROIs the head already calls background with
# p > 1 - 1e-5) is -log_softmax's difference of two logits of magnitude
# 1-40, whose f32 spacing is up to 4e-6: losses are held at LOSS_ATOL beside
# their rtol.
LOSS_ATOL = 1e-6


def check(run, names, rtol, held=None, tol=1e-3):
    """Each iteration's losses within ``rtol`` (or LOSS_ATOL); each trained
    parameter within ``tol`` (or ``held``'s value for its prefix) of its
    largest change on the JAX side; the frozen ones unchanged in both."""
    want, got, jparams, tparams, before = run
    assert [m["iter"] for m in got] == [m["iter"] for m in want]
    for w, g in zip(want, got):
        for k in names:
            np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=LOSS_ATOL,
                                       err_msg=f"iter {w['iter']} {k}")
    held = held or {}
    bad, trained = {}, 0
    for n, j in jparams.items():
        delta = (j - before[n]).abs().max().item()
        err = (tparams[n] - j).abs().max().item()
        if delta == 0:
            assert err == 0, n
            continue
        trained += 1
        if err > next((v for k, v in held.items() if n.startswith(k)), tol) * delta:
            bad[n] = err / delta
    assert not bad, bad
    assert trained > 0


# The RPN step's bf16 3x3 conv (ROADMAP.md Queue 3) is held at 2e-2 of its
# largest change after the step tests' 2 steps; after these 4 iterations it
# agrees to 2.96e-2 (weight) and 2.30e-2 (bias), and is held at 4e-2 here.
# Every other group is held at the step tests' bounds.
TRAINER_RPN_HELD = {"rpn_head.rpn_conv1.": 4e-2, **RPN_STEP_HELD}


def test_rpn_step_matches_jax(setting, patched, workdirs):
    run = run_both(setting, patched, workdirs, 1)
    assert len(run[0]) == 4
    check(run, ("rpn_cls", "rpn_reg", "loss"), RPN_STEP_LOSS_RTOL, TRAINER_RPN_HELD)


def test_det_step_matches_jax(setting, patched, workdirs):
    run = run_both(setting, patched, workdirs, 2, seed=3)
    assert len(run[0]) == 4 and all(m["num_valid_images"] == B for m in run[1])
    check(run, ("det_cls", "det_reg", "loss"), 1e-4)


def test_resumed_run_matches_jax_resumed_run(setting, patched, workdirs):
    """Step 2 stopped at 2 and resumed to 4: both trainers restore the
    model, the optimizer's state and its count, and start the loader and
    the draws again from the beginning (so iterations 3-4 see iterations
    1-2's batches and draws). The detector step, whose gradients do not
    pass through the bf16 RPN conv, is held at 1e-4 and 1e-3."""
    run = run_both(setting, patched, workdirs, 2, stops=(2, 4), seed=3)
    assert [m["iter"] for m in run[1]] == [1, 2, 3, 4]
    check(run, ("det_cls", "det_reg", "loss"), 1e-4)


# Resumed, the RPN step's losses agree to 3.82e-4 relative (rpn_reg at
# iteration 3; every other loss to 1.1e-4), where an uninterrupted run's
# meet RPN_STEP_LOSS_RTOL: the bf16 RPN conv (ROADMAP.md Queue 3) rounds
# apart on the restored weights. They are held at 5e-4; the parameters
# meet TRAINER_RPN_HELD (2.80e-2 rpn_conv1, 2.04e-2 backbone).
RESUMED_RPN_LOSS_RTOL = 5e-4


def test_resumed_rpn_step_matches_jax_resumed_run(setting, patched, workdirs):
    """Step 1 stopped at 2 and resumed to 4, as chip_smoke.py resumes step
    1: both trainers restore the model, the optimizer's state and count,
    and start the loader and the draws again."""
    run = run_both(setting, patched, workdirs, 1, stops=(2, 4))
    assert [m["iter"] for m in run[1]] == [1, 2, 3, 4]
    check(run, ("rpn_cls", "rpn_reg", "loss"), RESUMED_RPN_LOSS_RTOL, TRAINER_RPN_HELD)
