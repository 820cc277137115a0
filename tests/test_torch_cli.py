"""The port's CLIs: flags against faster_rcnn_tpu's, and the user's chain
train -> detect -> evaluate end to end on the CPU.

The chain trains a ResNet-50 at a 64x96 canvas on a tiny VOC tree (all four
steps, two iterations each, B=2), detects on two of its images and
evaluates. Quality is not asserted (two iterations a step from random
weights); the files and the mAP's range are.
"""

import argparse
import dataclasses
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faster_rcnn_tpu import inference as jinference
from faster_rcnn_tpu.cli import common as jcommon
from faster_rcnn_tpu_torch import evaluate as teval
from faster_rcnn_tpu_torch import inference as tinference
from faster_rcnn_tpu_torch.cli import common as tcommon
from faster_rcnn_tpu_torch.cli import detect as tdetect
from faster_rcnn_tpu_torch.cli import evaluate as tevaluate
from faster_rcnn_tpu_torch.cli import train as ttrain
from faster_rcnn_tpu_torch.data.voc import VOC_CLASS_MAPPING
from tests.test_torch_models import port_config
from tests.test_torch_trainer import TINY_VOC, trainer_config, voc_records

# the flag sets of tests/test_cli.py
FLAG_SETS = [
    [],
    ["--kitti", "--resize_dims", "600,1500", "--anchor_scales", "16,32,64,128,256,512"],
    ["--network", "vgg16", "--phases", "100:0.01,50:0.001", "--optimizer", "adam",
     "--batch_size", "8", "--clip_grad_norm", "10"],
    ["--network", "resnet101"],
    ["--network", "resnet50", "--freeze_blocks", "none", "--save_frequency", "7", "--seed", "3"],
]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _parse(common, training, flags):
    p = argparse.ArgumentParser()
    common.add_common_args(p, training=training)
    return p.parse_args(["--voc_paths", "/data/VOC2007", *flags])


@pytest.mark.parametrize("training,flags", [(True, f) for f in FLAG_SETS] + [
    (False, f) for f in ([], FLAG_SETS[1], ["--network", "vgg16"], ["--network", "resnet101"])])
def test_config_from_args_matches_jax(training, flags):
    jargs, targs = _parse(jcommon, training, flags), _parse(tcommon, training, flags)
    assert targs.device == "cuda"
    assert (dataclasses.asdict(tcommon.config_from_args(targs))
            == dataclasses.asdict(jcommon.config_from_args(jargs)))
    assert tcommon.class_mapping_from_args(targs) == jcommon.class_mapping_from_args(jargs)


def test_flags_of_unported_modules_fail_in_argparse(capsys):
    """Every flag of the JAX package's CLIs is ported: the port's train
    parser takes each of the JAX train parser's options (``--multihost``,
    the last to come, with the JAX help text), and an option neither has
    still fails in argparse."""
    def options(common):
        p = argparse.ArgumentParser()
        common.add_common_args(p, training=True)
        return {o: a.help for a in p._actions for o in a.option_strings}

    jopts, topts = options(jcommon), options(tcommon)
    assert set(jopts) <= set(topts)
    assert topts["--multihost"] == jopts["--multihost"]
    with pytest.raises(SystemExit):
        ttrain.main(["--voc_paths", "x", "--no_such_flag", "--device", "cpu"])
    assert "unrecognized arguments" in capsys.readouterr().err


@pytest.fixture
def tree(tmp_path):
    """The tiny VOC tree with a val set of two of its images; the workdir
    is removed at the end (four ResNet-50 checkpoints, about 0.7 GB)."""
    root = str(tmp_path / "VOC")
    voc_records(root, tcommon.config_from_args(_parse(tcommon, True, [])))
    with open(os.path.join(root, "ImageSets", "Main", "val.txt"), "w") as f:
        f.write("\n".join(name for name, *_ in TINY_VOC[:2]) + "\n")
    yield root, str(tmp_path / "work"), str(tmp_path / "dets")
    shutil.rmtree(tmp_path / "work", ignore_errors=True)


COMMON = ["--network", "resnet50", "--resize_dims", "64,96", "--device", "cpu"]


def test_train_detect_evaluate_chain(tree, capsys):
    root, work, dets = tree
    results = ttrain.main(["--voc_paths", root, "--workdir", work, "--phases", "2:1e-3",
                           "--batch_size", "2", "--step", "all", *COMMON])
    assert set(results) == {1, 2, 3, 4}
    assert all(np.isfinite(r.final_metrics["loss"]) for r in results.values())
    assert "loaded 8 training records" in capsys.readouterr().out
    for from_step in ("4", "1"):  # step 1's checkpoint holds the untrained head
        out = os.path.join(dets, from_step)
        tdetect.main(["--voc_paths", root, "--img_set", "val", "--workdir", work,
                      "--from_step", from_step, "--out_dir", out, "--batch_size", "2", *COMMON])
        assert "2 images to process" in capsys.readouterr().out
        written = os.listdir(out)
        for f in written:
            ids, _, bb = teval.parse_detection_file(os.path.join(out, f))
            assert set(ids) <= {name for name, *_ in TINY_VOC[:2]}
            assert bb.shape[1:] == (4,) or not ids
        aps = tevaluate.main(["--voc_path", root, "--dets_path", out, "--img_set", "val"])
        assert set(aps) == set(VOC_CLASS_MAPPING) - {"bg"} | {"mAP"}
        assert np.isfinite(aps["mAP"]) and 0.0 <= aps["mAP"] <= 1.0
    assert written  # the untrained head's detections are not all background


def test_clis_raise_without_a_card_unless_asked_for_the_cpu(tree, monkeypatch):
    root, work, dets = tree
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    flags = ["--voc_paths", root, "--network", "resnet50", "--resize_dims", "64,96"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.main(flags + ["--workdir", work, "--phases", "1:1e-3", "--batch_size", "2"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdetect.main(flags + ["--workdir", work, "--out_dir", dets])
    assert not os.path.exists(work) and not os.path.exists(dets)


def _overflowed_detections():
    """Detections of 4 ROIs whose detector head's width and height outputs
    (500) exceed 5 * 88.7: exp(dw) overflows in the box decode, in both
    packages; and beside them one ROI whose outputs are 0, a finite box.
    Returns (JAX config, port detections, JAX detections)."""
    jcfg = trainer_config()
    c, r = jcfg.model.num_classes, 5
    rois = np.array([[2, 2, 10, 12]] * r, np.float32) + np.arange(r, dtype=np.float32)[:, None]
    prob = np.full((r, c), 0.01 / (c - 1), np.float32)
    prob[:, 0] = 0.99
    reg = np.zeros((r, 4 * (c - 1)), np.float32)
    reg[:4, 2:4] = 500.0
    tdets = tinference.Detections(*tinference._decode_one_image(
        port_config(jcfg), torch.tensor(rois)[None], torch.ones(1, r, dtype=torch.bool),
        torch.tensor(prob)[None], torch.tensor(reg)[None]))
    jdets = jinference.Detections(*(x[None] for x in jinference._decode_one_image(
        jcfg, jnp.asarray(rois), jnp.ones(r, bool), jnp.asarray(prob), jnp.asarray(reg))))
    for dets in (tdets, jdets):
        boxes, valid = np.asarray(dets.boxes)[0], np.asarray(dets.valid)[0]
        assert valid.sum() == 5 and np.isinf(boxes[valid]).any(-1).sum() == 4
    return jcfg, tdets, jdets


def test_an_overflowed_box_crashes_detections_to_records_in_jax():
    """A known failure of the JAX package, pinned (ROADMAP.md Queue 3,
    "Handled divergences"): detections_to_records, which the detect CLI
    calls, cannot round an infinite box."""
    jcfg, _, jdets = _overflowed_detections()
    with pytest.raises(OverflowError, match="infinity"):
        jinference.detections_to_records(jdets, [1.0], [str(k) for k in
                                                        range(jcfg.model.num_classes)])


def test_the_port_drops_an_overflowed_box_from_the_records():
    """The port's detections_to_records drops the 4 detections whose boxes
    overflowed and keeps the finite one beside them, as the JAX package
    would write it (its box divided by the ratio and rounded, unclipped)."""
    jcfg, tdets, _ = _overflowed_detections()
    names = [str(k) for k in range(jcfg.model.num_classes)]
    (recs,) = tinference.detections_to_records(tdets, [0.5], names)
    boxes, valid = tdets.boxes[0].numpy(), tdets.valid[0].numpy()
    finite = np.where(valid & np.isfinite(boxes).all(-1))[0]
    assert len(finite) == 1 and len(recs) == 1
    (rec,) = recs
    assert rec["bbox"].tolist() == [int(round(x / 0.5)) for x in boxes[finite[0]]]
    assert rec["cls_name"] == "0" and np.isfinite(rec["prob"])
