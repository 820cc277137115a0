"""A run of each cell at a tiny size on the CPU, its look for a card
skipped, with the timed path broken underneath (portbench/faults.py) or
the reference put in its place at float8 (the control): ``correct`` comes
out false, against the cell's own limits. The data-parallel path runs
two ranks as gloo processes."""

from __future__ import annotations

import time

import pytest
import torch

from portbench import faults, harness
from portbench.tests import tiny

CASES = [(c, f) for c in ("r50_kitti.detect_b16", "vgg16_kitti.detect_b16")
         for f in faults.DETECT]
CASES += [("r50_kitti.train_joint_b16", f) for f in ("unchanged", "half")]
DEVICE = {"platform": "cpu", "kind": "cpu", "count": 1}


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(4)


def _correct(found, ranks) -> bool:
    out, _, bad = harness.result(found, ranks, time.time(), False, DEVICE)
    assert not bad
    return out["correct"]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_is_not_correct(cell, fault):
    ctx = tiny.ctx(cell, fault=fault)
    assert not _correct(ctx.found, [harness.run_rank(ctx)])


@pytest.mark.parametrize("fault", ["no_exchange", "half", "unchanged"])
def test_data_parallel_fault_is_not_correct(fault):
    # the joint-training cell's files run data parallel: two ranks of two rows
    found = tiny.found("r50_kitti.train_joint_b16", batch=4)
    args = {"seed": 2 ** 31 + 9, "seconds": 0.5, "trace": False, "t0": time.time(),
            "fault": fault}
    assert not _correct(found, harness.run_ranks(found, args, 2, "gloo"))


@pytest.mark.parametrize("cell", ["r50_kitti.detect_b16", "r50_kitti.train_joint_b16"])
def test_control_is_not_correct(cell):
    """The reference at float8 e4m3 in the system's place."""
    ctx = tiny.ctx(cell)
    checks = harness.mode(ctx.mix).control(ctx, "fp8")
    assert not harness.verdict(ctx.found["limits"], [checks])[0]
