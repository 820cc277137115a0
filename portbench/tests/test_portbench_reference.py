"""The plain reference against the port's own CPU path at a tiny size, both
in float32, on the same weights and inputs: detection and one joint train
step agree to rounding. (On the card the port computes in bf16; the limits
there come from chip readings, PERF.md.)"""

from __future__ import annotations

import pytest
import torch

from portbench import compare, inputs, weights
from portbench.modes import detect as detect_mode
from portbench.modes import train as train_mode
from portbench.reference import ops, paths
from portbench.tests import tiny

SEED = 2 ** 31 + 77


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(4)


def _f32(ctx):
    ctx.found["spec"]["compute_dtype"] = "float32"
    return ctx


def _f32_model(port, spec, W):
    """The port's model in f32 throughout: its RPN's 3x3 conv runs in bf16
    whatever the configuration says, as the JAX package's does."""
    m = port.model(spec, W, "cpu")
    m.rpn_head.rpn_conv1.dtype = torch.float32
    return m


def test_detection_matches_reference():
    from portbench import port
    ctx = _f32(tiny.ctx("r50_kitti.detect_b16", seed=SEED))
    spec, mix = ctx.spec, ctx.mix
    W = weights.make_weights(spec, SEED, "cpu")
    det = port.detect_fn(spec, _f32_model(port, spec, W), "cpu")
    frames = inputs.frames(spec, mix, SEED, 0, "cpu")
    hw = torch.as_tensor(inputs.frame_hw(spec, mix))
    with port.ProposalTap() as tap:
        d = det(frames, hw)
    got = (d.boxes, d.scores, d.classes, d.valid)
    ref = paths.detect(W, spec, frames, hw, "f32", props=(tap.calls[0]["boxes"],
                                                         tap.calls[0]["valid"]))
    g = compare.det_gaps(got, ref["roi_prob"], ref["roi_boxes"])
    assert max(g["score"]) < 1e-3 and max(g["box"]) < 1e-4
    assert g["count"] == ref["dets"][3].sum(1).tolist()
    assert max(detect_mode.rpn_gaps(tap.calls[0], ref)) < 1e-4
    grid = paths.Grid(spec, "cpu")
    assert detect_mode.proposal_diffs(spec, grid, tap.calls[0], hw, spec["infer_pre_nms"],
                                      spec["infer_post_nms"]) == 0
    assert detect_mode.decode_diffs(spec, tap.calls[0], got, "cpu") == 0


@pytest.mark.parametrize("cell", ["r50_kitti.detect_b16", "vgg16_kitti.detect_b16"])
def test_decode_matches_reference_slot_by_slot(cell):
    """At the configuration's own precision, the reference's decode of the
    port's decode inputs gives the port's detections exactly."""
    from portbench import port
    ctx = tiny.ctx(cell, seed=SEED)
    spec, mix = ctx.spec, ctx.mix
    W = weights.make_weights(spec, SEED, "cpu")
    det = port.detect_fn(spec, port.model(spec, W, "cpu"), "cpu")
    frames = inputs.frames(spec, mix, SEED, 0, "cpu")
    with port.ProposalTap() as tap:
        d = det(frames, torch.as_tensor(inputs.frame_hw(spec, mix)))
    assert int(d.valid.sum()) > 0
    assert detect_mode.decode_diffs(spec, tap.calls[0], (d.boxes, d.scores, d.classes, d.valid),
                                    "cpu") == 0


def test_joint_step_matches_reference():
    from portbench import port
    ctx = _f32(tiny.ctx("r50_kitti.train_joint_b16", seed=SEED))
    spec = ctx.spec
    ctx.found["mix"]["followed_steps"] = 1
    W = weights.make_weights(spec, SEED, "cpu")
    m = _f32_model(port, spec, W)
    step, opt = port.train_step(spec, m, "cpu")
    W0, batches, draws = train_mode.followed_inputs(ctx)
    with port.ProposalTap() as tap:
        out = step(batches[0], port.Draws(*draws[0]))
    first = {k: float(t.norm()) for k, t in port.optimizer_traces(opt).items()}
    losses, trace, after, _ = paths.train(
        W0, spec, batches, draws, [(tap.calls[0]["boxes"], tap.calls[0]["valid"])], "f32")
    assert abs(float(out["loss"]) - losses[0]["loss"]) < 1e-5 * abs(losses[0]["loss"])
    names = sorted(trace)
    assert names == sorted(first)
    gaps = compare.norm_gaps(first, {k: float(trace[k].norm()) for k in names}, names)
    assert max(gaps.values()) < 1e-4
    got = dict(m.named_parameters())
    change = compare.norm_gaps({k: float((got[k].detach() - W0[k]).norm()) for k in names},
                               {k: float((after[k] - W0[k]).norm()) for k in names}, names)
    assert max(change.values()) < 1e-4


def test_draws_are_the_reference_samplers_fields():
    from portbench import port
    assert ops.Draws._fields == port.Draws._fields
