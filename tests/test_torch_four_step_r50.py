"""The port's 4-step scheme's RPN and detector steps against faster_rcnn_tpu
on ResNet-50, on the CPU (VGG16's, with the helpers, are in
tests/test_torch_four_step.py).

Both packages run ResNet-50 at tiny_config shapes in float32 (frozen
prefix at stage 3) on the same weights: the port's seeded init with redrawn
batch norms (as tests/test_torch_train.py builds them), and a frozen RPN from
JAX's init at PRNGKey(43); the same batch and the draws of the JAX steps'
unfolded keys, two steps each. The JAX side runs its RoI-align Pallas kernel
in interpret mode.
"""

import dataclasses

import jax
import pytest
import torch

from faster_rcnn_tpu_torch.models.detector import init_model
from tests.test_torch_four_step import (RPN_STEP_HELD, RPN_STEP_LOSS_RTOL, STEPS, check_frozen,
                                        check_metrics, check_params, numpy_variables, run_steps)
from tests.test_torch_models import port_config, redraw_norm_layers
from tests.test_torch_train import tiny_train_config, to_flax_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def r50_runs():
    cfg = tiny_train_config()
    cfg = cfg.replace(det=dataclasses.replace(cfg.det, roi_align_impl="pallas_interpret"))
    vnp = redraw_norm_layers(to_flax_numpy(init_model(0, port_config(cfg), "cpu").state_dict()), 0)
    rpn = numpy_variables(jax.random.PRNGKey(43), cfg)
    return {s: run_steps(cfg, vnp, s, rpn_vnp=rpn, seed=7 if s in (1, 3) else 17)
            for s in (1, 2, 3, 4)}


@pytest.mark.parametrize("spec", [1, 3])
def test_rpn_step_matches_jax(r50_runs, spec):
    run = r50_runs[spec]
    check_metrics(run, ("rpn_cls", "rpn_reg", "loss"), RPN_STEP_LOSS_RTOL)
    check_params(run, RPN_STEP_HELD)
    trains = {n for n, lab in run["labels"].items() if lab == "train"}
    # step 1: stage 4 trains (freeze_blocks (1, 2, 3)); step 3: the RPN head alone
    assert any(n.startswith("backbone.res4") for n in trains) == (spec == 1)
    assert all(n.startswith(("backbone.res4", "rpn_head.")) for n in trains)


@pytest.mark.parametrize("spec", [2, 4])
def test_det_step_matches_jax(r50_runs, spec):
    run = r50_runs[spec]
    check_metrics(run, ("det_cls", "det_reg", "loss"))
    check_params(run)
    assert run["got"][0]["det_reg"] > 0


@pytest.mark.parametrize("spec", [1, 2, 3, 4])
def test_frozen_params_bit_identical_and_without_grad(r50_runs, spec):
    run = r50_runs[spec]
    check_frozen(run)
    bn = [n for n in run["labels"] if ".bn" in n]
    assert bn and all(run["labels"][n] == "frozen" for n in bn)


def test_roi_align_backward_runs_in_step_2_alone(r50_runs):
    """Step 2 trains stage 4 through the RoI-align backward; step 4's RoI
    align reads the frozen RPN's map, so its backward never runs and only
    the head takes a gradient."""
    assert r50_runs[2]["bwd_calls"] == STEPS
    assert "backbone.res4a.res4a_branch2a.weight" in r50_runs[2]["grads_seen"][0]
    assert r50_runs[4]["bwd_calls"] == 0
    assert all(n.startswith("det_head.") for seen in r50_runs[4]["grads_seen"] for n in seen)
