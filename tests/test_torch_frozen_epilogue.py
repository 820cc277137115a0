"""The frozen epilogue on the CPU: its plain version against the module
chain it replaces (conv bias add, FrozenBatchNorm, ChannelScale, residual
add, ReLU) bit for bit; ResNet's backbone and stage-5 head with and without
autograd bit for bit; and which path each ResNet branch takes on the detect
call and the joint step. The kernel itself is held to the plain version on
the card (tests/test_torch_gpu.py)."""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from faster_rcnn_tpu_torch import _build
from faster_rcnn_tpu_torch import inference as tinf
from faster_rcnn_tpu_torch.models.detector import init_model
from faster_rcnn_tpu_torch.models.layers import ChannelScale, FrozenBatchNorm
from faster_rcnn_tpu_torch.models.resnet import ResNetBackbone, ResNetStage5
from faster_rcnn_tpu_torch.ops.frozen_epilogue_cuda import frozen_epilogue, frozen_epilogue_plain
from faster_rcnn_tpu_torch.parallel import freeze as tfreeze
from faster_rcnn_tpu_torch.train import pipeline as tpipe
from tests.test_torch_models import port_config
from tests.test_train_step import tiny_batch, tiny_config

# values no conv output should hold, and the ReLU's and roundings' edges
SPECIAL = [float("nan"), float("inf"), -float("inf"), -0.0, 0.0, 1e-40, -1e-40, 3e38, -3e38,
           1.0e-3]


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    as_int = torch.int16 if a.element_size() == 2 else torch.int32
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a.view(as_int),
                                                                     b.view(as_int))


def _random_state(module: torch.nn.Module, seed: int) -> None:
    """Weights that keep activations of order one, and batch-norm and scale
    statistics away from their identity values."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.dim() > 1:
                p.copy_(torch.randn(p.shape, generator=g) / p[0].numel() ** 0.5)
            elif name.endswith("scale"):
                p.copy_(torch.rand(p.shape, generator=g) * 0.4 + 0.2)
            else:
                p.copy_(torch.randn(p.shape, generator=g) * 0.1)
        for name, b in module.named_buffers():
            if name.endswith("var"):
                b.copy_(torch.rand(b.shape, generator=g) + 0.5)
            else:
                b.copy_(torch.randn(b.shape, generator=g) * 0.1)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("scale", [False, True])
@pytest.mark.parametrize("bias", [False, True])
def test_plain_version_is_the_module_chain(bias, scale, residual, relu, dtype):
    """Every variant, on values that include NaN, infinities, signed zeros,
    subnormals and magnitudes near the largest float."""
    c = 24
    g = torch.Generator().manual_seed(int(bias) + 2 * scale + 4 * residual + 8 * relu)
    y = (torch.randn((3, 5, 7, c), generator=g) * 4).to(dtype)
    y.view(-1)[:len(SPECIAL)] = torch.tensor(SPECIAL).to(dtype)
    shortcut = (torch.randn(y.shape, generator=g) * 4).to(dtype) if residual else None
    conv_bias = torch.randn(c, generator=g).to(dtype) if bias else None
    bn, sc = FrozenBatchNorm(c, dtype=dtype), ChannelScale(c, dtype=dtype)
    _random_state(bn, 1)
    _random_state(sc, 2)
    with torch.no_grad():
        want = y if conv_bias is None else y + conv_bias
        want = bn(want)
        if scale:
            want = sc(want)
        if residual:
            want = want + shortcut
        if relu:
            want = F.relu(want)
        args = (y, conv_bias, bn.mean, bn.inv(), bn.bias, sc.scale if scale else None,
                sc.bias if scale else None, shortcut, relu)
        assert _same_bits(frozen_epilogue_plain(*args), want)
        assert _same_bits(frozen_epilogue(*args), want)  # a CPU tensor: the plain version


def test_scale_and_its_bias_come_together():
    y = torch.zeros((2, 8))
    with pytest.raises(ValueError, match="together"):
        frozen_epilogue(y, None, torch.zeros(8), torch.ones(8), torch.zeros(8),
                        scale=torch.ones(8))


@pytest.mark.parametrize("depth,part,branches", [
    (50, "backbone", 1 + 10 + 13 + 19), (101, "backbone", 1 + 10 + 13 + 70),
    (50, "stage5", 10), (101, "stage5", 10)])
def test_resnet_bits_with_and_without_autograd(depth, part, branches):
    """Without autograd every branch (the stem; a block's three and its
    projection) takes the epilogue; with the weights requiring grad every
    branch takes Conv2d, FrozenAffine and the ReLU. The two give the same
    bits (bf16, the detection and training dtype)."""
    if part == "backbone":
        m, x = ResNetBackbone(depth), torch.randn((1, 64, 64, 3))
    else:
        m, x = ResNetStage5(depth), torch.randn((3, 7, 7, 1024)).to(torch.bfloat16)
    _random_state(m, depth)
    _build.reset_launches()
    with torch.no_grad():
        fused = m(x)
    assert _build.FROZEN_BRANCHES == {"fused": branches, "plain": 0}
    _build.reset_launches()
    plain = m(x)
    assert plain.requires_grad
    assert _build.FROZEN_BRANCHES == {"fused": 0, "plain": branches}
    assert bool(torch.isfinite(fused.float()).all())
    assert _same_bits(fused, plain.detach())


@pytest.fixture(scope="module")
def tiny():
    jcfg = tiny_config("resnet50")
    tc = port_config(jcfg)
    tc = tc.replace(model=dataclasses.replace(tc.model, freeze_blocks=(1, 2, 3)))
    batch = {k: np.array(v) for k, v in tiny_batch(jcfg, b=2, seed=3).items()}
    batch["image"] = np.random.RandomState(3).randint(0, 256, batch["image"].shape,
                                                      ).astype(np.uint8)
    return tc, batch


@pytest.mark.parametrize("path,network,want", [
    ("detect", "resnet50", {"fused": 53, "plain": 0}),
    ("joint", "resnet50", {"fused": 24, "plain": 29}),
    ("detect", "vgg16", {"fused": 0, "plain": 0}),
])
def test_branch_paths_of_a_call(tiny, path, network, want):
    """A ResNet-50 detect call: the stem, 42 branches of stages 2-4 and 10
    of stage 5 fused. A joint step with blocks 1-3 frozen: the frozen prefix
    (stem, stages 2 and 3: 24 branches) fused, the trained stage 4 (19) and
    stage 5 (10) through the modules. VGG16 has no frozen batch norm."""
    tc, batch = tiny
    tc = tc.replace(model=dataclasses.replace(tc.model, network=network))
    model = init_model(0, tc, "cpu")
    _build.reset_launches()
    if path == "detect":
        tinf.make_detect_fn(tc, model, device="cpu")(batch["image"], batch["img_hw"])
    else:
        opt = tfreeze.make_optimizer(model, network, tc.model.freeze_blocks, 1e-3)
        step = tpipe.make_joint_train_step(tc, model, opt, device="cpu")
        step(batch, torch.Generator().manual_seed(0))
    assert _build.FROZEN_BRANCHES == want
    assert not any(_build.LAUNCHES.values())  # the CPU launches no kernel
