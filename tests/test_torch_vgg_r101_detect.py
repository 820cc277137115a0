"""The port's detection path on VGG16 and ResNet-101 against
faster_rcnn_tpu.inference, on the CPU.

Both packages run each network at tiny_config shapes in float32 on the same
weights (tests/test_torch_vgg_r101.build) and the same uint8 canvases, with
per-image extents; the JAX side runs its Pallas stem and RoI-align kernels
in interpret mode.
"""

import numpy as np
import pytest
import torch

from faster_rcnn_tpu import inference as jinf
from faster_rcnn_tpu_torch import inference as tinf
from tests.test_torch_vgg_r101 import build


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("network", ["vgg16", "resnet101"])
def test_detect_matches_jax(network):
    jcfg, tc, model, vnp, tmodel = build(network, seed=1)
    rng = np.random.RandomState(7)
    img = rng.randint(0, 256, (3, 64, 96, 3)).astype(np.uint8)
    hw = np.array([[64, 96], [48, 80], [33, 50]], np.int32)
    want = jinf.make_detect_fn(jcfg, model, vnp, uint8_input=True)(img, hw)
    got = tinf.make_detect_fn(tc, tmodel, device="cpu")(img, hw)
    assert tuple(got.boxes.shape) == (3, tc.rpn.infer_post_nms, 4)
    wv = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), wv)
    assert wv.sum() > 0
    np.testing.assert_array_equal(got.classes.numpy()[wv], np.asarray(want.classes)[wv])
    np.testing.assert_allclose(got.boxes.numpy()[wv], np.asarray(want.boxes)[wv], rtol=0,
                               atol=1e-2)
    np.testing.assert_allclose(got.scores.numpy()[wv], np.asarray(want.scores)[wv], rtol=1e-4)
