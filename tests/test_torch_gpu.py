"""The port's CUDA kernels against their plain PyTorch versions, on a card.

These tests skip without CUDA. On a machine with an NVIDIA GPU (sm_90a) and
nvcc, run them without the JAX-side conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

The file imports nothing of JAX, so it runs where JAX is not installed.
"""

import numpy as np
import pytest
import torch

from faster_rcnn_tpu_torch import _build
from faster_rcnn_tpu_torch.ops import conv1_cuda, nms, nms_cuda, roi_align_cuda, sort, sort_cuda

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no interpret mode)")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, rel):
    err = (got.float() - want.float()).abs().max().item()
    assert err <= rel * want.float().abs().max().item(), err


@pytest.mark.parametrize("dtype,rel", [(torch.bfloat16, 1e-2), (torch.float32, 1e-5)])
def test_conv1_kernel_matches_plain(cuda, dtype, rel):
    rng = np.random.RandomState(0)
    for b, h, w in [(2, 16, 24), (1, 64, 200), (2, 38, 130)]:
        x = torch.tensor(rng.uniform(-100, 100, (b, h, w, 3)), dtype=dtype, device=cuda)
        k = torch.tensor(rng.standard_normal((7, 7, 3, 64)) * 0.1, dtype=dtype, device=cuda)
        got = conv1_cuda.conv1(x, k)
        assert got.shape == (b, h // 2, w // 2, 64) and got.dtype == dtype
        _close(got, conv1_cuda.conv1_plain(x, k), rel)


@pytest.mark.parametrize("dtype,rel", [(torch.bfloat16, 1e-2), (torch.float32, 1e-5)])
def test_roi_align_kernel_matches_plain(cuda, dtype, rel):
    rng = np.random.RandomState(1)
    b, h, w, c, r = 2, 19, 33, 64, 40
    feat = torch.tensor(rng.standard_normal((b, h, w, c)), dtype=dtype, device=cuda)
    x1 = rng.randint(0, w - 2, (b, r))
    y1 = rng.randint(0, h - 2, (b, r))
    x2 = np.maximum(np.minimum(x1 + rng.randint(1, 20, (b, r)), w - 1), x1 + 1)
    y2 = np.maximum(np.minimum(y1 + rng.randint(1, 12, (b, r)), h - 1), y1 + 1)
    rois = np.stack([x1, y1, x2, y2], -1).astype(np.float32)
    rois[0, 0] = [4, 3, 5, 4]  # a single pixel
    rois = torch.tensor(rois, device=cuda)
    got = roi_align_cuda.roi_align(feat, rois, 7)
    _close(got, roi_align_cuda.roi_align_plain(feat, rois, 7), rel)
    assert torch.equal(got[0, 0], feat[0, 3, 4].expand(7, 7, c))


@pytest.mark.parametrize("n,n_valid,tile,iou,enough,scale", [
    (8192, 8000, 512, 0.7, 300, 1.0),
    (384, 300, 128, 0.5, 300, 16.0),
    (1024, 700, 256, 0.5, 0, 1.0),
    (256, 0, 64, 0.5, 10, 1.0),
])
def test_nms_kernel_bit_exact(cuda, n, n_valid, tile, iou, enough, scale):
    rng = np.random.RandomState(2)
    b = 3
    centers = rng.uniform(0, 90, (b, 30, 2))
    c = np.take_along_axis(centers, rng.randint(0, 30, (b, n, 1)), 1) + rng.normal(0, 3, (b, n, 2))
    wh = rng.uniform(2, 30, (b, n, 2))
    boxes = np.round(np.concatenate([c - wh / 2, c + wh / 2], -1)) * scale
    boxes += rng.randint(0, 9, (b, n, 1)) * 16384.0 * (scale > 1)
    valid = np.zeros((b, n), bool)
    valid[:, :n_valid] = True
    bx = torch.tensor(boxes.astype(np.float32), device=cuda)
    vd = torch.tensor(valid, device=cuda)
    got = nms_cuda.nms_keep_mask(bx, vd, iou, tile=tile, enough=enough)
    want = nms.nms_sorted_mask_blocked(bx, vd, iou, tile=tile, enough=enough)
    assert torch.equal(got, want)


@pytest.mark.parametrize("k", [128, 256, 6000, 8000])
def test_topk_kernel_bit_exact(cuda, k):
    """The train step's and the detect call's shapes: 16 rows of 64,296
    scores with -1e30 masks, tie plateaus and signed zeros."""
    rng = np.random.RandomState(k)
    x = rng.uniform(size=(16, 64296)).astype(np.float32)
    x[rng.uniform(size=x.shape) < 0.3] = -1e30
    x[1, rng.randint(0, 64296, 3000)] = 0.5
    x[2, :5000] = -0.0
    x[2, 5000:9000] = 0.0
    x[3] = -1e30
    x[4, 64000:] = np.inf
    scores = torch.tensor(x, device=cuda)
    v, i = sort_cuda.topk_sorted(scores, k)
    pv, pi = sort.topk_sorted_plain(scores, k)
    assert torch.equal(i, pi)
    assert torch.equal(v.view(torch.int32), pv.view(torch.int32))


@pytest.mark.parametrize("dtype,rel", [(torch.bfloat16, 1e-2), (torch.float32, 1e-5)])
def test_roi_align_backward_kernel_matches_plain(cuda, dtype, rel):
    """f32 atomics in a run-dependent order against the plain scatter-add:
    the sums agree to f32 rounding, and in bf16 to one rounding of the
    result."""
    rng = np.random.RandomState(3)
    b, h, w, c, r = 2, 19, 33, 64, 40
    x1 = rng.randint(0, w - 2, (b, r))
    y1 = rng.randint(0, h - 2, (b, r))
    x2 = np.maximum(np.minimum(x1 + rng.randint(1, 20, (b, r)), w - 1), x1 + 1)
    y2 = np.maximum(np.minimum(y1 + rng.randint(1, 12, (b, r)), h - 1), y1 + 1)
    rois = np.stack([x1, y1, x2, y2], -1).astype(np.float32)
    rois[1, :10] = rois[1, 10:20]  # repeated ROIs, as the sampler draws
    rois = torch.tensor(rois, device=cuda)
    g = torch.tensor(rng.standard_normal((b, r, 7, 7, c)), dtype=dtype, device=cuda)
    got = roi_align_cuda.roi_align_backward(g, rois, (b, h, w, c), 7)
    want = roi_align_cuda.roi_align_backward_plain(g, rois, (b, h, w, c), dtype, 7)
    assert got.dtype == dtype
    _close(got, want, rel)
    feat = torch.tensor(rng.standard_normal((b, h, w, c)), dtype=dtype, device=cuda,
                        requires_grad=True)
    roi_align_cuda.roi_align(feat, rois, 7).backward(g)
    _close(feat.grad, want, rel)


def test_conv1_backward_matches_plain(cuda):
    rng = np.random.RandomState(4)
    x = torch.tensor(rng.uniform(-100, 100, (2, 38, 130, 3)), dtype=torch.float32, device=cuda)
    w = torch.tensor(rng.standard_normal((7, 7, 3, 64)) * 0.1, dtype=torch.float32, device=cuda,
                     requires_grad=True)
    g = torch.tensor(rng.standard_normal((2, 19, 65, 64)), dtype=torch.float32, device=cuda)
    conv1_cuda.conv1(x, w).backward(g)
    (want,) = torch.autograd.grad(conv1_cuda.conv1_plain(x, w), w, g)
    _close(w.grad, want, 1e-5)


def test_wrappers_count_launches_and_reject_bad_input(cuda):
    before = dict(_build.LAUNCHES)
    x = torch.zeros(1, 8, 8, 3, dtype=torch.bfloat16, device=cuda)
    conv1_cuda.conv1(x, torch.zeros(7, 7, 3, 64, dtype=torch.bfloat16, device=cuda))
    torch.cuda.synchronize()
    assert _build.LAUNCHES["conv1"] == before["conv1"] + 1
    with pytest.raises(TypeError):
        conv1_cuda.conv1(x.half(), torch.zeros(7, 7, 3, 64, dtype=torch.half, device=cuda))
    with pytest.raises(TypeError):
        nms_cuda.nms_keep_mask(torch.zeros(1, 64, 4, dtype=torch.float64, device=cuda),
                               torch.ones(1, 64, dtype=torch.bool, device=cuda), 0.5, tile=64)
    with pytest.raises(ValueError):
        roi_align_cuda.roi_align(torch.zeros(1, 4, 4, 6, device=cuda),
                                 torch.zeros(1, 2, 4, device=cuda), 7)
    sort_cuda.topk_sorted(torch.zeros(2, 100, device=cuda), 10)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["topk"] == before["topk"] + 1
    with pytest.raises(TypeError):
        sort_cuda.topk_sorted(torch.zeros(2, 100, dtype=torch.float64, device=cuda), 10)
    with pytest.raises(ValueError):
        sort_cuda.topk_sorted(torch.zeros(1, 40000, device=cuda), 20000)
