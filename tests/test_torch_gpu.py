"""The port's CUDA kernels against their plain PyTorch versions, on a card.

These tests skip without CUDA. On a machine with an NVIDIA GPU (sm_90a) and
nvcc, run them without the JAX-side conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

The file imports nothing of JAX, so it runs where JAX is not installed.
"""

from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from chip_smoke import (EPILOGUE_CASES, _bits_differing, conv1_integer_mismatches,
                        epilogue_inputs, kitti_batch, topk_adversarial)
from faster_rcnn_tpu_torch import _build, config
from faster_rcnn_tpu_torch.models import resnet
from faster_rcnn_tpu_torch.models.detector import init_model
from faster_rcnn_tpu_torch.models.resnet import Conv1
from faster_rcnn_tpu_torch.ops import conv1_cuda, nms, nms_cuda, roi_align_cuda, sort, sort_cuda
from faster_rcnn_tpu_torch.ops.frozen_epilogue_cuda import frozen_epilogue, frozen_epilogue_plain
from faster_rcnn_tpu_torch.parallel.freeze import make_optimizer
from faster_rcnn_tpu_torch.train import device_cache, pipeline, trainer
from portbench import harness, port, weights

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
    """W/2 = 12, 100, 65 and 145 (not multiples of the 16-pixel tile; 145
    spans two column blocks), H/2 = 17 (two row blocks, the second of one
    row)."""
    rng = np.random.RandomState(0)
    for b, h, w in [(2, 16, 24), (1, 64, 200), (2, 38, 130), (3, 34, 290)]:
        x = torch.tensor(rng.uniform(-100, 100, (b, h, w, 3)), dtype=dtype, device=cuda)
        k = torch.tensor(rng.standard_normal((7, 7, 3, 64)) * 0.1, dtype=dtype, device=cuda)
        got = conv1_cuda.conv1(x, k)
        assert got.shape == (b, h // 2, w // 2, 64) and got.dtype == dtype
        _close(got, conv1_cuda.conv1_plain(x, k), rel)


@pytest.mark.parametrize("b,h,w", [(2, 2, 74), (2, 16, 24), (3, 34, 290), (16, 608, 1504)])
def test_conv1_bf16_kernel_bit_exact_on_integers(cuda, b, h, w):
    """Integers in [-8, 8] times weights in [-4, 4]: every product and sum
    is exact in f32 (|sum| <= 147 * 32), so the tensor cores' sums equal
    the plain version's whatever their order, and round to the same bf16;
    at H = 2 every tap row but three is padding; the last shape is the
    paths' canvas."""
    assert conv1_integer_mismatches((b, h, w, 3), cuda, seed=b + h + w) == 0


def test_conv1_bf16_kernel_at_the_kitti_shape(cuda):
    rng = np.random.RandomState(5)
    x = torch.tensor(rng.uniform(-1, 1, (16, 608, 1504, 3)), dtype=torch.bfloat16, device=cuda)
    k = torch.tensor(rng.standard_normal((7, 7, 3, 64)) * 0.1, dtype=torch.bfloat16, device=cuda)
    _close(conv1_cuda.conv1(x, k), conv1_cuda.conv1_plain(x, k), 1e-2)


@pytest.mark.parametrize("bad", [float("nan"), float("inf")])
def test_conv1_bf16_kernel_keeps_a_bad_pixel_in_its_windows(cuda, bad):
    """One pixel (all 3 channels) at input column 19 = 2*7 + 5: the padding
    taps kk 21..23 of output column 7 lie on it, so only their masking keeps
    it out of that column. Outputs whose 7x7 window misses the pixel stay
    finite and equal the plain version bit for bit (integer inputs)."""
    g = torch.Generator(device=cuda).manual_seed(6)
    x = torch.randint(-8, 9, (2, 16, 40, 3), generator=g, device=cuda).to(torch.bfloat16)
    w = torch.randint(-4, 5, (7, 7, 3, 64), generator=g, device=cuda).to(torch.bfloat16)
    x[1, 9, 19] = bad
    got, want = conv1_cuda.conv1(x, w), conv1_cuda.conv1_plain(x, w)
    fin = torch.isfinite(want)
    assert not fin.all() and fin[0].all()
    assert torch.equal(torch.isfinite(got), fin)
    assert torch.equal(got[fin].view(torch.int16), want[fin].view(torch.int16))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c", [64, 512])
@pytest.mark.parametrize("p", [7, 5, 9])
def test_roi_align_kernel_matches_plain(cuda, dtype, c, p):
    """K1 forward bit for bit against its plain version and its numpy model
    (tests/test_torch_roi_align_fwd.py), in bf16 and f32, on ROIs with the
    edge cases among them: one-pixel ROIs, ROIs on the map's last row and
    column, crops under 7 and multiples of 7; at C = 64 (one chunk, part
    empty) and 512 (two chunks in bf16, four in f32); at the paths' P = 7
    and the generic instantiation (5, and 9: two columns for some warps)."""
    from tests.test_torch_roi_align_fwd import kernel_model, path_rois

    rng = np.random.RandomState(1)
    b, h, w, r = 2, 19, 33, 40
    feat = torch.tensor(rng.standard_normal((b, h, w, c)) * 4, dtype=dtype, device=cuda)
    rois_np = path_rois(rng, b, r, h, w)
    rois = torch.tensor(rois_np, device=cuda)
    got = roi_align_cuda.roi_align(feat, rois, p)
    assert got.shape == (b, r, p, p, c) and got.dtype == dtype
    assert _bits_differing(got, roi_align_cuda.roi_align_plain(feat, rois, p)) == 0
    assert torch.equal(got[0, 0], feat[0, 3, 4].expand(p, p, c))
    model, _ = kernel_model(feat.float().cpu().numpy(), rois_np, p, 16 // feat.element_size())
    assert _bits_differing(got.cpu(), torch.from_numpy(model).to(dtype)) == 0


def nms_case(kind: str, b: int, n: int, n_valid: int, seed: int = 2):
    """Seeded (b, n, 4) f32 boxes in score order and (b, n) bool valid
    (the first n_valid of each image) for K3:
      "clustered": integer boxes 2-30 px wide around 30 centres in 90x90 px,
        long suppression chains;
      "class_offset": the same scaled 16x and shifted by class * 16384, as
        the final class-offset NMS sees them;
      "identical": one box repeated, so the first suppresses all others;
      "disjoint": a grid of 6x6 px boxes 10 px apart, so every box survives;
      "nan": clustered, with one coordinate of every fifth box NaN in image
        0 and every coordinate of every third box NaN in image 1."""
    rng = np.random.RandomState(seed)
    if kind in ("clustered", "class_offset", "nan"):
        centers = rng.uniform(0, 90, (b, 30, 2))
        c = (np.take_along_axis(centers, rng.randint(0, 30, (b, n, 1)), 1)
             + rng.normal(0, 3, (b, n, 2)))
        wh = rng.uniform(2, 30, (b, n, 2))
        boxes = np.round(np.concatenate([c - wh / 2, c + wh / 2], -1))
        if kind == "class_offset":
            boxes = boxes * 16.0 + rng.randint(0, 9, (b, n, 1)) * 16384.0
        if kind == "nan":
            rows = np.arange(0, n, 5)
            boxes[0, rows, rows % 4] = np.nan
            boxes[1, ::3] = np.nan
    elif kind == "identical":
        boxes = np.broadcast_to(np.array([10.0, 20.0, 50.0, 45.0]), (b, n, 4)).copy()
    elif kind == "disjoint":
        i = np.arange(n)
        x, y = (i % 128) * 10.0, (i // 128) * 10.0
        boxes = np.broadcast_to(np.stack([x, y, x + 5, y + 5], -1), (b, n, 4)).copy()
    else:
        raise ValueError(kind)
    valid = np.zeros((b, n), bool)
    valid[:, :n_valid] = True
    return boxes.astype(np.float32), valid


@pytest.mark.parametrize("kind,b,n,n_valid,tile,iou,enough", [
    ("clustered", 3, 8192, 8000, 512, 0.7, 300),     # the detect call's proposals
    ("class_offset", 3, 384, 300, 128, 0.5, 300),   # its final NMS
    ("clustered", 3, 1024, 700, 256, 0.5, 0),
    ("clustered", 3, 256, 0, 64, 0.5, 10),
    ("clustered", 16, 6144, 6000, 512, 0.7, 2000),  # the train step's proposals
    ("clustered", 33, 6144, 6000, 512, 0.7, 2000),  # clusters of 3
    ("clustered", 140, 1024, 1000, 256, 0.7, 300),  # more images than SMs: two waves
    ("identical", 4, 2048, 2048, 512, 0.7, 300),
    ("disjoint", 4, 2048, 2048, 256, 0.7, 0),
    ("nan", 4, 2048, 1900, 512, 0.7, 0),
    ("clustered", 4, 2048, 2000, 256, 0.0, 0),      # thresh 0: no divide is skipped wrongly
    ("clustered", 4, 1024, 1000, 32, 0.5, 300),
    ("clustered", 2, 4096, 4000, 1024, 0.7, 0),
])
def test_nms_kernel_bit_exact(cuda, kind, b, n, n_valid, tile, iou, enough):
    """The whole mask, the tail after the stopping tile included."""
    boxes, valid = nms_case(kind, b, n, n_valid)
    bx = torch.tensor(boxes, device=cuda)
    vd = torch.tensor(valid, device=cuda)
    got = nms_cuda.nms_keep_mask(bx, vd, iou, tile=tile, enough=enough)
    want = nms.nms_sorted_mask_blocked(bx, vd, iou, tile=tile, enough=enough)
    assert torch.equal(got, want)
    if kind == "disjoint":
        assert bool(got.all())
    if kind == "identical":
        assert got.sum(1).tolist() == [1] * b


def test_nms_kernel_repeats_bit_for_bit(cuda):
    """50 runs at the train shape give the same bits: a missed cluster
    barrier between the blocks' writes and the walk shows as a rare
    difference."""
    boxes, valid = nms_case("clustered", 16, 6144, 6000)
    bx, vd = torch.tensor(boxes, device=cuda), torch.tensor(valid, device=cuda)
    first = nms_cuda.nms_keep_mask(bx, vd, 0.7, tile=512, enough=2000)
    for _ in range(50):
        assert torch.equal(nms_cuda.nms_keep_mask(bx, vd, 0.7, tile=512, enough=2000), first)


def _topk_same_bits(scores, k):
    v, i = sort_cuda.topk_sorted(scores, k)
    pv, pi = sort.topk_sorted_plain(scores, k)
    assert torch.equal(i, pi)
    assert torch.equal(v.view(torch.int32), pv.view(torch.int32))
    return v, i


@pytest.mark.parametrize("b,n,k", [
    (16, 64296, 128), (16, 64296, 256), (16, 64296, 6000), (16, 64296, 8000),  # the paths
    (16, 64296, 6001), (16, 64296, 1), (16, 64296, 1024), (16, 64296, 1025),
    (1, 64296, 8000), (1, 64296, 128), (3, 16384, 16384), (9, 5000, 4999), (9, 700, 300),
])
def test_topk_kernel_bit_exact(cuda, b, n, k):
    """The train step's and the detect call's shapes, and the edges: k = 1,
    k = N, k not a power of two, one or two chunks, B = 1 (62 slices a row),
    N below a slice; every row of chip_smoke.topk_adversarial (masks,
    plateaus holding the k-th key over every slice boundary, signed zeros,
    +inf, an all-NaN row, NaN of both signs)."""
    x = topk_adversarial(k, max(b, 9), n, seed=k)[-b:]  # B < 9 takes the plateau rows
    _topk_same_bits(torch.tensor(x, device=cuda), k)


def test_topk_kernel_repeats_bit_for_bit(cuda):
    """200 runs of the detect shape give the same bits: a missed fence or a
    ticket read too early between the blocks of a row shows as a rare wrong
    bin."""
    scores = torch.tensor(topk_adversarial(8000), device=cuda)
    v0, i0 = _topk_same_bits(scores, 8000)
    for _ in range(200):
        v, i = sort_cuda.topk_sorted(scores, 8000)
        assert torch.equal(i, i0)
        assert torch.equal(v.view(torch.int32), v0.view(torch.int32))


def _bwd_rois(rng, b, h, w, r):
    x1 = rng.randint(0, w - 2, (b, r))
    y1 = rng.randint(0, h - 2, (b, r))
    x2 = np.maximum(np.minimum(x1 + rng.randint(1, 20, (b, r)), w - 1), x1 + 1)
    y2 = np.maximum(np.minimum(y1 + rng.randint(1, 12, (b, r)), h - 1), y1 + 1)
    return np.stack([x1, y1, x2, y2], -1).astype(np.float32)


@pytest.mark.parametrize("dtype,rel", [(torch.bfloat16, 1e-2), (torch.float32, 1e-5)])
def test_roi_align_backward_kernel_matches_plain(cuda, dtype, rel):
    """The gather kernel's fixed-order f32 sums against the plain
    scatter-add: they agree to f32 rounding, and in bf16 to one rounding of
    the result."""
    rng = np.random.RandomState(3)
    b, h, w, c, r = 2, 19, 33, 64, 40
    rois = _bwd_rois(rng, b, h, w, r)
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


@pytest.mark.parametrize("kind", ["sampled", "small_crops", "zero_frac", "last_row_and_column",
                                  "untouched_rows", "hot_row", "flat_rois", "vgg_channels",
                                  "chunks_and_many_rois", "rois_512_wide"])
def test_roi_align_backward_kernel_is_its_model_bit_for_bit(cuda, kind):
    """The kernel against the numpy model of its algorithm
    (tests/test_torch_roi_align_bwd.py), on the model's edge cases: f32 bit
    for bit, and bf16 the model's f32 sums of the bf16 values rounded once."""
    from tests.test_torch_roi_align_bwd import kernel_model, model_bf16, roi_case

    shape, rois, g = roi_case(kind)
    _, h, w, _ = shape
    t_rois = torch.tensor(rois, device=cuda)
    got = roi_align_cuda.roi_align_backward(torch.tensor(g, device=cuda), t_rois, shape, 7)
    want = kernel_model(g, rois, h, w, 4)[0]
    assert np.array_equal(got.cpu().numpy().view(np.int32), want.view(np.int32))
    got16 = roi_align_cuda.roi_align_backward(torch.tensor(g, device=cuda).bfloat16(), t_rois,
                                              shape, 7)
    assert torch.equal(got16.cpu().view(torch.int16), model_bf16(g, rois, h, w).view(torch.int16))


@pytest.mark.parametrize("kind", ["train_shape", "hot_row", "rois_512"])
def test_roi_align_backward_kernel_repeats_bit_for_bit(cuda, kind):
    """Twenty calls give the same bits (the kernel has no atomics), the
    plain version agrees, and bf16 is the f32 result rounded once; at the
    train step's shape (16 x 64 ROIs over a 38x94x1024 bf16 map), on a hot
    row (every ROI of an image the same and smaller than 7x7, so a few rows
    take all 64 x 7 x 2 hits), and with 512 ROIs an image (four batches)."""
    rng = np.random.RandomState(7)
    b, h, w, c, r = 16, 38, 94, 1024, 64
    if kind == "rois_512":
        b, r = 4, 512
    rois = _bwd_rois(rng, b, h, w, r)
    if kind == "hot_row":
        c = 256
        rois[:] = rois[:, :1] * 0 + np.array([10, 20, 13, 22], np.float32)
    rois = torch.tensor(rois, device=cuda)
    g = torch.tensor(rng.standard_normal((b, r, 7, 7, c)), dtype=torch.bfloat16, device=cuda)
    first = roi_align_cuda.roi_align_backward(g, rois, (b, h, w, c), 7)
    for _ in range(20):
        again = roi_align_cuda.roi_align_backward(g, rois, (b, h, w, c), 7)
        assert torch.equal(again.view(torch.int16), first.view(torch.int16))
    _close(first, roi_align_cuda.roi_align_backward_plain(g, rois, (b, h, w, c),
                                                          torch.bfloat16, 7), 1e-2)
    got32 = roi_align_cuda.roi_align_backward(g.float(), rois, (b, h, w, c), 7)
    assert torch.equal(first.view(torch.int16), got32.bfloat16().view(torch.int16))


@pytest.mark.parametrize("kind", ["sgd", "adam"])
def test_optimizer_built_over_a_cpu_model_steps_on_cuda(cuda, kind):
    """The optimizer's state is made at its first step on the parameters'
    device: a model moved to the card after the optimizer was built (as
    make_joint_train_step moves it) takes two steps there, equal to the
    same steps on the CPU to f32 rounding."""
    def build():
        torch.manual_seed(0)
        m = torch.nn.Sequential(torch.nn.Linear(8, 4), torch.nn.Linear(4, 2))
        return m, make_optimizer(m, "resnet50", (), 0.1, optimizer=kind, weight_decay=1e-4,
                                 clip_grad_norm=1.0)
    ref, ref_opt = build()
    model, opt = build()
    model.to(cuda)
    rng = np.random.RandomState(0)
    for _ in range(2):
        for p, q in zip(ref.parameters(), model.parameters()):
            g = rng.standard_normal(tuple(p.shape)).astype(np.float32)
            p.grad, q.grad = torch.tensor(g), torch.tensor(g, device=cuda)
        ref_opt.step()
        opt.step()
    assert all(t.is_cuda for st in opt.state.values() for t in st.values())
    for p, q in zip(ref.parameters(), model.parameters()):
        torch.testing.assert_close(q.detach().cpu(), p.detach(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["sgd", "adam"])
@pytest.mark.parametrize("move_after_load", [False, True])
def test_optimizer_state_from_a_cpu_checkpoint_steps_on_cuda(cuda, tmp_path, kind,
                                                             move_after_load):
    """A checkpoint written from the CPU (utils/checkpoint.py) restores into
    an optimizer over a model on the card: the state goes to the card at
    the load, or, for a model moved after the load, at its first step; the
    count goes on, and the next steps equal the CPU's to f32 rounding."""
    from faster_rcnn_tpu_torch.utils import checkpoint as ckpt_lib

    def build():
        torch.manual_seed(0)
        m = torch.nn.Sequential(torch.nn.Linear(8, 4), torch.nn.Linear(4, 2))
        return m, make_optimizer(m, "resnet50", (), lambda c: 0.1 / (1 + c), optimizer=kind)

    rng = np.random.RandomState(0)

    def grads(*models):
        for ps in zip(*(m.parameters() for m in models)):
            g = rng.standard_normal(tuple(ps[0].shape)).astype(np.float32)
            for p in ps:
                p.grad = torch.tensor(g, device=p.device)

    ref, ref_opt = build()
    for _ in range(2):
        grads(ref)
        ref_opt.step()
    ckpt_lib.save(str(tmp_path), 2, {"model": ref.state_dict(), "optimizer": ref_opt.state_dict()})
    restored = ckpt_lib.restore(str(tmp_path))
    model, opt = build()
    if not move_after_load:
        model.to(cuda)
    model.load_state_dict(restored["model"])
    opt.load_state_dict(restored["optimizer"])
    assert opt.count == 2
    assert all(t.device == next(model.parameters()).device
               for st in opt.state.values() for t in st.values())
    model.to(cuda)
    for _ in range(2):
        grads(ref, model)
        ref_opt.step()
        opt.step()
    assert opt.count == 4 and all(t.is_cuda for st in opt.state.values() for t in st.values())
    for p, q in zip(ref.parameters(), model.parameters()):
        torch.testing.assert_close(q.detach().cpu(), p.detach(), rtol=1e-5, atol=1e-6)


def test_pinned_side_stream_transfer_equals_a_plain_copy(cuda):
    """The trainer's batch transfer (pinned host buffers, a non-blocking
    copy on a side stream that the compute stream waits for) gives the
    same tensors as .to(device), for the step that reads them at once. The
    copy stream is held up while a second batch of the same sizes is
    pinned: had the first batch's pinned blocks been handed on before its
    copy ran, the first batch would read the second's values."""
    first = _small_batch(4)
    second = dict(first, image=255 - first["image"], gt_boxes=first["gt_boxes"] + 1)
    stream = torch.cuda.Stream(cuda)
    with torch.cuda.stream(stream):
        torch.cuda._sleep(200_000_000)
    transfers = [trainer._put(b, cuda, stream) for b in (first, second)]
    for batch, transfer in zip((first, second), transfers):
        got = trainer._take(transfer, cuda)
        sums = {k: v.double().sum() for k, v in got.items()}  # read on the compute stream
        for k, v in batch.items():
            want = torch.from_numpy(v).to(cuda)
            assert got[k].is_cuda and got[k].dtype == want.dtype and torch.equal(got[k], want), k
            assert sums[k].item() == want.double().sum().item(), k


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
    flat = torch.zeros(1 + x.numel(), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):  # 2-byte offset: the kernel stages 4-byte words
        conv1_cuda.conv1(flat[1:].view(x.shape),
                         torch.zeros(7, 7, 3, 64, dtype=torch.bfloat16, device=cuda))
    with pytest.raises(TypeError):
        nms_cuda.nms_keep_mask(torch.zeros(1, 64, 4, dtype=torch.float64, device=cuda),
                               torch.ones(1, 64, dtype=torch.bool, device=cuda), 0.5, tile=64)
    with pytest.raises(ValueError):
        roi_align_cuda.roi_align(torch.zeros(1, 4, 4, 6, device=cuda),
                                 torch.zeros(1, 2, 4, device=cuda), 7)
    g = torch.zeros(1 + 2 * 7 * 7 * 8, dtype=torch.bfloat16, device=cuda)[1:].view(1, 2, 7, 7, 8)
    with pytest.raises(ValueError):  # 2-byte offset: the backward reads 16-byte vectors
        roi_align_cuda.roi_align_backward(g, torch.zeros(1, 2, 4, device=cuda), (1, 4, 4, 8), 7)
    sort_cuda.topk_sorted(torch.zeros(2, 100, device=cuda), 10)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["topk"] == before["topk"] + 1
    with pytest.raises(TypeError):
        sort_cuda.topk_sorted(torch.zeros(2, 100, dtype=torch.float64, device=cuda), 10)
    with pytest.raises(ValueError):
        sort_cuda.topk_sorted(torch.zeros(1, 40000, device=cuda), 20000)


def test_stem_without_bias_matches_plain(cuda):
    """ResNet-101's bias-free stem (Conv1(use_bias=False)) through the
    kernel, at a canvas of two row blocks and two column blocks."""
    rng = np.random.RandomState(8)
    stem = Conv1(use_bias=False).to(cuda)
    assert stem.bias is None
    with torch.no_grad():
        stem.weight.copy_(torch.tensor(rng.standard_normal((64, 3, 7, 7)) * 0.1))
        x = torch.tensor(rng.uniform(-100, 100, (2, 34, 290, 3)), dtype=torch.float32,
                         device=cuda)
        before = _build.LAUNCHES["conv1"]
        got = stem(x)
        torch.cuda.synchronize()
    assert _build.LAUNCHES["conv1"] == before + 1 and got.dtype == torch.bfloat16
    w_hwio = stem.weight.to(torch.bfloat16).permute(2, 3, 1, 0).contiguous()
    _close(got, conv1_cuda.conv1_plain(x.to(torch.bfloat16), w_hwio), 1e-2)


def test_roi_align_at_the_vgg_step2_input(cuda):
    """K1 forward and backward on a VGG16 step-2 input (16 x 64 ROIs over a
    38x94x512 bf16 map: two 256-channel chunks a map row) against their
    plain versions, the forward bit for bit in bf16 and in f32, the
    backward twice with the same bits, and on two of the images bit for bit
    against the numpy model of its algorithm."""
    from tests.test_torch_roi_align_bwd import model_bf16

    rng = np.random.RandomState(9)
    b, h, w, c, r = 16, 38, 94, 512, 64
    rois = _bwd_rois(rng, b, h, w, r)
    rois[:, r // 2:] = rois[:, :r - r // 2]  # repeated ROIs, as the sampler draws
    t_rois = torch.tensor(rois, device=cuda)
    feat = torch.tensor(rng.standard_normal((b, h, w, c)), dtype=torch.bfloat16, device=cuda)
    for f in (feat, feat.float()):
        assert _bits_differing(roi_align_cuda.roi_align(f, t_rois, 7),
                               roi_align_cuda.roi_align_plain(f, t_rois, 7)) == 0
    g = torch.tensor(rng.standard_normal((b, r, 7, 7, c)), dtype=torch.bfloat16, device=cuda)
    got = roi_align_cuda.roi_align_backward(g, t_rois, (b, h, w, c), 7)
    again = roi_align_cuda.roi_align_backward(g, t_rois, (b, h, w, c), 7)
    assert torch.equal(got.view(torch.int16), again.view(torch.int16))
    _close(got, roi_align_cuda.roi_align_backward_plain(g, t_rois, (b, h, w, c),
                                                        torch.bfloat16, 7), 1e-2)
    want = model_bf16(g[:2].float().cpu().numpy(), rois[:2], h, w)
    assert torch.equal(got[:2].cpu().view(torch.int16), want.view(torch.int16))


def _small_config(network: str) -> config.FasterRcnnConfig:
    """A 256x384 canvas with 4 anchor shapes: 1,536 anchors, more than the
    RPN sampler's top-k (256) and the proposals' (256) take, so both run
    the top-k kernel, as at the KITTI canvas."""
    return config.FasterRcnnConfig(
        anchors=config.AnchorConfig(scales=(16, 32), ratios=((1, 1), (2, 1))),
        rpn=config.RpnConfig(train_pre_nms=256, train_post_nms=64, infer_pre_nms=256,
                             infer_post_nms=32),
        det=config.DetConfig(num_rois=16),
        data=config.DataConfig(canvas_h=256, canvas_w=384, max_gt_boxes=8, resize_min=192,
                               resize_max=384),
        model=config.ModelConfig(network=network, num_classes=6, freeze_blocks=(1, 2)))


def _small_batch(b: int = 2) -> dict:
    rng = np.random.RandomState(3)
    boxes = np.zeros((b, 8, 4), np.float32)
    boxes[:, :3] = [[5, 5, 60, 80], [120, 40, 260, 160], [200, 100, 380, 250]]
    valid = np.zeros((b, 8), bool)
    valid[:, :3] = True
    return {"image": rng.randint(0, 256, (b, 256, 384, 3)).astype(np.uint8), "gt_boxes": boxes,
            "gt_class": np.ones((b, 8), np.int32), "gt_valid": valid,
            "img_hw": np.array([[256, 384]] * b, np.int32)}


@pytest.mark.parametrize("network", ["vgg16", "resnet101"])
def test_four_step_train_steps_run_on_cuda_by_default(cuda, network):
    """The RPN and detector steps, built without a device, run on the card
    through the kernels: the RPN step's sampler launches K4 twice; step 2
    launches K4 and K3 for the frozen RPN's proposals, K1 and the K1
    backward; step 4 all but the K1 backward."""
    cfg = _small_config(network)
    rpn = init_model(1, cfg)
    assert all(p.is_cuda for p in rpn.parameters())
    want = {1: {"topk": 2}, 2: {"topk": 1, "nms": 1, "roi_align": 1, "roi_align_bwd": 1},
            4: {"topk": 1, "nms": 1, "roi_align": 1}}
    if network == "resnet101":  # the bias-free stem, once per backbone run; the frozen
        # epilogue on every branch that runs without autograd: the frozen prefix (stem, stage
        # 2: 11 branches) of steps 1 and 2, and the frozen RPN's backbone (94) of steps 2 and 4
        want = {1: dict(want[1], conv1=1, frozen_epilogue=11),
                2: dict(want[2], conv1=2, frozen_epilogue=105),
                4: dict(want[4], conv1=1, frozen_epilogue=94)}
    for step in (1, 2, 4):
        model = init_model(0, cfg)
        fb, fm = trainer.step_freeze_spec(step, cfg)
        opt = make_optimizer(model, network, fb, 1e-3, freeze_modules=fm)
        if step == 1:
            run = pipeline.make_rpn_train_step(cfg, model, opt, fb, fm)
        else:
            run = pipeline.make_det_train_step(cfg, model, opt, rpn, heads_only=step == 4,
                                               freeze_blocks=fb, freeze_modules=fm)
        _build.reset_launches()
        metrics = run(_small_batch(), torch.Generator(device=cuda).manual_seed(step))
        torch.cuda.synchronize()
        got = {k: v for k, v in _build.LAUNCHES.items() if v}
        assert got == want[step], (step, got)
        assert all(v.is_cuda and bool(torch.isfinite(v).all()) for v in metrics.values())


def test_device_flip_on_cuda_is_the_cpu_flip(cuda):
    """The cache's flip and gather on the card equal the CPU's bit for bit:
    widths from 1 to the canvas's, padding that is not the mean pixel,
    invalid GT rows."""
    rng = np.random.RandomState(0)
    n, h, cw, g = 6, 40, 96, 5
    images = torch.tensor(rng.randint(0, 256, (n, h, cw, 3)), dtype=torch.uint8)
    hw = torch.tensor([[h, w] for w in (96, 1, 50, 95, 13, 96)], dtype=torch.int32)
    boxes = torch.tensor(rng.rand(n, g, 4) * cw, dtype=torch.float32)
    valid = torch.tensor(rng.rand(n, g) < 0.6)
    cls = torch.tensor(rng.randint(0, 5, (n, g)), dtype=torch.int32)
    flip = torch.tensor([True, True, False, True, True, False])
    got = device_cache.flip_batch(images.to(cuda), boxes.to(cuda), valid.to(cuda), hw.to(cuda),
                                  flip.to(cuda))
    want = device_cache.flip_batch(images, boxes, valid, hw, flip)
    for a, b in zip(got, want):
        assert a.is_cuda and torch.equal(a.cpu(), b)
    bucket = device_cache.DeviceBucket((h, cw), images, boxes, cls, valid, hw)
    on_card = device_cache.DeviceBucket((h, cw), *(t.to(cuda) for t in (
        images, boxes, cls, valid, hw)))
    ids, fl = torch.tensor([5, 0, 2, 2], dtype=torch.int32), torch.tensor([True, False, True, False])
    got = device_cache.gather_batch(on_card, ids.to(cuda), fl.to(cuda))
    want = device_cache.gather_batch(bucket, ids, fl)
    for k, t in want.items():
        assert got[k].is_cuda and torch.equal(got[k].cpu(), t), k


@pytest.mark.parametrize("network", ["vgg16", "resnet101"])
def test_cached_chunk_on_cuda_launches_what_its_steps_launch(cuda, network):
    """A chunk of 2 steps from a bucket on the card: each step launches
    every kernel its step launches fed batch by batch (the test above), and
    the metrics stay on the card."""
    cfg = _small_config(network)
    batch = _small_batch(b=3)
    bucket = device_cache.DeviceBucket((256, 384), *(
        torch.as_tensor(batch[k], device=cuda)
        for k in ("image", "gt_boxes", "gt_class", "gt_valid", "img_hw")))
    per_step = {1: {"topk": 2}, 2: {"topk": 1, "nms": 1, "roi_align": 1, "roi_align_bwd": 1},
                4: {"topk": 1, "nms": 1, "roi_align": 1}}
    if network == "resnet101":
        per_step = {1: dict(per_step[1], conv1=1, frozen_epilogue=11),
                    2: dict(per_step[2], conv1=2, frozen_epilogue=105),
                    4: dict(per_step[4], conv1=1, frozen_epilogue=94)}
    rpn = init_model(1, cfg)
    for step in (1, 2, 4):
        _, _, step_fn_for = trainer.setup_step(step, cfg, None, rpn.state_dict(), 0, cuda)
        run = device_cache.make_scan_train_fn(step_fn_for((256, 384))[0])
        idx = torch.tensor([[0, 1], [2, 0]], dtype=torch.int32, device=cuda)
        flip = torch.tensor([[False, True], [True, True]], device=cuda)
        _build.reset_launches()
        metrics = run(bucket, idx, flip, device_cache.chunk_generator(0, step, 0, cuda))
        torch.cuda.synchronize()
        got = {k: v for k, v in _build.LAUNCHES.items() if v}
        assert got == {k: 2 * v for k, v in per_step[step].items()}, (step, got)
        assert all(v.is_cuda and v.shape == (2,) and bool(torch.isfinite(v).all())
                   for v in metrics.values())


_VARIANTS = [(bias, scale, res, relu) for bias in (False, True) for scale in (False, True)
             for res in (False, True) for relu in (False, True)]


@pytest.mark.parametrize("label,shape,bias,scale,residual,relu", EPILOGUE_CASES)
def test_frozen_epilogue_bit_exact_at_the_path_shapes(cuda, label, shape, bias, scale, residual,
                                                      relu):
    """The stem's, stage 2's and stage 5's maps at B=16 and 300 ROIs,
    bf16, with NaN, infinities, signed zeros, subnormals and near-largest
    values among them (chip_smoke.epilogue_inputs)."""
    kw = dict(epilogue_inputs(shape, bias, scale, residual, torch.bfloat16, cuda), relu=relu)
    got = frozen_epilogue(**kw)
    assert _bits_differing(got, frozen_epilogue_plain(**kw)) == 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(3, 5, 7, 24), (7, 37, 61, 200)])
def test_frozen_epilogue_bit_exact_in_every_variant(cuda, shape, dtype):
    """Channel counts whose 16-byte vectors do not divide a block (3, 25 in
    bf16; 6, 50 in f32), a map too small to fill the grid and one the grid
    loops over, each variant of bias, scale, shortcut and ReLU."""
    for i, variant in enumerate(_VARIANTS):
        kw = dict(epilogue_inputs(shape, *variant[:3], dtype, cuda, seed=i), relu=variant[3])
        got = frozen_epilogue(**kw)
        assert _bits_differing(got, frozen_epilogue_plain(**kw)) == 0, variant


def test_frozen_epilogue_counts_launches_and_rejects_bad_input(cuda):
    kw = epilogue_inputs((2, 3, 5, 64), True, False, True, torch.bfloat16, cuda)
    before = _build.LAUNCHES["frozen_epilogue"]
    frozen_epilogue(**kw)
    assert _build.LAUNCHES["frozen_epilogue"] == before + 1
    bad = [dict(kw, y=kw["y"][..., :60]),                          # 60 channels: not 16 bytes
           dict(kw, y=kw["y"].transpose(1, 2).contiguous().transpose(1, 2)),  # not contiguous
           dict(kw, shortcut=kw["shortcut"].float()),
           dict(kw, conv_bias=kw["conv_bias"].float()),
           dict(kw, mean=kw["mean"].to(torch.bfloat16)),
           dict(kw, y=kw["y"].to(torch.float16))]
    for args in bad:
        with pytest.raises((ValueError, TypeError)):
            frozen_epilogue(**args)
    with pytest.raises(RuntimeError, match="no backward"):
        frozen_epilogue(**dict(kw, y=kw["y"].float().requires_grad_().to(torch.bfloat16)))
    assert _build.LAUNCHES["frozen_epilogue"] == before + 1


def test_resnet50_detect_with_and_without_the_epilogue(cuda):
    """One B=2 ResNet-50 detect call at the KITTI canvas through the frozen
    epilogue (inference mode), and the same call with every ResNet branch
    through Conv2d, FrozenAffine and the ReLU (as where the weights require
    grad): the same backbone map and detections, bit for bit. The
    benchmark's seeded weights: conv biases and batch norms away from the
    identity, and detections on noise frames."""
    spec = harness.find_cell(Path(__file__).resolve().parents[1], "r50_kitti.detect_b16")["spec"]
    model = port.model(spec, weights.make_weights(spec, 2 ** 31 + 17, cuda), cuda)
    detect = port.detect_fn(spec, model, cuda)
    img, hw = kitti_batch(np.random.RandomState(0), 2, config.kitti_config())
    x = pipeline.ingest_images(torch.as_tensor(img, device=cuda))

    def run():
        _build.reset_launches()
        with torch.inference_mode():
            feat = model.backbone(x)
        dets = detect(img, hw)
        torch.cuda.synchronize()
        return (feat, *dets), dict(_build.FROZEN_BRANCHES), _build.LAUNCHES["frozen_epilogue"]

    fused, branches, launched = run()
    assert branches == {"fused": 43 + 53, "plain": 0} and launched == 43 + 53
    with mock.patch.object(resnet, "_autograd_runs", lambda *args: True):
        plain, branches, launched = run()
    assert branches == {"fused": 0, "plain": 43 + 53} and launched == 0
    assert int(fused[-1].sum()) > 0  # detections to compare
    for a, b in zip(fused, plain):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert (_bits_differing(a, b) == 0 if a.is_floating_point() else torch.equal(a, b))
