"""The metric arithmetic on made-up inputs: the idle share of a trace, the
95th percentile over all calls, the FLOP count of one convolution, and
the K1 and K4 byte counts, each against a count by hand."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import harness, readers
from portbench.counts import flops, kernels
from portbench.counts.peaks import BF16_FLOPS, F32_FLOPS, HBM_BYTES_PER_S
from portbench.reference import nets

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU


class Event:
    def __init__(self, name, dev, start, dur):
        self._n, self._d, self._s, self._u = name, dev, start, dur

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._u


class Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {"kineto_results": type(
            "K", (), {"events": staticmethod(lambda: events)})()})()


def test_idle_share_from_spans():
    """Window 1000 ns; kernels over [100, 300], [250, 400] (overlapping) and
    [700, 800]: busy 400 ns, idle 60%, the longest gap [400, 700] while the
    host ran aten::nonzero."""
    ev = [Event(harness.Tracer.NAME, CPU, 0, 1000),
          Event("k_a", CUDA, 100, 200), Event("k_b", CUDA, 250, 150),
          Event("k_c", CUDA, 700, 100), Event("aten::nonzero", CPU, 350, 400),
          Event("outside", CUDA, 2000, 50)]
    d = harness.digest(Prof(ev))
    assert d["window_s"] == pytest.approx(1e-6)
    assert d["busy_s"] == pytest.approx(4e-7)
    t = {"window_s": d["window_s"], "busy_s": d["busy_s"]}
    assert readers.idle_pct(t) == pytest.approx(60.0)
    assert d["breakdown"]["idle_gaps"][0] == ["aten::nonzero", pytest.approx(3e-7)]
    assert [n for n, _ in d["breakdown"]["device_ops"]] == ["k_a", "k_b", "k_c"]


def test_p95_over_all_calls():
    lat = list(range(1, 101))
    assert harness.quantile(lat, 0.95) == pytest.approx(95.05)
    assert harness.quantile(lat, 0.95) == pytest.approx(float(np.quantile(lat, 0.95)))


def test_flops_of_one_conv_by_hand():
    """A 3x3 conv, 4 -> 8 channels, on a 10x12 map: 2 x 8 x 10 x 12 x 36."""
    x = torch.empty((1, 4, 10, 12), device="meta")
    w = torch.empty((8, 4, 3, 3), device="meta")
    got = flops._count(lambda: nets.conv(x, w, None, 1, (1, 1, 1, 1), "f32"))
    assert got == 2 * 8 * 10 * 12 * 4 * 9


def test_model_flops_grow_with_rois():
    spec = harness.find_cell(harness.HERE.parent, "r50_kitti.detect_b16")["spec"]
    spec = dict(spec, canvas_h=64, canvas_w=96)
    a, b = flops.per_image(spec, False, 10), flops.per_image(spec, False, 20)
    head = b - a  # ten ROIs more through stage 5 and the outputs
    assert head > 0 and a - head > 0


def test_k1_bytes_by_hand():
    """One 7x7 ROI [0, 0, 7, 7] with P=7: source i * (7/7) = i, so the taps
    are rows and columns 0-6 with no upper taps: 49 map pixels read, 49
    output vectors written, the ROI's 16 bytes."""
    rois = np.array([[[0, 0, 7, 7]]], np.float32)
    assert kernels.touched_pixels(rois, 16, 16, 7) == 49
    c, elem = 8, 2
    nbytes = (49 * c + 49 * c) * elem + 16
    want = max(nbytes / HBM_BYTES_PER_S, 9 * 49 * c / F32_FLOPS)
    assert kernels.roi_align_fwd((1, 16, 16, c), rois, 7, elem) == pytest.approx(want)


def test_k1_touched_pixels_union():
    """Two ROIs of one image that overlap count their shared pixels once."""
    rois = np.array([[[0, 0, 7, 7], [3, 0, 10, 7]]], np.float32)
    assert kernels.touched_pixels(rois, 16, 16, 7) == 7 * 10


def test_k4_and_stem_bounds_by_hand():
    assert kernels.topk(2, 1000, 10) == pytest.approx(
        max((2 * 1000 * 4 + 2 * 10 * 12) / HBM_BYTES_PER_S, 2000 / F32_FLOPS))
    out = 64 * 4 * 5
    assert kernels.stem_conv(3 * 8 * 10, out) == pytest.approx(
        max((3 * 8 * 10 + 147 * 64 + out) * 2 / HBM_BYTES_PER_S, 2 * out * 147 / BF16_FLOPS))


def test_roofline_reader_and_nothing_to_read():
    t = {"kernels": [("void topk_select<1>(float*)", 1e-5), ("topk_merge", 1e-5),
                     ("other", 1.0)],
         "inputs": {"k4": [(2, 1000, 10)]}}
    want = 100 * kernels.topk(2, 1000, 10) / 2e-5
    assert readers.roofline_pct(t, "k4") == pytest.approx(want)
    assert readers.roofline_pct(t, "k1_fwd") is None
    assert readers.roofline_pct(dict(t, kernels=[]), "k4") is None


def test_nms_pairs_by_hand():
    """Tile 4, 8 boxes: phase 1 costs 6 pairs and keeps 2; phase 2 costs
    4 x 2 + 6."""
    keep = np.array([[1, 0, 1, 0, 1, 1, 0, 0]], bool)
    valid = np.ones_like(keep)
    assert kernels.nms_pairs(keep, valid, 4, 0) == 6 + 8 + 6
    assert kernels.nms_pairs(keep, valid, 4, 2) == 6
