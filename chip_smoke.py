#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (faster_rcnn_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run on any error:
  1. card: name, power limit, device count;
  2. build: nvcc for sm_90a of every kernel, with the ptxas report;
  3. kernels: each kernel against its plain PyTorch version on the card, on
     inputs captured from the two paths below (ResNet-50 KITTI, B=16): the
     detection path and the joint train step. Each reports its time, the
     plain version's time, a PyTorch library call's time where one
     computes the same function, and the bound from the H100's published
     peaks;
  4. detect: full-width ResNet-50 KITTI detection (608x1504 canvases, B=16,
     seeded random weights) through make_detect_fn, with the launch count of
     every kernel over the timed batches, a torch.profiler table of one
     batch (chiprun_out/detect_profile.txt) and the time of each stage;
  5. train: make_joint_train_step at kitti_config(), B=16, SGD with
     momentum: 2 warm-up steps, then timed steps with the launch count of
     every kernel, the losses, the time of each stage from CUDA events, and
     a torch.profiler table of one step (chiprun_out/train_profile.txt);
  6. whole paths, kernels against plain versions: detection and one joint
     step at B=2 on the card in f32, and both on a small canvas against the
     CPU's plain path;
  7. a JSON line listing every kernel, then the JSON result line.

It needs CUDA and the faster_rcnn_tpu_torch package beside it; without
either it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

from faster_rcnn_tpu_torch import _build, inference
from faster_rcnn_tpu_torch.config import kitti_config
from faster_rcnn_tpu_torch.models import resnet
from faster_rcnn_tpu_torch.models.detector import FasterRCNN, init_model
from faster_rcnn_tpu_torch.ops import conv1_cuda, nms, nms_cuda, roi_align_cuda, sort, sort_cuda
from faster_rcnn_tpu_torch.ops import proposals as prop_ops
from faster_rcnn_tpu_torch.parallel.freeze import make_optimizer
from faster_rcnn_tpu_torch.train import pipeline

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12         # dense bf16 tensor-core peak
F32_FLOPS = 67e12           # f32 outside the tensor cores
IOU_OPS = 25                # f32 operations of one +1-convention IoU and its compare
LERP_OPS = 9                # f32 operations of one bilinear output value
SCATTER_OPS = 10            # f32 operations of one cotangent value's 4-tap scatter
OUT_DIR = "chiprun_out"
BATCHES = 3                 # timed detect batches of 16
TRAIN_WARMUP, TRAIN_STEPS = 2, 5
# launches of each kernel in one detect call and in one joint train step
PER_DETECT = {"conv1": 1, "roi_align": 1, "roi_align_bwd": 0, "nms": 2, "topk": 1}
PER_STEP = {"conv1": 1, "roi_align": 1, "roi_align_bwd": 1, "nms": 1, "topk": 3}
SOURCES = {"conv1": ("conv1.cu", "faster_rcnn_tpu/ops/conv1_pallas.py:262"),
           "roi_align": ("roi_align.cu", "faster_rcnn_tpu/ops/roi_align_pallas.py:178"),
           "roi_align_bwd": ("roi_align.cu", "faster_rcnn_tpu/ops/roi_align_pallas.py:213"),
           "nms": ("nms.cu", "faster_rcnn_tpu/ops/nms_pallas.py:153"),
           "topk": ("topk.cu", "faster_rcnn_tpu/ops/sort_pallas.py:115")}

KITTI_HW = (453, 1500)      # a 375x1242 KITTI frame under the 600/1500 resize
KITTI_RATIO = 453 / 375


def log(*args) -> None:
    print(*args, flush=True)


def bound_ms(nbytes: float, ops: float, peak: float):
    t_mem, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return max(t_mem, t_ops) * 1e3, ("bytes" if t_mem >= t_ops else "operations")


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@contextlib.contextmanager
def uncounted():
    """Launches made to compare or time a kernel do not count."""
    saved = dict(_build.LAUNCHES)
    try:
        yield
    finally:
        _build.LAUNCHES.update(saved)


@contextlib.contextmanager
def plain_versions():
    """Route the detection path and the train step through the kernels'
    plain versions (for the whole-path comparison only; the package itself
    never does this). Autograd through the plain forwards is the plain
    backwards."""
    with mock.patch.object(resnet, "conv1_kernel", conv1_cuda.conv1_plain), \
            mock.patch.object(inference, "roi_align", roi_align_cuda.roi_align_plain), \
            mock.patch.object(pipeline, "roi_align", roi_align_cuda.roi_align_plain), \
            mock.patch.object(nms_cuda, "nms_keep_mask", nms.nms_sorted_mask_blocked), \
            mock.patch.object(sort_cuda, "topk_sorted", sort.topk_sorted_plain):
        yield


@contextlib.contextmanager
def recording(calls: dict):
    """Record the inputs of every kernel wrapper's calls (uncounted), so the
    kernels are checked on the data the paths give them."""
    patches = [(resnet, "conv1_kernel", "conv1", conv1_cuda.conv1),
               (inference, "roi_align", "roi_align", roi_align_cuda.roi_align),
               (pipeline, "roi_align", "roi_align", roi_align_cuda.roi_align),
               (roi_align_cuda, "roi_align_backward", "roi_align_bwd",
                roi_align_cuda.roi_align_backward),
               (nms_cuda, "nms_keep_mask", "nms", nms_cuda.nms_keep_mask),
               (sort_cuda, "topk_sorted", "topk", sort_cuda.topk_sorted)]
    with contextlib.ExitStack() as stack:
        stack.enter_context(uncounted())
        for mod, attr, name, fn in patches:
            stack.enter_context(mock.patch.object(mod, attr, _recording(calls, name, fn)))
        yield


# --------------------------------------------------------------------------
# phase 1-2
# --------------------------------------------------------------------------


def phase_card() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    info = {"smi": smi, "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "torch": torch.__version__,
            "cuda": torch.version.cuda}
    log(smi)
    log(f"[card] {info}")
    return info


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.lib()
    log(f"[build] kernels ready in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.build_info.get('seconds', 0.0):.2f} s, "
        f"cached={_build.build_info.get('cached')})")
    for src, text in _build.build_info.get("ptxas", {}).items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"[ptxas {src}] {line.strip()}")


# --------------------------------------------------------------------------
# phase 3: kernels against plain versions at the main-path shapes
# --------------------------------------------------------------------------


def _rel_err(got: torch.Tensor, want: torch.Tensor):
    err = (got.float() - want.float()).abs().max().item()
    return err, want.float().abs().max().item()


def _case(label, ok, err, ms, plain, library, nbytes, ops, peak, **extra) -> dict:
    bms, by = bound_ms(nbytes, ops, peak)
    return dict(case=label, ok=bool(ok), max_abs_err=err, ms=ms, plain_ms=plain,
                library_ms=library, bound_ms=bms, bound_by=by, **extra)


def _log_case(name, c, what) -> None:
    lib = "none" if c["library_ms"] is None else f"{c['library_ms']:.4f} ms"
    log(f"[kernel {name} {c['case']}] {what}: max_abs_err={c['max_abs_err']:.4g} ok={c['ok']} "
        f"kernel {c['ms']:.4f} ms, plain {c['plain_ms']:.4f} ms, library {lib}, "
        f"bound {c['bound_ms']:.6f} ms ({c['bound_by']})")


def check_conv1(label, x, wt) -> dict:
    with uncounted():
        got = conv1_cuda.conv1(x, wt)
        want = conv1_cuda.conv1_plain(x, wt)
        torch.cuda.synchronize()
        err, ref = _rel_err(got, want)
        ms = time_ms(lambda: conv1_cuda.conv1(x, wt), 20)
    plain = time_ms(lambda: conv1_cuda.conv1_plain(x, wt), 3, warmup=1)
    # cuDNN on the same work: bf16, channels_last, the input padded beforehand
    xp = torch.nn.functional.pad(x.permute(0, 3, 1, 2), (2, 3, 2, 3)).contiguous(
        memory_format=torch.channels_last)
    w_oihw = wt.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    library = time_ms(lambda: torch.nn.functional.conv2d(xp, w_oihw, stride=2), 20)
    nbytes = x.numel() * 2 + wt.numel() * 2 + got.numel() * 2
    c = _case(label, err <= 1e-2 * ref, err, ms, plain, library, nbytes,
              2.0 * got.numel() * 147, BF16_FLOPS, limit=1e-2 * ref)
    _log_case("conv1", c, f"{tuple(x.shape)}->{tuple(got.shape)} {x.dtype}, limit 1e-2*max|ref|")
    return c


def _taps(starts, crops, p: int, limit: int) -> list:
    """Per ROI, the map rows (or columns) its P output cells weigh with a
    nonzero weight: the kernel's tap arithmetic in f32 (the upper tap only
    where its fraction is above zero)."""
    src = np.arange(p, dtype=np.float32)[None] * (crops[:, None] / np.float32(p))
    lo = np.floor(src)
    hi = np.minimum(lo + 1, crops[:, None] - 1)
    lo_abs = np.clip(lo + starts[:, None], 0, limit - 1).astype(np.int64)
    hi_abs = np.clip(hi + starts[:, None], 0, limit - 1).astype(np.int64)
    return [np.unique(np.concatenate([a, b[f > 0]]))
            for a, b, f in zip(lo_abs, hi_abs, src - lo)]


def touched_pixels(rois: torch.Tensor, h: int, w: int, p: int) -> int:
    """Map pixels that RoI align must read for these ROIs (the union over
    each image's ROIs): its bound counts these bytes, since the work
    depends on the ROIs."""
    total = 0
    for img in rois.cpu().numpy().astype(np.float32):
        mask = np.zeros((h, w), bool)
        for y, x in zip(_taps(img[:, 1], img[:, 3] - img[:, 1], p, h),
                        _taps(img[:, 0], img[:, 2] - img[:, 0], p, w)):
            mask[np.ix_(y, x)] = True
        total += int(mask.sum())
    return total


def check_roi_align(label, feat, rois, p) -> dict:
    feat, rois = feat.detach().contiguous(), rois.contiguous()
    with uncounted():
        got = roi_align_cuda.roi_align(feat, rois, p)
        want = roi_align_cuda.roi_align_plain(feat, rois, p)
        torch.cuda.synchronize()
        err, ref = _rel_err(got, want)
        ms = time_ms(lambda: roi_align_cuda.roi_align(feat, rois, p), 20)
    plain = time_ms(lambda: roi_align_cuda.roi_align_plain(feat, rois, p), 3, warmup=1)
    _, h, w, c = feat.shape
    pixels = touched_pixels(rois, h, w, p)
    nbytes = pixels * c * feat.element_size() + rois.numel() * 4 + got.numel() * 2
    c = _case(label, err <= 1e-2 * ref, err, ms, plain, None, nbytes, LERP_OPS * got.numel(),
              F32_FLOPS, limit=1e-2 * ref, map_pixels_read=pixels)
    _log_case("roi_align", c, f"{tuple(feat.shape)} x {tuple(rois.shape)} -> {tuple(got.shape)}")
    return c


def check_roi_align_bwd(label, grad, rois, shape, p) -> dict:
    """The scatter kernel against autograd of the plain gather form, in the
    path's dtype (limit 1e-2 of max|ref|: the atomics and the plain
    scatter sum in different orders, and then one bf16 rounding) and in f32
    (limit 1e-5 of max|ref|: only the order of the f32 sums differs)."""
    with uncounted():
        got = roi_align_cuda.roi_align_backward(grad, rois, shape, p)
        want = roi_align_cuda.roi_align_backward_plain(grad, rois, shape, grad.dtype, p)
        torch.cuda.synchronize()
        err, ref = _rel_err(got, want)
        g32 = grad.float()
        err32, ref32 = _rel_err(roi_align_cuda.roi_align_backward(g32, rois, shape, p),
                                roi_align_cuda.roi_align_backward_plain(g32, rois, shape,
                                                                        torch.float32, p))
        del g32
        ms = time_ms(lambda: roi_align_cuda.roi_align_backward(grad, rois, shape, p), 10)
    plain = time_ms(lambda: roi_align_cuda.roi_align_backward_plain(grad, rois, shape,
                                                                    grad.dtype, p), 2, warmup=1)
    nbytes = grad.numel() * 2 + rois.numel() * 4 + got.numel() * 2
    ok = err <= 1e-2 * ref and err32 <= 1e-5 * ref32
    c = _case(label, ok, err, ms, plain, None, nbytes, SCATTER_OPS * grad.numel(), F32_FLOPS,
              limit=1e-2 * ref, f32_err=err32, f32_limit=1e-5 * ref32)
    _log_case("roi_align_bwd", c, f"{tuple(grad.shape)} -> {tuple(got.shape)} {grad.dtype}, "
              f"f32 err {err32:.4g} (limit {1e-5 * ref32:.4g})")
    return c


def nms_pairs(keep: np.ndarray, valid: np.ndarray, tile: int, enough: int):
    """IoU pairs the blocked algorithm evaluates on these inputs, and the
    tile phases it runs: per phase, the tile against every earlier survivor
    plus its own upper triangle, until ``enough`` survivors exist."""
    pairs, phases = 0, []
    for k, v in zip(keep, valid):
        kept, n = 0, 0
        for off in range(0, k.shape[0], tile):
            if enough > 0 and kept >= enough:
                break
            pairs += tile * kept + tile * (tile - 1) // 2
            kept += int((k[off:off + tile] & v[off:off + tile]).sum())
            n += 1
        phases.append(n)
    return pairs, phases


def check_nms(label, args, kw) -> dict:
    boxes, valid, iou = args
    tile, enough = kw["tile"], kw["enough"]
    run = lambda: nms_cuda.nms_keep_mask(boxes, valid, iou, tile=tile, enough=enough)  # noqa: E731
    with uncounted():
        got = run()
        want = nms.nms_sorted_mask_blocked(boxes, valid, iou, tile=tile, enough=enough)
        torch.cuda.synchronize()
        mismatches = int((got != want).sum())  # bit for bit, the tail included
        ms = time_ms(run, 20)
    plain = time_ms(lambda: nms.nms_sorted_mask_blocked(boxes, valid, iou, tile=tile,
                                                         enough=enough), 2, warmup=1)
    keep_np, valid_np = got.cpu().numpy(), valid.cpu().numpy()
    pairs, phases = nms_pairs(keep_np, valid_np, tile, enough)
    nbytes = boxes.numel() * 4 + valid.numel() + got.numel()
    c = _case(label, mismatches == 0, float(mismatches), ms, plain, None, nbytes,
              IOU_OPS * pairs, F32_FLOPS, shape=list(boxes.shape), pairs=pairs,
              tile_phases=phases, kept=keep_np.sum(1).tolist())
    _log_case("nms", c, f"{tuple(boxes.shape)} tile {tile} iou {iou} enough {enough}: "
              f"mismatches={mismatches}, valid/img {valid_np.sum(1).tolist()}, IoU pairs={pairs}, "
              f"tile phases/img {phases}")
    return c


def check_topk(label, scores, k) -> dict:
    """Bit for bit against the stable sort; the library call is that sort
    alone, ``torch.sort(stable=True)``."""
    with uncounted():
        v, i = sort_cuda.topk_sorted(scores, k)
        pv, pi = sort.topk_sorted_plain(scores, k)
        torch.cuda.synchronize()
        mismatches = int((i != pi).sum()) + int((v.view(torch.int32) != pv.view(torch.int32)).sum())
        ms = time_ms(lambda: sort_cuda.topk_sorted(scores, k), 20)
    plain = time_ms(lambda: sort.topk_sorted_plain(scores, k), 10)
    library = time_ms(lambda: torch.sort(scores, dim=-1, descending=True, stable=True), 10)
    b, n = scores.shape
    c = _case(label, mismatches == 0, float(mismatches), ms, plain, library,
              scores.numel() * 4 + b * k * 12, b * n, F32_FLOPS, shape=[b, n], k=k)
    _log_case("topk", c, f"{tuple(scores.shape)} k={k}: mismatches={mismatches}")
    return c


def check_kernels(calls: dict, path: str) -> dict:
    """Every kernel call a path made, against its plain version: {kernel:
    [cases]}. ``calls`` comes from one recorded run of the path."""
    out = {}
    for args, _ in calls.get("conv1", []):
        out.setdefault("conv1", []).append(check_conv1(path, *args))
    for args, _ in calls.get("roi_align", []):
        out.setdefault("roi_align", []).append(check_roi_align(path, *args))
    for args, _ in calls.get("roi_align_bwd", []):
        out.setdefault("roi_align_bwd", []).append(check_roi_align_bwd(path, *args))
    labels = {"detect": ("proposal NMS", "final NMS"), "train": ("proposal NMS",)}[path]
    for label, (args, kw) in zip(labels, calls.get("nms", [])):
        out.setdefault("nms", []).append(check_nms(f"{path} {label}", args, kw))
    labels = {"detect": ("proposals",),
              "train": ("RPN sampler pos", "RPN sampler neg", "proposals")}[path]
    for label, (args, _) in zip(labels, calls.get("topk", [])):
        out.setdefault("topk", []).append(check_topk(f"{path} {label} k={args[1]}", *args))
    bad = [f"{k} {c['case']}" for k, cases in out.items() for c in cases if not c["ok"]]
    if bad:
        raise RuntimeError(f"kernels disagree with their plain versions: {bad}")
    return out


def kernel_entries(train_cases: dict, detect_cases: dict, train_launches: dict,
                   detect_launches: dict) -> list:
    """The kernels line: per kernel the sums over one train step's launches
    (this slice's path) and, under "detect", over one detect call's."""
    def total(cases):
        if not cases:
            return None
        lib = [c["library_ms"] for c in cases]
        return {"ms": sum(c["ms"] for c in cases), "plain_ms": sum(c["plain_ms"] for c in cases),
                "bound_ms": sum(c["bound_ms"] for c in cases),
                "bound_by": cases[0]["bound_by"],
                "library_ms": None if None in lib else sum(lib),
                "max_abs_err": max(c["max_abs_err"] for c in cases)}

    out = []
    for name, (src, replaces) in SOURCES.items():
        entry = {"name": name, "route": "cuda", "source": f"faster_rcnn_tpu_torch/csrc/{src}",
                 "replaces": replaces, "launches": train_launches[name],
                 **total(train_cases[name])}
        det = total(detect_cases.get(name))
        entry["detect"] = None if det is None else dict(det, launches=detect_launches[name])
        out.append(entry)
    return out


# --------------------------------------------------------------------------
# phase 4-5: the detection path
# --------------------------------------------------------------------------


def kitti_batch(rng, b, cfg):
    h, w = cfg.data.canvas
    img = np.zeros((b, h, w, 3), np.uint8)
    img[:, :KITTI_HW[0], :KITTI_HW[1]] = rng.randint(0, 256, (b,) + KITTI_HW + (3,))
    return img, np.tile(np.array([KITTI_HW], np.int32), (b, 1))


def check_dets(dets, b, d, num_classes) -> None:
    assert dets.boxes.shape == (b, d, 4) and dets.scores.shape == (b, d), dets.boxes.shape
    assert dets.classes.shape == (b, d) and dets.valid.shape == (b, d)
    v = dets.valid
    assert bool(torch.isfinite(dets.boxes[v]).all()) and bool(torch.isfinite(dets.scores[v]).all())
    assert bool(((dets.classes[v] >= 0) & (dets.classes[v] < num_classes - 1)).all())
    assert bool(((dets.scores[v] > 0) & (dets.scores[v] <= 1)).all())


def _recording(calls: dict, name: str, fn):
    def wrapped(*args, **kw):
        calls.setdefault(name, []).append((args, kw))
        return fn(*args, **kw)
    return wrapped


class KittiDetect:
    """ResNet-50 at kitti_config() with seeded random weights, B=16 uint8
    canvases holding a 453x1500 image each, and the detect function."""

    def __init__(self, rng, dev, b: int = 16):
        self.cfg = kitti_config()
        self.b = b
        self.model = init_model(0, self.cfg, dev)
        self.detect = inference.make_detect_fn(self.cfg, self.model, dev)
        img, hw = kitti_batch(rng, b, self.cfg)
        self.images = torch.tensor(img, device=dev)
        self.img_hw = torch.tensor(hw, device=dev)

    def capture(self):
        """One uncounted detect call that records every kernel wrapper's
        inputs. Returns (calls, seconds of this first call)."""
        calls: dict = {}
        with recording(calls):
            t0 = time.perf_counter()
            self.detect(self.images, self.img_hw)
            torch.cuda.synchronize()
            first = time.perf_counter() - t0
        return calls, first


def device_busy(prof) -> dict:
    """From the trace's device events: the window from the first kernel's
    start to the last one's end, and the share of it in which any ran."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        return {"window_ms": None, "busy_share": None}  # the trace saw no device work
    busy, (lo, hi) = 0.0, spans[0]
    for start, end in spans[1:]:
        if start > hi:
            busy, lo = busy + hi - lo, start
        hi = max(hi, end)
    busy += hi - lo
    window = max(end for _, end in spans) - spans[0][0]
    return {"window_ms": window / 1e3, "busy_share": busy / window}


def phase_detect(run: KittiDetect, first: float) -> dict:
    cfg, b, detect, images, img_hw = run.cfg, run.b, run.detect, run.images, run.img_hw
    batches = BATCHES
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    for _ in range(batches):
        dets = detect(images, img_hw)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    check_dets(dets, b, cfg.rpn.infer_post_nms, cfg.model.num_classes)
    recs = inference.detections_to_records(dets, [KITTI_RATIO] * b,
                                           [f"c{i}" for i in range(cfg.model.num_classes)])
    info = {"img_per_s": b * batches / sec, "batch_ms": sec / batches * 1e3,
            "first_call_s": first, "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": launches, "valid_per_image": dets.valid.sum(1).tolist(),
            "records": sum(len(r) for r in recs)}
    log(f"[detect] ResNet-50 KITTI B={b} {images.shape[1]}x{images.shape[2]}, "
        f"{batches} batches: {info}")
    want = {k: v * batches for k, v in PER_DETECT.items()}
    if launches != want:
        raise RuntimeError(f"kernel launches {launches}, expected {want}")
    os.makedirs(OUT_DIR, exist_ok=True)
    with uncounted(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        detect(images, img_hw)
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
    with open(os.path.join(OUT_DIR, "detect_profile.txt"), "w") as f:
        f.write(table)
    log("[profile] top kernels by device time:\n" + "\n".join(table.splitlines()[:25]))
    info["profiled_batch"] = device_busy(prof)
    log(f"[profile] one batch on the device: {info['profiled_batch']}")
    return info


def phase_breakdown(run: KittiDetect, reps: int = 3) -> dict:
    """Time of each stage of the detection path at B=16, from CUDA events
    around the stage alone (warm, inputs from the previous stage)."""
    cfg, model, dev = run.cfg, run.model, run.images.device
    consts = pipeline.build_constants(cfg, dev)
    posv = pipeline._position_validity(cfg, dev)
    rows = run.img_hw[:, 0].long() // cfg.model.stride
    cols = run.img_hw[:, 1].long() // cfg.model.stride
    stages = {}

    def stage(name, fn):
        stages[name] = time_ms(fn, reps, warmup=1)
        return fn()

    with uncounted(), torch.inference_mode():
        x = stage("ingest", lambda: pipeline.ingest_images(run.images))
        feat = stage("backbone", lambda: model.backbone(x))
        cls, reg = stage("rpn_head", lambda: model.rpn(feat))
        props = stage("proposals", lambda: prop_ops.generate_proposals(
            torch.sigmoid(cls), reg, consts.anchors_conv, posv(rows, cols), rows, cols,
            cfg.rpn.infer_pre_nms, cfg.rpn.infer_post_nms, cfg.rpn.nms_iou, cfg.rpn.nms_tile))
        pooled = stage("roi_align", lambda: roi_align_cuda.roi_align(
            feat.contiguous(), props.boxes.contiguous(), cfg.det.pool_size))
        logits, reg_out = stage("det_head", lambda: model.det_head(pooled))
        stage("decode", lambda: inference._decode_one_image(
            cfg, props.boxes, props.valid, torch.softmax(logits, -1), reg_out))
    stages["sum"] = sum(stages.values())
    log(f"[breakdown] ms per B={run.b} batch: "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
    return stages


# --------------------------------------------------------------------------
# phase 5: the joint train step
# --------------------------------------------------------------------------


def kitti_train_batch(rng, b, cfg) -> dict:
    """Seeded uint8 canvases, each holding a 453x1500 image, with 1-12
    ground-truth boxes per image of car-to-pedestrian size (25-300 px wide,
    40-200 px tall in the resized image) and classes 0-8."""
    img, hw = kitti_batch(rng, b, cfg)
    g = cfg.data.max_gt_boxes
    boxes = np.zeros((b, g, 4), np.float32)
    cls = np.zeros((b, g), np.int32)
    valid = np.zeros((b, g), bool)
    for i in range(b):
        n = rng.randint(1, 13)
        w, h = rng.uniform(25, 300, n), rng.uniform(40, 200, n)
        x1, y1 = rng.uniform(0, KITTI_HW[1] - w), rng.uniform(0, KITTI_HW[0] - h)
        boxes[i, :n] = np.stack([x1, y1, x1 + w, y1 + h], 1)
        cls[i, :n] = rng.randint(0, cfg.model.num_classes - 1, n)
        valid[i, :n] = True
    return {"image": img, "gt_boxes": boxes, "gt_class": cls, "gt_valid": valid, "img_hw": hw}


class KittiTrain:
    """make_joint_train_step at kitti_config() (whose freeze_blocks
    (1, 2, 3) put the frozen prefix at stage 3), seeded random
    weights, SGD lr 1e-3 with momentum 0.9 and the global-norm clip at 10
    that config.py recommends for from-scratch joint training, and a seeded
    batch."""

    def __init__(self, rng, dev, b: int = 16, seed: int = 0):
        self.cfg = kitti_config()
        self.b = b
        self.model = init_model(seed, self.cfg, dev)
        self.opt = make_optimizer(self.model, self.cfg.model.network,
                                  self.cfg.model.freeze_blocks, 1e-3, momentum=0.9,
                                  clip_grad_norm=10.0)
        self.step = pipeline.make_joint_train_step(self.cfg, self.model, self.opt, device=dev)
        self.batch = {k: torch.as_tensor(v, device=dev)
                      for k, v in kitti_train_batch(rng, b, self.cfg).items()}
        self.gen = torch.Generator(device=dev).manual_seed(seed)

    def capture(self):
        """One uncounted step that records every kernel wrapper's inputs.
        Returns (calls, seconds of this first step)."""
        calls: dict = {}
        with recording(calls):
            t0 = time.perf_counter()
            self.step(self.batch, self.gen)
            torch.cuda.synchronize()
            first = time.perf_counter() - t0
        return calls, first


def phase_train(run: KittiTrain, first: float) -> dict:
    for _ in range(TRAIN_WARMUP):
        with uncounted():
            run.step(run.batch, run.gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    metrics = [run.step(run.batch, run.gen) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    losses = [{k: float(v) for k, v in m.items()} for m in metrics]
    info = {"img_per_s": run.b * TRAIN_STEPS / sec, "step_ms": sec / TRAIN_STEPS * 1e3,
            "first_step_s": first, "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": launches, "metrics": losses}
    log(f"[train] ResNet-50 KITTI joint step B={run.b}, {TRAIN_STEPS} steps after "
        f"{TRAIN_WARMUP} warm-up: {info}")
    if not all(np.isfinite(v) for m in losses for v in m.values()):
        raise RuntimeError(f"non-finite train metrics {losses}")
    want = {k: v * TRAIN_STEPS for k, v in PER_STEP.items()}
    if launches != want:
        raise RuntimeError(f"kernel launches {launches}, expected {want}")

    # stages: CUDA events at the step's marks, over 3 further steps
    stages: dict = {}
    with uncounted():
        for _ in range(3):
            events = [("start", torch.cuda.Event(enable_timing=True))]
            events[0][1].record()

            def mark(name):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                events.append((name, ev))

            run.step(run.batch, run.gen, mark=mark)
            torch.cuda.synchronize()
            for (_, a), (name, b) in zip(events, events[1:]):
                stages[name] = stages.get(name, 0.0) + a.elapsed_time(b) / 3
    stages["sum"] = sum(stages.values())
    info["breakdown_ms"] = stages
    log(f"[train breakdown] ms per B={run.b} step: "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
    os.makedirs(OUT_DIR, exist_ok=True)
    with uncounted(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        run.step(run.batch, run.gen)
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=50)
    with open(os.path.join(OUT_DIR, "train_profile.txt"), "w") as f:
        f.write(table)
    log("[train profile] top kernels by device time:\n" + "\n".join(table.splitlines()[:30]))
    info["profiled_step"] = device_busy(prof)
    log(f"[train profile] one step on the device: {info['profiled_step']}")
    return info


def _agreement(a, b) -> dict:
    """Detections of two runs of the path on the same inputs: the share of
    run a's detections that run b has too, with the same class and a box
    within 1e-2 px ("close") or at IoU >= 0.5 ("overlap")."""
    total = close = overlap = 0
    worst = 0.0
    for i in range(a.valid.shape[0]):
        va, vb = a.valid[i].cpu(), b.valid[i].cpu()
        ba, bb = a.boxes[i].cpu()[va].double(), b.boxes[i].cpu()[vb].double()
        ca, cb = a.classes[i].cpu()[va], b.classes[i].cpu()[vb]
        total += len(ba)
        if len(ba) == 0 or len(bb) == 0:
            continue
        same = ca[:, None] == cb[None, :]
        err = (ba[:, None, :] - bb[None, :, :]).abs().amax(-1)
        err = torch.where(same, err, torch.full_like(err, float("inf")))
        best = err.min(dim=1).values
        close += int((best <= 1e-2).sum())
        worst = max(worst, float(best[torch.isfinite(best)].max()) if torch.isfinite(best).any()
                    else 0.0)
        lt = torch.maximum(ba[:, None, :2], bb[None, :, :2])
        rb = torch.minimum(ba[:, None, 2:], bb[None, :, 2:])
        inter = (rb - lt).clamp_min(0).prod(-1)
        area = lambda x: (x[:, 2] - x[:, 0]) * (x[:, 3] - x[:, 1])  # noqa: E731
        iou = inter / (area(ba)[:, None] + area(bb)[None, :] - inter).clamp_min(1e-9)
        overlap += int(((iou >= 0.5) & same).any(dim=1).sum())
    return {"valid_a": a.valid.sum(1).tolist(), "valid_b": b.valid.sum(1).tolist(),
            "close_frac": close / max(1, total), "overlap_frac": overlap / max(1, total),
            "max_best_box_err": worst}


def phase_whole_path(rng, dev) -> dict:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    # (a) full size, B=2, f32, the card's kernels against the card's plain versions
    base = kitti_config()
    cfg = base.replace(model=dataclasses.replace(base.model, compute_dtype="float32"))
    model = init_model(1, cfg, dev)
    img, hw = kitti_batch(rng, 2, cfg)
    detect = inference.make_detect_fn(cfg, model, dev)
    with uncounted():
        got = detect(img, hw)
        with plain_versions():
            want = detect(img, hw)
    torch.cuda.synchronize()
    check_dets(got, 2, cfg.rpn.infer_post_nms, cfg.model.num_classes)
    check_dets(want, 2, cfg.rpn.infer_post_nms, cfg.model.num_classes)
    out["kitti_b2_f32"] = _agreement(got, want)
    # (b) a small canvas at full width, f32: card kernels against the CPU's
    # plain path, with the RPN's scores made of biases (see _bias_only_rpn)
    small = cfg.replace(data=dataclasses.replace(cfg.data, canvas_h=128, canvas_w=192),
                        rpn=dataclasses.replace(cfg.rpn, infer_pre_nms=1000, infer_post_nms=64))
    state = _bias_only_rpn(init_model(2, small, "cpu").state_dict(), small.anchors.num_anchors)
    img = rng.randint(0, 256, (2, 128, 192, 3)).astype(np.uint8)
    hw = np.array([[128, 192], [112, 160]], np.int32)
    want = inference.make_detect_fn(small, _model(small, state, "cpu"), "cpu")(img, hw)
    with uncounted():
        got = inference.make_detect_fn(small, _model(small, state, dev), dev)(img, hw)
    torch.cuda.synchronize()
    out["small_vs_cpu_f32"] = _agreement(got, want)
    torch.backends.cudnn.allow_tf32 = True
    log(f"[whole path] {json.dumps(out)}")
    small_ok = (out["small_vs_cpu_f32"]["valid_a"] == out["small_vs_cpu_f32"]["valid_b"]
                and out["small_vs_cpu_f32"]["close_frac"] == 1.0)
    if not small_ok:
        raise RuntimeError("the card's path disagrees with the CPU's plain path on a small input")
    if out["kitti_b2_f32"]["overlap_frac"] < 0.5:
        raise RuntimeError("kernels and plain versions disagree on most detections at B=2")
    return out


def _bias_only_rpn(state: dict, num_anchors: int) -> dict:
    """The RPN's 1x1 outputs made of their biases alone (weights zero), so
    that the proposals, a discrete function of the scores, are the same on
    both sides of a comparison: with random weights the scores of 64,296
    anchors lie closer together than the last bit of the stem's f32 sums,
    and one swapped pair would change the sampled ROIs. Scores then tie
    across positions and rank by anchor shape, mid-sized shapes first."""
    state = dict(state)
    a = torch.arange(num_anchors, dtype=torch.float32)
    state["rpn_head.rpn_out_cls.weight"] = torch.zeros_like(state["rpn_head.rpn_out_cls.weight"])
    state["rpn_head.rpn_out_cls.bias"] = -0.3 * (a - 10).abs() - 0.01 * a
    state["rpn_head.rpn_out_bbreg.weight"] = torch.zeros_like(
        state["rpn_head.rpn_out_bbreg.weight"])
    state["rpn_head.rpn_out_bbreg.bias"] = torch.linspace(-0.5, 0.5, 4 * num_anchors)
    return state


def _model(cfg, state: dict, dev) -> FasterRCNN:
    model = FasterRCNN(cfg)
    model.load_state_dict(state)
    return model.to(dev).eval()


def _train_once(cfg, state, dev, batch, draws, plain: bool):
    model = _model(cfg, state, dev)
    opt = make_optimizer(model, cfg.model.network, cfg.model.freeze_blocks, 1e-3, momentum=0.9)
    step = pipeline.make_joint_train_step(cfg, model, opt, device=dev)
    with uncounted(), (plain_versions() if plain else contextlib.nullcontext()):
        metrics = step(batch, draws)
    return ({k: float(v) for k, v in metrics.items()},
            {n: p.detach().cpu() for n, p in model.named_parameters()}, opt.labels)


def _step_agreement(before, got, want) -> dict:
    """Losses within 1e-4 relative; every trainable parameter within a
    share of its largest change max|delta| on the reference side: 2e-2 for
    the RPN head, whose 3x3 conv runs in bf16 whatever the compute dtype,
    so one bf16 rounding flips with the order of the f32 sums beneath it;
    1e-3 elsewhere, for f32 sums in other orders (the atomics of the RoI
    backward among them) and ReLUs that flip at that noise."""
    (gm, gp, labels), (wm, wp, _) = got, want
    loss_err = max(abs(gm[k] - wm[k]) / max(abs(wm[k]), 1e-12) for k in wm)
    worst, frozen_moved = {"rpn_head": (0.0, ""), "rest": (0.0, "")}, []
    for n, lab in labels.items():
        if lab != "train":
            if not torch.equal(gp[n], before[n]):
                frozen_moved.append(n)
            continue
        delta = (wp[n] - before[n]).abs().max().item()
        err = (gp[n] - wp[n]).abs().max().item()
        group = "rpn_head" if n.startswith("rpn_head.") else "rest"
        ratio = err / delta if delta > 0 else (0.0 if err == 0 else float("inf"))
        if ratio >= worst[group][0]:
            worst[group] = (ratio, n)
    ok = (loss_err <= 1e-4 and not frozen_moved and gm["num_valid_images"] ==
          wm["num_valid_images"] and worst["rpn_head"][0] <= 2e-2 and worst["rest"][0] <= 1e-3)
    return {"ok": ok, "metrics": gm, "metrics_ref": wm, "loss_rel_err": loss_err,
            "worst_param_ratio": worst, "frozen_moved": frozen_moved}


def phase_whole_train(rng, dev) -> dict:
    """One joint step from the same weights, batch and draws: (a) at the
    full canvas, B=2, f32, kernels against plain versions on the card; (b)
    on a 128x192 canvas, the card's kernels against the CPU's plain path."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    base = kitti_config()
    cfg = base.replace(model=dataclasses.replace(base.model, compute_dtype="float32"))
    state = _bias_only_rpn(init_model(1, cfg, "cpu").state_dict(), cfg.anchors.num_anchors)
    batch = kitti_train_batch(rng, 2, cfg)
    draws = pipeline.draw_samples(cfg, 2, torch.Generator(device=dev).manual_seed(1))
    runs = [_train_once(cfg, state, dev, batch, draws, plain) for plain in (False, True)]
    out["train_kitti_b2_f32"] = _step_agreement(state, *runs)
    del runs
    torch.cuda.empty_cache()

    small = cfg.replace(data=dataclasses.replace(cfg.data, canvas_h=128, canvas_w=192),
                        rpn=dataclasses.replace(cfg.rpn, train_pre_nms=1000, train_post_nms=256))
    state = _bias_only_rpn(init_model(2, small, "cpu").state_dict(), small.anchors.num_anchors)
    boxes = np.zeros((2, small.data.max_gt_boxes, 4), np.float32)
    boxes[:, :3] = [[10, 12, 60, 70], [80, 30, 150, 100], [5, 60, 40, 120]]
    valid = np.zeros((2, small.data.max_gt_boxes), bool)
    valid[:, :3] = True
    batch = {"image": rng.randint(0, 256, (2, 128, 192, 3)).astype(np.uint8),
             "gt_boxes": boxes, "gt_class": np.tile(np.arange(small.data.max_gt_boxes) % 9, (2, 1)),
             "gt_valid": valid, "img_hw": np.array([[128, 192], [112, 160]], np.int32)}
    draws = pipeline.draw_samples(small, 2, torch.Generator(device=dev).manual_seed(2))
    got = _train_once(small, state, dev, batch, draws, plain=False)
    want = _train_once(small, state, "cpu", batch, pipeline.Draws(*(t.cpu() for t in draws)),
                       plain=False)
    out["train_small_vs_cpu_f32"] = _step_agreement(state, got, want)
    torch.backends.cudnn.allow_tf32 = True
    log(f"[whole train path] {json.dumps(out)}")
    bad = [k for k, v in out.items() if not v["ok"]]
    if bad:
        raise RuntimeError(f"the train step's kernels and plain versions disagree: {bad}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = phase_card()
    phase_build()

    rng = np.random.RandomState(0)
    run = KittiDetect(rng, dev)
    calls, first = run.capture()
    with torch.inference_mode():
        detect_cases = check_kernels(calls, "detect")
    del calls
    det = phase_detect(run, first)
    det["breakdown_ms"] = phase_breakdown(run)
    del run
    torch.cuda.empty_cache()

    train = KittiTrain(rng, dev)
    calls, first = train.capture()
    train_cases = check_kernels(calls, "train")
    del calls
    tr = phase_train(train, first)
    del train
    torch.cuda.empty_cache()

    whole = phase_whole_path(rng, dev)
    whole.update(phase_whole_train(rng, dev))

    per_step = {k: v / TRAIN_STEPS for k, v in tr["launches"].items()}
    per_call = {k: v / BATCHES for k, v in det["launches"].items()}
    log(f"[launches] per train step {per_step}; per detect call {per_call}")
    kernels = kernel_entries(train_cases, detect_cases, tr["launches"], det["launches"])
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "kernels": kernels, "cases": {"train": train_cases,
                                                               "detect": detect_cases},
                   "detect": det, "train": tr, "whole_path": whole}, f, indent=1)
    log(card["smi"])
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card["kind"],
                                             "count": card["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
