#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (faster_rcnn_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run on any error:
  1. card: name, power limit, device count;
  2. build: nvcc for sm_90a of every kernel, with the ptxas report;
  3. kernels: each kernel against its plain PyTorch version on the card, at
     the shapes the detection path gives it (ResNet-50 KITTI, B=16), with its
     time, the plain version's time, a PyTorch library call's time where one
     computes the same function, and the bound from the H100's published peaks;
  4. detect: full-width ResNet-50 KITTI detection (608x1504 canvases, B=16,
     seeded random weights) through make_detect_fn, with the launch count of
     every kernel over the timed batches, a torch.profiler table of one
     batch (chiprun_out/detect_profile.txt) and the time of each stage;
  5. whole path, kernels against plain versions: at B=2 on the card in f32,
     and on a small canvas against the CPU's plain path;
  6. a JSON line listing every kernel, then the JSON result line.

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
from faster_rcnn_tpu_torch.models.detector import init_model
from faster_rcnn_tpu_torch.ops import conv1_cuda, nms, nms_cuda, roi_align_cuda
from faster_rcnn_tpu_torch.ops import proposals as prop_ops
from faster_rcnn_tpu_torch.train import pipeline

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12         # dense bf16 tensor-core peak
F32_FLOPS = 67e12           # f32 outside the tensor cores
IOU_OPS = 25                # f32 operations of one +1-convention IoU and its compare
LERP_OPS = 9                # f32 operations of one bilinear output value
OUT_DIR = "chiprun_out"
BATCHES = 3                 # timed detect batches of 16

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
    """Route the detection path through the kernels' plain versions (for the
    whole-path comparison only; the package itself never does this)."""
    with mock.patch.object(resnet, "conv1_kernel", conv1_cuda.conv1_plain), \
            mock.patch.object(inference, "roi_align", roi_align_cuda.roi_align_plain), \
            mock.patch.object(nms_cuda, "nms_keep_mask", nms.nms_sorted_mask_blocked):
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


def check_conv1(x, wt) -> dict:
    with uncounted():
        got = conv1_cuda.conv1(x, wt)
        want = conv1_cuda.conv1_plain(x, wt)
        torch.cuda.synchronize()
        err, ref = _rel_err(got, want)
        ok = err <= 1e-2 * ref
        ms = time_ms(lambda: conv1_cuda.conv1(x, wt), 20)
    plain = time_ms(lambda: conv1_cuda.conv1_plain(x, wt), 3, warmup=1)
    # cuDNN on the same work: bf16, channels_last, the input padded beforehand
    xp = torch.nn.functional.pad(x.permute(0, 3, 1, 2), (2, 3, 2, 3)).contiguous(
        memory_format=torch.channels_last)
    w_oihw = wt.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    library = time_ms(lambda: torch.nn.functional.conv2d(xp, w_oihw, stride=2), 20)
    nbytes = x.numel() * 2 + wt.numel() * 2 + got.numel() * 2
    flops = 2.0 * got.numel() * 147
    bms, by = bound_ms(nbytes, flops, BF16_FLOPS)
    log(f"[kernel conv1] {tuple(x.shape)}->{tuple(got.shape)} {x.dtype}: max_abs_err={err:.4g} "
        f"(limit 1e-2*max|ref|={1e-2 * ref:.4g}) kernel {ms:.4f} ms, plain {plain:.4f} ms, "
        f"cuDNN {library:.4f} ms, bound {bms:.4f} ms ({by})")
    return {"name": "conv1", "route": "cuda", "source": "faster_rcnn_tpu_torch/csrc/conv1.cu",
            "replaces": "faster_rcnn_tpu/ops/conv1_pallas.py:262", "max_abs_err": err,
            "ok": ok, "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by,
            "library_ms": library}


def check_roi_align(feat, rois, p) -> dict:
    with uncounted():
        got = roi_align_cuda.roi_align(feat, rois, p)
        want = roi_align_cuda.roi_align_plain(feat, rois, p)
        torch.cuda.synchronize()
        err, ref = _rel_err(got, want)
        ok = err <= 1e-2 * ref
        ms = time_ms(lambda: roi_align_cuda.roi_align(feat, rois, p), 20)
    plain = time_ms(lambda: roi_align_cuda.roi_align_plain(feat, rois, p), 3, warmup=1)
    nbytes = feat.numel() * 2 + rois.numel() * 4 + got.numel() * 2
    bms, by = bound_ms(nbytes, LERP_OPS * got.numel(), F32_FLOPS)
    log(f"[kernel roi_align] {tuple(feat.shape)} x {tuple(rois.shape)} -> {tuple(got.shape)} "
        f"max_abs_err={err:.4g} (limit {1e-2 * ref:.4g}) kernel {ms:.4f} ms, "
        f"plain {plain:.4f} ms, bound {bms:.4f} ms ({by})")
    return {"name": "roi_align", "route": "cuda",
            "source": "faster_rcnn_tpu_torch/csrc/roi_align.cu",
            "replaces": "faster_rcnn_tpu/ops/roi_align_pallas.py:178", "max_abs_err": err,
            "ok": ok, "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by,
            "library_ms": None}


def nms_pairs(keep: np.ndarray, valid: np.ndarray, tile: int, enough: int) -> int:
    """IoU pairs the blocked algorithm evaluates on these inputs: per tile
    phase, the tile against every earlier survivor plus its own upper
    triangle, until ``enough`` survivors exist."""
    pairs = 0
    for k, v in zip(keep, valid):
        kept = 0
        for off in range(0, k.shape[0], tile):
            if enough > 0 and kept >= enough:
                break
            pairs += tile * kept + tile * (tile - 1) // 2
            kept += int((k[off:off + tile] & v[off:off + tile]).sum())
    return pairs


def check_nms(calls) -> tuple[dict, list]:
    """``calls``: the (args, kwargs) of the path's NMS launches of one batch:
    the proposal NMS, then the final class-offset NMS."""
    entry = {"name": "nms", "route": "cuda", "source": "faster_rcnn_tpu_torch/csrc/nms.cu",
             "replaces": "faster_rcnn_tpu/ops/nms_pallas.py:153", "max_abs_err": 0.0,
             "ok": True, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bound_by": "",
             "library_ms": None}
    rows = []
    for label, (args, kw) in zip(("proposal NMS", "final NMS"), calls):
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
        pairs = nms_pairs(keep_np, valid_np, tile, enough)
        nbytes = boxes.numel() * 4 + valid.numel() + got.numel()
        bms, by = bound_ms(nbytes, IOU_OPS * pairs, F32_FLOPS)
        log(f"[kernel nms {label}] {tuple(boxes.shape)} tile {tile} iou {iou} enough {enough}: "
            f"mismatches={mismatches}, valid/img {valid_np.sum(1).tolist()}, IoU pairs={pairs}, "
            f"kernel {ms:.4f} ms, plain {plain:.4f} ms, bound {bms:.6f} ms ({by})")
        rows.append({"case": label, "shape": list(boxes.shape), "mismatches": mismatches,
                     "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by,
                     "pairs": pairs})
        entry["ok"] &= mismatches == 0
        entry["max_abs_err"] = max(entry["max_abs_err"], float(mismatches))
        entry["ms"] += ms
        entry["plain_ms"] += plain
        entry["bound_ms"] += bms
        entry["bound_by"] = entry["bound_by"] or by
    return entry, rows


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
        inputs, so the kernels are checked on the data the path gives them.
        Returns (calls, seconds of this first call)."""
        calls: dict = {}
        with uncounted(), \
                mock.patch.object(resnet, "conv1_kernel",
                                  _recording(calls, "conv1", conv1_cuda.conv1)), \
                mock.patch.object(inference, "roi_align",
                                  _recording(calls, "roi_align", roi_align_cuda.roi_align)), \
                mock.patch.object(nms_cuda, "nms_keep_mask",
                                  _recording(calls, "nms", nms_cuda.nms_keep_mask)):
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
    want = {"conv1": batches, "roi_align": batches, "nms": 2 * batches}
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
    # (b) a small canvas at full width, f32: card kernels against the CPU's plain path
    small = cfg.replace(data=dataclasses.replace(cfg.data, canvas_h=128, canvas_w=192),
                        rpn=dataclasses.replace(cfg.rpn, infer_pre_nms=1000, infer_post_nms=64))
    model_cpu = init_model(2, small, "cpu")
    img = rng.randint(0, 256, (2, 128, 192, 3)).astype(np.uint8)
    hw = np.array([[128, 192], [112, 160]], np.int32)
    want = inference.make_detect_fn(small, model_cpu, "cpu")(img, hw)
    with uncounted():
        got = inference.make_detect_fn(small, init_model(2, small, dev), dev)(img, hw)
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
        kernels = [check_conv1(*calls["conv1"][0][0]),
                   check_roi_align(*calls["roi_align"][0][0])]
        nms_entry, nms_rows = check_nms(calls["nms"])
    kernels.append(nms_entry)
    del calls
    bad = [k["name"] for k in kernels if not k["ok"]]
    if bad:
        raise RuntimeError(f"kernels disagree with their plain versions: {bad}")

    det = phase_detect(run, first)
    det["breakdown_ms"] = phase_breakdown(run)
    del run
    torch.cuda.empty_cache()
    whole = phase_whole_path(rng, dev)

    for k in kernels:
        k["launches"] = det["launches"][k["name"]]
        del k["ok"]
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "kernels": kernels, "nms_cases": nms_rows, "detect": det,
                   "whole_path": whole}, f, indent=1)
    log(card["smi"])
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card["kind"],
                                             "count": card["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
