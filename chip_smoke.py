#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (faster_rcnn_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run on any error:
  1. card: name, power limit, device count;
  2. build: nvcc for sm_90a of every kernel, with the ptxas report;
  3. kernels: each kernel against its plain PyTorch version on the card, on
     inputs captured from every path below (KITTI canvases, B=16); K4 also
     on topk_adversarial's rows at k = 8000 and 128. Each reports its time,
     the plain version's time, a PyTorch library call's time where one
     computes the same function, and the bound from the H100's published
     peaks; K3 also on the proposals of a later joint train step; K1's
     forward bit for bit, in the path's dtype and in f32 on the same values,
     with its device time a launch from torch.profiler;
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
  7. VGG16 and ResNet-101 detection at kitti_config(), B=16, as phase 4;
  8. the 4-step scheme on VGG16 at kitti_config(), B=16, full width and
     depth: steps 1 (RPN), 2 (detector on step 1's frozen RPN), 3 (RPN on
     step 2's frozen backbone) and 4 (detector head on step 3's frozen RPN),
     each from the weights the one before hands over, with its own SGD;
     per step 2 warm-up and 3 timed steps, launches, stage times, peak
     memory; then steps 1, 2 and 4 at B=2 in f32, kernels against plain
     versions on the card;
  9. loader_train, the user's workflow from JPEGs on disk: a KITTI-synthetic
     dataset (64 train, 16 val frames at 1242x375) written to a temporary
     directory; cli.train --step all on VGG16 at the 608x1504 canvas, B=16,
     loader-fed (each step's rate over LOADER_TIMED iterations, from the
     first after 2 warm-up ones at which the loader held no batch ready,
     then two profiled iterations, then one checkpoint); step 1 again with more
     iterations, which must resume; cli.train --step joint on ResNet-50;
     cli.detect --from_step 4 on the val frames and cli.evaluate. Each
     step, the joint run and the detect run is a path of this slice: its
     launches are counted over the whole run, and the kernels are checked
     against their plain versions on one iteration's inputs. It prints the
     loader-fed rates beside the in-memory ones of phases 5 and 8, the
     decoder (native or PIL, and why), the CPU and worker counts, the
     loader's own rate, the time the trainer waited for batches, the
     checkpoints' write time and size, and the device-busy share of the
     profiled iterations;
 10. cached_train, the same workflow from the device cache
     (train/device_cache.py) on phase 9's dataset: cli.train --device_cache
     --step all on VGG16 and --step joint on ResNet-50, each step's
     iterations in chunks of CACHED_CHUNK; per step the cache's build
     seconds and bytes on the card, the cached rate over CACHED_TIMED
     iterations after CACHED_WARMUP chunks (host clock between two
     synchronizes, chunk boundaries and their metric reads inside) and each
     chunk's rate, beside the in-memory
     and loader-fed rates of this run, peak memory, launches over the run,
     and the device-busy share and K1 forward device time of one chunk
     traced by utils/profiling.device_trace; a resumed step 1;
     cli.annotate --from_step 4 on the 16 val frames (launches counted and
     checked as detect's); cli.gt_stats on the train frames; where h5py
     imports, cli.export_h5 of step 4 reloaded by load_keras_h5 into a fresh
     model whose detections equal the checkpoint's bit for bit. The kernels
     are checked on the inputs of one cached iteration (annotate: one frame);
 11. multi_gpu: one NCCL process per visible card, up to MP_MAX_RANKS
     (torch.multiprocessing, a FileStore rendezvous in a temporary
     directory; one process on a one-card host, through the same code: the
     process group, the gradient all-reduce, the metric reduction, the
     all-gather of sharded detection). Per rank, at MP_CHECK_B images of a
     global batch, f32: the data-parallel joint step against the local
     joint step on the whole batch (phase 6's limits), and the sharded
     detect against the single-card detect (the same detections); then at
     kitti_config(), global B=MP_B: the data-parallel joint step and the
     sharded detect, timed, with each rank's launches from 0 over the timed
     run and its peak memory, beside the one-card rates of phases 4 and 5;
     the kernels checked on rank 0's inputs. A failure in any rank fails
     the run;
 12. a JSON line listing every kernel, then the JSON result line.

It needs CUDA and the faster_rcnn_tpu_torch package beside it; without
either it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from unittest import mock

import numpy as np
import torch

from faster_rcnn_tpu_torch import _build, inference
from faster_rcnn_tpu_torch.config import kitti_config
from faster_rcnn_tpu_torch.models import resnet
from faster_rcnn_tpu_torch.models.detector import FasterRCNN, init_model
from faster_rcnn_tpu_torch.ops import conv1_cuda, nms, nms_cuda, roi_align_cuda, sort, sort_cuda
from faster_rcnn_tpu_torch.ops import frozen_epilogue_cuda
from faster_rcnn_tpu_torch.ops import proposals as prop_ops
from faster_rcnn_tpu_torch.ops.roi_align_taps import roi_axes, row_hits, tap_counts
from faster_rcnn_tpu_torch.parallel import mesh as mesh_lib
from faster_rcnn_tpu_torch.parallel import multihost
from faster_rcnn_tpu_torch.parallel.freeze import make_optimizer
from faster_rcnn_tpu_torch.cli import annotate as cli_annotate
from faster_rcnn_tpu_torch.cli import common as cli_common
from faster_rcnn_tpu_torch.cli import detect as cli_detect
from faster_rcnn_tpu_torch.cli import evaluate as cli_evaluate
from faster_rcnn_tpu_torch.cli import gt_stats as cli_gt_stats
from faster_rcnn_tpu_torch.cli import train as cli_train
from faster_rcnn_tpu_torch.data import kitti_synth, native_loader
from faster_rcnn_tpu_torch.data import pipeline as data_pipeline
from faster_rcnn_tpu_torch.data.voc import KITTI_CLASS_MAPPING, load_dataset
from faster_rcnn_tpu_torch.train import device_cache, pipeline, trainer
from faster_rcnn_tpu_torch.train.trainer import merge_params, step_freeze_spec
from faster_rcnn_tpu_torch.utils import checkpoint, profiling

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12         # dense bf16 tensor-core peak
F32_FLOPS = 67e12           # f32 outside the tensor cores
IOU_OPS = 25                # f32 operations of one +1-convention IoU and its compare
LERP_OPS = 9                # f32 operations of one bilinear output value
SCATTER_OPS = 10            # f32 operations of one cotangent value's 4-tap scatter
OUT_DIR = "chiprun_out"
BATCHES = 3                 # timed detect batches of 16
TRAIN_WARMUP, TRAIN_STEPS = 2, 5
FOUR_STEP_WARMUP, FOUR_STEP_TIMED = 2, 3
_DETECT = (("proposal NMS", "final NMS"), ("proposals",))
_RPN_SAMPLER = ("RPN sampler pos", "RPN sampler neg")
# each path: (launches of each kernel in one call or step, labels of its NMS
# calls, labels of its top-k calls); "detect" and "train" are ResNet-50's
# (frozen_epilogue: every ResNet branch where no autograd runs: ResNet-50's
# stem, 42 in stages 2-4 and 10 in stage 5; ResNet-101's stages 2-4 hold 94)
PATHS = {
    "detect": ({"conv1": 1, "roi_align": 1, "nms": 2, "topk": 1, "frozen_epilogue": 53},)
    + _DETECT,
    "train": ({"conv1": 1, "roi_align": 1, "roi_align_bwd": 1, "nms": 1, "topk": 3,
               "frozen_epilogue": 24}, ("proposal NMS",), _RPN_SAMPLER + ("proposals",)),
    "vgg16_detect": ({"roi_align": 1, "nms": 2, "topk": 1},) + _DETECT,
    "resnet101_detect": ({"conv1": 1, "roi_align": 1, "nms": 2, "topk": 1,
                          "frozen_epilogue": 104},) + _DETECT,
    "step1": ({"topk": 2}, (), _RPN_SAMPLER),
    "step2": ({"roi_align": 1, "roi_align_bwd": 1, "nms": 1, "topk": 1}, ("proposal NMS",),
              ("proposals",)),
    "step3": ({"topk": 2}, (), _RPN_SAMPLER),
    "step4": ({"roi_align": 1, "nms": 1, "topk": 1}, ("proposal NMS",), ("proposals",)),
}
# the loader-fed runs of phase 9 launch what the same paths launch in memory
PATHS.update({f"loader_step{s}": PATHS[f"step{s}"] for s in (1, 2, 3, 4)})
PATHS.update(loader_joint=PATHS["train"], loader_detect=PATHS["vgg16_detect"])
# this slice's paths: the kernels line's launches are over the whole run of
# each, its times over one iteration's (one call's) kernel calls
LOADER_PATHS = ("loader_step1", "loader_step2", "loader_step3", "loader_step4",
                "loader_joint", "loader_detect")
# phase 10 runs the same steps from the device cache, and annotate the VGG16
# detect path one frame a call
PATHS.update({f"cached_step{s}": PATHS[f"step{s}"] for s in (1, 2, 3, 4)})
PATHS.update(cached_joint=PATHS["train"], annotate=PATHS["vgg16_detect"])
CACHED_PATHS = ("cached_step1", "cached_step2", "cached_step3", "cached_step4",
                "cached_joint", "annotate")
# phase 11 runs the joint step data-parallel and detection batch-sharded,
# one process per card: each rank launches what the one-card paths launch
PATHS.update(multi_gpu_joint=PATHS["train"], multi_gpu_detect=PATHS["detect"])
MP_PATHS = ("multi_gpu_joint", "multi_gpu_detect")
MAIN_PATHS = LOADER_PATHS + CACHED_PATHS + MP_PATHS
LOADER_BATCH = 16           # images a batch, as in the in-memory phases
LOADER_WARMUP = 2
LOADER_TIMED, LOADER_PROFILED = 16, 2  # 16: two rounds of the 8 workers a chip host runs
LOADER_TRAIN, LOADER_VAL = 64, 16
# phase 10: chunks of CACHED_CHUNK steps; the first CACHED_WARMUP are the
# warm-up, the next CACHED_TIMED // CACHED_CHUNK are timed, the one after
# them profiled
CACHED_CHUNK = 8
CACHED_WARMUP = 2
CACHED_TIMED = LOADER_TIMED
# phase 11: at most MP_MAX_RANKS ranks; MP_CHECK_B images a rank in the f32
# checks; the global batch MP_B, MP_STEPS timed steps (BATCHES detect calls)
MP_MAX_RANKS = 4
MP_CHECK_B = 2
MP_B = 16
MP_STEPS = TRAIN_STEPS
SOURCES = {"conv1": ("conv1.cu", "faster_rcnn_tpu/ops/conv1_pallas.py:262"),
           "roi_align": ("roi_align.cu", "faster_rcnn_tpu/ops/roi_align_pallas.py:178"),
           "roi_align_bwd": ("roi_align.cu", "faster_rcnn_tpu/ops/roi_align_pallas.py:213"),
           "nms": ("nms.cu", "faster_rcnn_tpu/ops/nms_pallas.py:153"),
           "topk": ("topk.cu", "faster_rcnn_tpu/ops/sort_pallas.py:115")}

# the frozen epilogue, checked on seeded maps at the ResNet-50 paths' shapes:
# (label, shape, conv bias, channel scale, shortcut, ReLU)
EPILOGUE_CASES = (("stem", (16, 304, 752, 64), True, False, False, True),
                  ("stage2", (16, 152, 376, 256), True, False, False, False),
                  ("stage5", (4800, 7, 7, 2048), True, False, True, True))
EPILOGUE_OPS = 6            # f32 operations of an element's bias, norm, add and ReLU

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
            mock.patch.object(resnet, "frozen_epilogue",
                              frozen_epilogue_cuda.frozen_epilogue_plain), \
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


def conv1_integer_mismatches(shape, dev, seed: int = 0) -> int:
    """Bits in which K2 and its plain version differ on bf16 integer inputs
    in [-8, 8] and weights in [-4, 4] of the given shape: every product and
    sum is exact in f32, so the two must agree bit for bit."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randint(-8, 9, shape, generator=g, device=dev).to(torch.bfloat16)
    w = torch.randint(-4, 5, (7, 7, 3, 64), generator=g, device=dev).to(torch.bfloat16)
    with uncounted():
        got = conv1_cuda.conv1(x, w)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        want = conv1_cuda.conv1_plain(x, w)
    return int((got.view(torch.int16) != want.view(torch.int16)).sum())


def check_conv1(label, x, wt) -> dict:
    """The captured inputs within 1e-2 of max|ref|, and the integer case of
    the same shape bit for bit."""
    with uncounted():
        got = conv1_cuda.conv1(x, wt)
        want = conv1_cuda.conv1_plain(x, wt)
        torch.cuda.synchronize()
        err, ref = _rel_err(got, want)
        ms = time_ms(lambda: conv1_cuda.conv1(x, wt), 20)
    int_bad = conv1_integer_mismatches(tuple(x.shape), x.device)
    plain = time_ms(lambda: conv1_cuda.conv1_plain(x, wt), 3, warmup=1)
    # cuDNN on the same work: bf16, channels_last, the input padded beforehand
    xp = torch.nn.functional.pad(x.permute(0, 3, 1, 2), (2, 3, 2, 3)).contiguous(
        memory_format=torch.channels_last)
    w_oihw = wt.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    library = time_ms(lambda: torch.nn.functional.conv2d(xp, w_oihw, stride=2), 20)
    nbytes = x.numel() * 2 + wt.numel() * 2 + got.numel() * 2
    c = _case(label, err <= 1e-2 * ref and int_bad == 0, err, ms, plain, library, nbytes,
              2.0 * got.numel() * 147, BF16_FLOPS, limit=1e-2 * ref, integer_mismatches=int_bad)
    _log_case("conv1", c, f"{tuple(x.shape)}->{tuple(got.shape)} {x.dtype}, limit 1e-2*max|ref|"
              f" {1e-2 * ref:.4g}; integer case mismatches={int_bad}")
    return c


def touched_pixels(rois: torch.Tensor, h: int, w: int, p: int) -> int:
    """Map pixels that RoI align must read for these ROIs (the union over
    each image's ROIs): its bound counts these bytes, since the work
    depends on the ROIs."""
    rows, cols = roi_axes(rois)
    hit = np.einsum("bry,brx->byx", tap_counts(*rows, p, h) > 0, tap_counts(*cols, p, w) > 0,
                    dtype=np.int64)
    return int((hit > 0).sum())


def kernel_device_us(prof, name: str) -> dict:
    """Device time of each launch of the kernel ``name`` in a trace: the
    mean, the least and the launches, from the trace's device events."""
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and re.search(rf"\b{name}\b", e.name)]
    if not us:
        return {"mean_us": None, "min_us": None, "launches": 0}
    return {"mean_us": sum(us) / len(us), "min_us": min(us), "launches": len(us)}


def profiled_device_us(fn, name: str, reps: int = 10, tries: int = 3) -> dict:
    """The device time a launch of kernel ``name`` takes in ``reps`` calls of
    ``fn`` under torch.profiler (not CUDA events around calls the host
    enqueues, which read the host's pace for a short kernel). A first round
    of ``reps`` calls runs in the profiler's warm-up step. A trace may still
    miss launches (0-9 of 10 were seen on the H100 after many earlier
    traces in one process), so up to ``tries`` traces are taken until one
    holds all ``reps``; the fullest is returned, its count in
    ``launches``."""
    best = None
    for _ in range(tries):
        schedule = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA],
                                    schedule=schedule) as prof:
            for _ in range(2):
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        got = kernel_device_us(prof, name)
        if best is None or got["launches"] > best["launches"]:
            best = got
        if got["launches"] == reps:
            break
    return best


def check_roi_align(label, feat, rois, p) -> dict:
    """Bit for bit against the plain version, in the path's dtype and in
    f32 on the same values (the kernel rounds each f32 operation as the
    plain version's separate PyTorch kernels do, and bf16 once at the end);
    the bound counts the touched map pixels and the output at the map's
    element size."""
    feat, rois = feat.detach().contiguous(), rois.contiguous()
    with uncounted():
        got = roi_align_cuda.roi_align(feat, rois, p)
        want = roi_align_cuda.roi_align_plain(feat, rois, p)
        torch.cuda.synchronize()
        err, _ = _rel_err(got, want)
        bits = _bits_differing(got, want)
        del want
        f32 = feat.float()
        bits32 = _bits_differing(roi_align_cuda.roi_align(f32, rois, p),
                                 roi_align_cuda.roi_align_plain(f32, rois, p))
        del f32
        ms = time_ms(lambda: roi_align_cuda.roi_align(feat, rois, p), 20)
        device = profiled_device_us(lambda: roi_align_cuda.roi_align(feat, rois, p),
                                    "roi_align_kernel")
    plain = time_ms(lambda: roi_align_cuda.roi_align_plain(feat, rois, p), 3, warmup=1)
    _, h, w, c = feat.shape
    pixels = touched_pixels(rois, h, w, p)
    nbytes = (pixels * c + got.numel()) * feat.element_size() + rois.numel() * 4
    c = _case(label, bits == 0 and bits32 == 0, err, ms, plain, None, nbytes,
              LERP_OPS * got.numel(), F32_FLOPS, bits_differing=bits, f32_bits_differing=bits32,
              map_pixels_read=pixels, device_us=device)
    _log_case("roi_align", c, f"{tuple(feat.shape)} x {tuple(rois.shape)} -> {tuple(got.shape)} "
              f"{feat.dtype}; bits differing from the plain version {bits}, in f32 {bits32}")
    mean = device["mean_us"]
    log(f"[kernel roi_align {label}] device time a launch (torch.profiler, "
        f"{device['launches']} launches traced of 10): {mean} us, least {device['min_us']} us; "
        f"bound {c['bound_ms'] * 1e3:.2f} us: "
        + ("not measured" if mean is None else f"{c['bound_ms'] * 1e3 / mean:.1%} of it"))
    return c


def epilogue_inputs(shape, bias: bool, scale: bool, residual: bool, dtype, dev, seed: int = 0):
    """Seeded arguments of ``frozen_epilogue``: a map of order one with NaN,
    infinities, signed zeros, subnormals and values near the dtype's largest
    scattered through it (and through the shortcut), per-channel constants
    as a trained network's."""
    g = torch.Generator(device=dev).manual_seed(seed)
    c = shape[-1]
    big = torch.finfo(dtype).max / 2

    def map_():
        x = torch.randn(shape, generator=g, device=dev).to(dtype)
        flat = x.view(-1)
        at = torch.randint(0, flat.numel(), (64,), generator=g, device=dev)
        flat[at] = torch.tensor([float("nan"), float("inf"), -float("inf"), -0.0, 0.0, 1e-40,
                                 -1e-40, big] * 8, device=dev).to(dtype)
        return x

    def per_channel(lo, hi):
        return torch.rand(c, generator=g, device=dev) * (hi - lo) + lo

    y = map_()
    return dict(y=y, conv_bias=per_channel(-1, 1).to(dtype) if bias else None,
                mean=per_channel(-1, 1), inv=per_channel(0.2, 2), bn_bias=per_channel(-1, 1),
                scale=per_channel(0.5, 1.5) if scale else None,
                scale_bias=per_channel(-1, 1) if scale else None,
                shortcut=map_() if residual else None)


def check_frozen_epilogue(label, shape, bias, scale, residual, relu, dev,
                          dtype=torch.bfloat16) -> dict:
    """The frozen epilogue against its plain version bit for bit on
    :func:`epilogue_inputs`, with its time from CUDA events and from
    torch.profiler, the plain version's, and the bound (each map element
    read once, the shortcut once, the output written once)."""
    kw = dict(epilogue_inputs(shape, bias, scale, residual, dtype, dev), relu=relu)
    with uncounted():
        got = frozen_epilogue_cuda.frozen_epilogue(**kw)
        want = frozen_epilogue_cuda.frozen_epilogue_plain(**kw)
        torch.cuda.synchronize()
        bits = _bits_differing(got, want)
        diff = (got.float() - want.float()).abs()
        err = float(diff[torch.isfinite(diff)].max()) if bool(torch.isfinite(diff).any()) else 0.0
        del want, diff
        ms = time_ms(lambda: frozen_epilogue_cuda.frozen_epilogue(**kw), 20)
        device = profiled_device_us(lambda: frozen_epilogue_cuda.frozen_epilogue(**kw),
                                    "frozen_epilogue_kernel")
    plain = time_ms(lambda: frozen_epilogue_cuda.frozen_epilogue_plain(**kw), 5)
    n = got.numel()
    nbytes = n * got.element_size() * (3 if residual else 2) + shape[-1] * 4 * 5
    c = _case(label, bits == 0, err, ms, plain, None, nbytes, EPILOGUE_OPS * n,
              F32_FLOPS, bits_differing=bits, shape=list(shape), device_us=device,
              variant=dict(bias=bias, scale=scale, residual=residual, relu=relu))
    mean = device["mean_us"]
    _log_case("frozen_epilogue", c, f"{tuple(shape)} {dtype} bias={bias} scale={scale} "
              f"residual={residual} relu={relu}; bits differing from the plain version {bits}; "
              f"device us a launch {mean}, least {device['min_us']} ({device['launches']} "
              f"traced): " + ("not measured" if mean is None
                              else f"{c['bound_ms'] * 1e3 / mean:.1%} of the bound"))
    return c


def check_frozen_epilogue_cases(dev) -> list:
    cases = [check_frozen_epilogue(label, shape, *variant, dev)
             for label, shape, *variant in EPILOGUE_CASES]
    bad = [c["case"] for c in cases if not c["ok"]]
    if bad:
        raise RuntimeError(f"the frozen epilogue disagrees with its plain version: {bad}")
    return cases


def _bits_differing(a: torch.Tensor, b: torch.Tensor) -> int:
    """Values of two bf16 or f32 tensors whose bits differ."""
    as_int = torch.int16 if a.element_size() == 2 else torch.int32
    return int((a.view(as_int) != b.view(as_int)).sum())


def hits_summary(hits: np.ndarray) -> dict:
    return {"mean": float(hits.mean()), "p50": float(np.percentile(hits, 50)),
            "p90": float(np.percentile(hits, 90)), "p99": float(np.percentile(hits, 99)),
            "max": int(hits.max()), "zero_rows": int((hits == 0).sum()), "rows": int(hits.size)}


def check_roi_align_bwd(label, grad, rois, shape, p) -> dict:
    """The gather kernel against autograd of the plain gather form, in the
    path's dtype (limit 1e-2 of max|ref|: the two sum in different orders,
    and then one bf16 rounding) and in f32 (limit 1e-5 of max|ref|: only the
    order of the f32 sums differs). The kernel sums in a fixed order, so two
    calls give the same bits, and its bf16 result is its f32 result on the
    same values rounded once: both are checked bit for bit."""
    with uncounted():
        got = roi_align_cuda.roi_align_backward(grad, rois, shape, p)
        again = roi_align_cuda.roi_align_backward(grad, rois, shape, p)
        want = roi_align_cuda.roi_align_backward_plain(grad, rois, shape, grad.dtype, p)
        torch.cuda.synchronize()
        err, ref = _rel_err(got, want)
        repeat_bits = _bits_differing(got, again)
        del again, want
        g32 = grad.float()
        got32 = roi_align_cuda.roi_align_backward(g32, rois, shape, p)
        err32, ref32 = _rel_err(got32, roi_align_cuda.roi_align_backward_plain(
            g32, rois, shape, torch.float32, p))
        rounding_bits = _bits_differing(got, got32.to(got.dtype))
        del g32, got32
        ms = time_ms(lambda: roi_align_cuda.roi_align_backward(grad, rois, shape, p), 10)
    plain = time_ms(lambda: roi_align_cuda.roi_align_backward_plain(grad, rois, shape,
                                                                    grad.dtype, p), 2, warmup=1)
    hits = row_hits(rois, shape[1], p)
    nbytes = grad.numel() * 2 + rois.numel() * 4 + got.numel() * 2
    ok = err <= 1e-2 * ref and err32 <= 1e-5 * ref32 and repeat_bits == 0 and rounding_bits == 0
    c = _case(label, ok, err, ms, plain, None, nbytes, SCATTER_OPS * grad.numel(), F32_FLOPS,
              limit=1e-2 * ref, f32_err=err32, f32_limit=1e-5 * ref32,
              repeat_mismatches=repeat_bits, rounding_mismatches=rounding_bits,
              hits_per_row=hits_summary(hits))
    _log_case("roi_align_bwd", c, f"{tuple(grad.shape)} -> {tuple(got.shape)} {grad.dtype}, "
              f"f32 err {err32:.4g} (limit {1e-5 * ref32:.4g}); bits differing between two calls "
              f"{repeat_bits}, from the f32 result rounded once {rounding_bits}; hits per row "
              f"{c['hits_per_row']}")
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
    """Bit for bit against the plain version, the tail included; the bound
    counts the IoU pairs of the phases these inputs need; the launch shape
    gives K3's cluster size and how many clusters the card runs at once."""
    boxes, valid, iou = args
    tile, enough = kw["tile"], kw["enough"]
    shape = nms_cuda.launch_shape(boxes, tile, enough)
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
              tile_phases=phases, kept=keep_np.sum(1).tolist(), launch=shape)
    _log_case("nms", c, f"{tuple(boxes.shape)} tile {tile} iou {iou} enough {enough}: "
              f"mismatches={mismatches}, valid/img {valid_np.sum(1).tolist()}, IoU pairs={pairs}, "
              f"tile phases/img {phases}; clusters of {shape['cluster']} blocks, "
              f"{shape['smem_bytes']} B shared each, at most {shape['max_active_clusters']} "
              f"clusters at once: {shape['waves']} wave(s) of {boxes.shape[0]}")
    return c


def check_nms_later_step(run) -> dict:
    """K3 on the proposals of a later train step, captured after every
    other step of the run (more survivors per tile as the weights move)."""
    step = run.opt.count + 1
    calls, _ = run.capture()
    (args, kw), = calls["nms"]
    del calls
    c = check_nms(f"train proposal NMS, step {step}", args, kw)
    if not c["ok"]:
        raise RuntimeError(f"K3 disagrees with its plain version: {c['case']}")
    return c


def topk_adversarial(k: int, b: int = 16, n: int = 64296, seed: int = 0) -> np.ndarray:
    """Seeded (b, n) f32 scores with K4's hard cases, one to a row (rows past
    b are left out): uniform scores with 30% masked to -1e30 in every row,
    then row 1 a 0.5 plateau; row 2 -0.0, then +0.0; row 3 all -1e30;
    row 4 a tail of +inf; row 5 all NaN; row 6 NaN of both signs and -inf;
    rows 7 and 8 k // 2 scores above a plateau (-1e30, then 0.25) that holds
    the k-th key and runs over every slice boundary; row 0 stays plain."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(size=(max(b, 9), n)).astype(np.float32)
    x[rng.uniform(size=x.shape) < 0.3] = -1e30
    x[1, rng.randint(0, n, n // 20)] = 0.5
    x[2, :n // 12] = -0.0
    x[2, n // 12:n // 7] = 0.0
    x[3] = -1e30
    x[4, n - n // 200:] = np.inf
    x[5] = np.nan
    for value in (np.nan, -np.nan, -np.inf):
        x[6, rng.randint(0, n, n // 50)] = value
    for row, plateau in ((7, -1e30), (8, 0.25)):
        x[row] = plateau
        x[row, rng.choice(n, k // 2, replace=False)] = rng.uniform(0.5, 1.0, k // 2)
    return x[:b]


def check_topk(label, scores, k) -> dict:
    """Bit for bit against the plain version (a stable sort of total-order
    int32 keys); the library call is ``torch.sort(stable=True)`` of the
    scores."""
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


def check_topk_adversarial(dev) -> list:
    """K4 on topk_adversarial's rows (the GPU tests' hard cases) at the
    detect call's k and the sampler's, beside the paths' own inputs."""
    cases = [check_topk(f"adversarial k={k}", torch.tensor(topk_adversarial(k), device=dev), k)
             for k in (8000, 128)]
    bad = [c["case"] for c in cases if not c["ok"]]
    if bad:
        raise RuntimeError(f"K4 disagrees with its plain version: {bad}")
    return cases


def expected_launches(path: str, n: int) -> dict:
    """Every kernel's launches in ``n`` calls or steps of ``path``."""
    per = PATHS[path][0]
    return {k: per.get(k, 0) * n for k in _build.LAUNCHES}


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
    _, nms_labels, topk_labels = PATHS[path]
    if (len(calls.get("nms", [])), len(calls.get("topk", []))) != (len(nms_labels),
                                                                    len(topk_labels)):
        raise RuntimeError(f"{path}: NMS and top-k calls {len(calls.get('nms', []))}, "
                           f"{len(calls.get('topk', []))}, expected {nms_labels}, {topk_labels}")
    for label, (args, kw) in zip(nms_labels, calls.get("nms", [])):
        out.setdefault("nms", []).append(check_nms(f"{path} {label}", args, kw))
    for label, (args, _) in zip(topk_labels, calls.get("topk", [])):
        out.setdefault("topk", []).append(check_topk(f"{path} {label} k={args[1]}", *args))
    bad = [f"{k} {c['case']}" for k, cases in out.items() for c in cases if not c["ok"]]
    if bad:
        raise RuntimeError(f"kernels disagree with their plain versions: {bad}")
    return out


def _total(cases):
    if not cases:
        return None
    lib = [c["library_ms"] for c in cases]
    return {"ms": sum(c["ms"] for c in cases), "plain_ms": sum(c["plain_ms"] for c in cases),
            "bound_ms": sum(c["bound_ms"] for c in cases), "bound_by": cases[0]["bound_by"],
            "library_ms": None if None in lib else sum(lib),
            "max_abs_err": max(c["max_abs_err"] for c in cases)}


def kernel_entries(cases: dict, launches: dict, topk_adversarial_cases: list,
                   nms_later: dict) -> list:
    """The kernels line. ``cases`` and ``launches`` are keyed by path: the
    checked calls of one recorded run, and the launches of one call or step
    of the timed run. Per kernel: ``launches`` over one run of each of this
    slice's paths (MAIN_PATHS), and the times, bound and error summed over
    their cases (the kernel's calls in one run of each); ``paths`` gives
    the same per path, the ResNet-50 detect call and joint step included.
    K4 also lists its adversarial cases, K3 its case on a later joint
    step."""
    out = []
    for name, (src, replaces) in SOURCES.items():
        main = [c for p in MAIN_PATHS for c in cases.get(p, {}).get(name, [])]
        if not main:
            raise RuntimeError(f"{name} was checked on none of the paths {MAIN_PATHS}")
        entry = {"name": name, "route": "cuda", "source": f"faster_rcnn_tpu_torch/csrc/{src}",
                 "replaces": replaces,
                 "launches": sum(launches[p][name] for p in MAIN_PATHS if p in launches),
                 **_total(main)}
        entry["paths"] = {p: dict(_total(pc[name]), launches=launches[p][name])
                          for p, pc in cases.items() if pc.get(name)}
        if name == "topk":
            entry["adversarial"] = [{key: c[key] for key in ("case", "ms", "library_ms",
                                                              "max_abs_err")}
                                    for c in topk_adversarial_cases]
        if name == "nms":
            entry["later_step"] = {key: nms_later[key] for key in (
                "case", "ms", "plain_ms", "bound_ms", "max_abs_err", "tile_phases", "launch")}
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
    """A network at a KITTI config (``kitti_config()``: ResNet-50) with
    seeded random weights, B=16 uint8 canvases holding a 453x1500 image
    each, and the detect function."""

    def __init__(self, rng, dev, b: int = 16, cfg=None, path: str = "detect"):
        self.cfg = kitti_config() if cfg is None else cfg
        self.b, self.path = b, path
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
    path = run.path
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
    log(f"[{path}] {cfg.model.network} KITTI B={b} {images.shape[1]}x{images.shape[2]}, "
        f"{batches} batches: {info}")
    want = expected_launches(path, batches)
    if launches != want:
        raise RuntimeError(f"kernel launches {launches}, expected {want}")
    os.makedirs(OUT_DIR, exist_ok=True)
    with uncounted(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        detect(images, img_hw)
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
    with open(os.path.join(OUT_DIR, f"{path}_profile.txt"), "w") as f:
        f.write(table)
    log(f"[{path} profile] top kernels by device time:\n" + "\n".join(table.splitlines()[:25]))
    info["profiled_batch"] = device_busy(prof)
    log(f"[{path} profile] one batch on the device: {info['profiled_batch']}")
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


def stage_times(step, batch, gen, reps: int = 3) -> dict:
    """ms of each stage of a train step, from CUDA events at the step's
    marks, the mean over ``reps`` further (uncounted) steps."""
    stages: dict = {}
    with uncounted():
        for _ in range(reps):
            events = [("start", torch.cuda.Event(enable_timing=True))]
            events[0][1].record()

            def mark(name):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                events.append((name, ev))

            step(batch, gen, mark=mark)
            torch.cuda.synchronize()
            for (_, a), (name, b) in zip(events, events[1:]):
                stages[name] = stages.get(name, 0.0) + a.elapsed_time(b) / reps
    stages["sum"] = sum(stages.values())
    return stages


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
    log(f"[train] {run.cfg.model.network} KITTI joint step B={run.b}, {TRAIN_STEPS} steps after "
        f"{TRAIN_WARMUP} warm-up: {info}")
    if not all(np.isfinite(v) for m in losses for v in m.values()):
        raise RuntimeError(f"non-finite train metrics {losses}")
    want = expected_launches("train", TRAIN_STEPS)
    if launches != want:
        raise RuntimeError(f"kernel launches {launches}, expected {want}")
    info["breakdown_ms"] = stage_times(run.step, run.batch, run.gen)
    log(f"[train breakdown] ms per B={run.b} step: "
        + ", ".join(f"{k} {v:.3f}" for k, v in info["breakdown_ms"].items()))
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


def _train_once(cfg, state, dev, batch, draws, plain: bool, step="joint", rpn_state=None,
                mesh=None):
    """One train step (the joint step, or a step 1-4 of the 4-step scheme
    with ``rpn_state`` its frozen RPN) from ``state``, SGD lr 1e-3 with
    momentum: (metrics, parameters after, labels). On a ``mesh`` (the
    joint step only) this rank's rows of the global ``batch`` and
    ``draws``, data-parallel."""
    model = _model(cfg, state, dev)
    fb, fm = step_freeze_spec(step, cfg)
    opt = make_optimizer(model, cfg.model.network, fb, 1e-3, momentum=0.9, freeze_modules=fm,
                         mesh=mesh)
    if mesh is not None:
        batch = mesh_lib.shard_batch(mesh, batch)
        draws = pipeline.Draws(**mesh_lib.shard_batch(mesh, draws._asdict()))
        run = pipeline.make_joint_train_step(cfg, model, opt, fb, fm, device=dev)
    elif step == "joint":
        run = pipeline.make_joint_train_step(cfg, model, opt, fb, fm, device=dev)
    elif step in (1, 3):
        run = pipeline.make_rpn_train_step(cfg, model, opt, fb, fm, device=dev)
    else:
        run = pipeline.make_det_train_step(cfg, model, opt, _model(cfg, rpn_state, dev),
                                           heads_only=step == 4, freeze_blocks=fb,
                                           freeze_modules=fm, device=dev)
    with uncounted(), (plain_versions() if plain else contextlib.nullcontext()):
        metrics = run(batch, draws)
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
    ok = (loss_err <= 1e-4 and not frozen_moved and gm.get("num_valid_images") ==
          wm.get("num_valid_images") and worst["rpn_head"][0] <= 2e-2
          and worst["rest"][0] <= 1e-3)
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


# --------------------------------------------------------------------------
# phase 7-8: VGG16 and ResNet-101; the 4-step scheme on VGG16
# --------------------------------------------------------------------------


def vgg_kitti_config(compute_dtype: str = "bfloat16"):
    """kitti_config() on VGG16 with the VGG values of voc_config("vgg16"):
    blocks 1-2 frozen, no weight decay."""
    base = kitti_config()
    return base.replace(model=dataclasses.replace(
        base.model, network="vgg16", freeze_blocks=(1, 2), weight_decay=0.0,
        compute_dtype=compute_dtype))


def r101_kitti_config():
    base = kitti_config()
    return base.replace(model=dataclasses.replace(base.model, network="resnet101"))


def phase_other_detect(rng, dev) -> tuple:
    """VGG16 and ResNet-101 detection at B=16 with their kernel checks:
    ({path: info}, {path: cases})."""
    infos, cases = {}, {}
    for path, cfg in (("vgg16_detect", vgg_kitti_config()),
                      ("resnet101_detect", r101_kitti_config())):
        run = KittiDetect(rng, dev, cfg=cfg, path=path)
        calls, first = run.capture()
        with torch.inference_mode():
            cases[path] = check_kernels(calls, path)
        del calls
        infos[path] = phase_detect(run, first)
        del run
        torch.cuda.empty_cache()
    return infos, cases


class FourStep:
    """The 4-step scheme on VGG16 at vgg_kitti_config(), B=16: a fresh
    seeded model, seeded uint8 canvases with ground truth as KittiTrain's,
    and each step's model built from the weights the steps before it hand
    over (trainer.py:325-352 of the JAX package)."""

    def __init__(self, rng, dev, b: int = 16, seed: int = 0):
        self.cfg = vgg_kitti_config()
        self.dev, self.b = dev, b
        self.fresh = init_model(seed, self.cfg, "cpu").state_dict()
        self.batch = {k: torch.as_tensor(v, device=dev)
                      for k, v in kitti_train_batch(rng, b, self.cfg).items()}
        self.gen = torch.Generator(device=dev).manual_seed(seed)
        self.models: dict = {}  # trained models the later steps still need

    def build(self, step: int):
        """Step ``step``'s model, optimizer (SGD lr 1e-3, momentum 0.9, clip
        10, from step_freeze_spec) and step function."""
        cfg, handoff = self.cfg, {3: (2, ["backbone"]), 4: (3, ["backbone", "rpn_head"])}
        state = self.fresh
        if step in handoff:
            src, keys = handoff[step]
            state = merge_params(self.fresh, self.models[src].state_dict(), keys)
        model = _model(cfg, state, self.dev)
        fb, fm = step_freeze_spec(step, cfg)
        opt = make_optimizer(model, cfg.model.network, fb, 1e-3, momentum=0.9,
                             weight_decay=cfg.model.weight_decay, freeze_modules=fm,
                             clip_grad_norm=10.0)
        if step in (1, 3):
            fn = pipeline.make_rpn_train_step(cfg, model, opt, fb, fm, device=self.dev)
        else:
            fn = pipeline.make_det_train_step(cfg, model, opt, self.models[step - 1],
                                              heads_only=step == 4, freeze_blocks=fb,
                                              freeze_modules=fm, device=self.dev)
        return model, opt, fn


def phase_four_step(run: FourStep) -> tuple:
    """Steps 1 -> 2 -> 3 -> 4: per step one recorded step whose kernel
    calls are checked, 2 warm-up and 3 timed steps (img/s, ms, launches,
    peak memory), and the stage times of 3 more. A step's optimizer state is
    freed before the next step starts. Returns ({step: info}, {step:
    cases})."""
    infos, cases = {}, {}
    needed_until = {1: 2, 2: 3, 3: 4}  # a step's model serves the next step
    for step in (1, 2, 3, 4):
        path = f"step{step}"
        model, opt, fn = run.build(step)
        calls: dict = {}
        with recording(calls):
            t0 = time.perf_counter()
            fn(run.batch, run.gen)
            torch.cuda.synchronize()
            first = time.perf_counter() - t0
        cases[path] = check_kernels(calls, path)
        del calls
        with uncounted():
            for _ in range(FOUR_STEP_WARMUP):
                fn(run.batch, run.gen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        t0 = time.perf_counter()
        metrics = [fn(run.batch, run.gen) for _ in range(FOUR_STEP_TIMED)]
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        losses = [{k: float(v) for k, v in m.items()} for m in metrics]
        info = {"img_per_s": run.b * FOUR_STEP_TIMED / sec,
                "step_ms": sec / FOUR_STEP_TIMED * 1e3, "first_step_s": first,
                "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                "launches": launches, "metrics": losses,
                "trainable": sum(lab == "train" for lab in opt.labels.values())}
        log(f"[{path}] VGG16 KITTI B={run.b}, {FOUR_STEP_TIMED} steps after "
            f"{FOUR_STEP_WARMUP} warm-up: {info}")
        if not all(np.isfinite(v) for m in losses for v in m.values()):
            raise RuntimeError(f"non-finite {path} metrics {losses}")
        want = expected_launches(path, FOUR_STEP_TIMED)
        if launches != want:
            raise RuntimeError(f"{path} kernel launches {launches}, expected {want}")
        info["breakdown_ms"] = stage_times(fn, run.batch, run.gen)
        log(f"[{path} breakdown] ms per B={run.b} step: "
            + ", ".join(f"{k} {v:.3f}" for k, v in info["breakdown_ms"].items()))
        infos[path] = info
        del opt, fn  # the optimizer's state goes with the step function
        run.models[step] = model
        for done in [s for s, until in needed_until.items() if until == step]:
            run.models.pop(done, None)
        torch.cuda.empty_cache()
    run.models.clear()
    return infos, cases


def phase_whole_four_step(rng, dev) -> dict:
    """Steps 1, 2 and 4 at the full canvas, B=2, f32, from the same
    weights, batch and draws: the card's kernels against the card's plain
    versions, with phase_whole_train's limits (_step_agreement). The
    frozen RPN of steps 2 and 4 has its outputs made of biases
    (_bias_only_rpn), so that its proposals are the same on both sides;
    step 1's kernels see no output of the model (K4 samples anchors by
    uniform priorities), so it starts from random weights."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = vgg_kitti_config("float32")
    state = init_model(1, cfg, "cpu").state_dict()
    rpn_state = _bias_only_rpn(init_model(2, cfg, "cpu").state_dict(), cfg.anchors.num_anchors)
    batch = kitti_train_batch(rng, 2, cfg)
    draws = pipeline.draw_samples(cfg, 2, torch.Generator(device=dev).manual_seed(3))
    out = {}
    for step in (1, 2, 4):
        runs = [_train_once(cfg, state, dev, batch, draws, plain, step, rpn_state)
                for plain in (False, True)]
        out[f"step{step}_kitti_b2_f32"] = _step_agreement(state, *runs)
        del runs
        torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = True
    log(f"[whole four-step path] {json.dumps(out)}")
    # steps 2 and 4 compare something only where both images have ROIs
    bad = [k for k, v in out.items()
           if not v["ok"] or v["metrics"].get("num_valid_images", 2) != 2]
    if bad:
        raise RuntimeError(f"the 4-step scheme's kernels and plain versions disagree: {bad}")
    return out


# --------------------------------------------------------------------------
# phase 9: loader_train, the user's workflow from JPEGs on disk
# --------------------------------------------------------------------------


class _Tee(io.TextIOBase):
    """Standard output that is also kept, to read what a CLI printed."""

    def __init__(self, out):
        self.out, self.text = out, []

    def write(self, text):
        self.text.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


class LoaderRun:
    """Instruments the trainer while the CLIs run, without changing what
    they do. Each ``train_one_step`` is a path whose kernel launches are
    counted from its start to its end. Its loader's batches are counted as
    the workers make them and as the trainer takes them, with the time each
    take waited; the backlog a take found is the batches made and not yet
    taken. The timed window is LOADER_TIMED iterations on the host clock
    between two synchronizes. It starts at the first iteration after
    LOADER_WARMUP whose batch found no backlog, so that no batch made
    before the window is counted in it, or at ``latest`` if the loader
    stays ahead of the card. The inputs of every kernel call of its first
    iteration are recorded (counted, as the path's own launches), and the
    LOADER_PROFILED iterations after it run under torch.profiler. Every
    checkpoint write is timed after a synchronize."""

    def __init__(self, latest: int):
        self.latest = latest
        self.info: dict = {}      # path -> what its run measured
        self.calls: dict = {}     # path -> the recorded kernel calls
        self.path = None
        self.capturing = False
        self.prof = None
        self.loaders: list = []
        self.lock = threading.Lock()
        self.made = 0             # batches this run's workers made
        self.takes: list = []     # per batch taken: (backlog found, seconds waited)
        self.old: set = set()     # threads that are not this run's workers

    def _record(self, name, fn):
        def wrapped(*args, **kw):
            if self.capturing:
                self.calls.setdefault(self.path, {}).setdefault(name, []).append((args, kw))
            return fn(*args, **kw)
        return wrapped

    def _train_one_step(self, orig):
        def run(step, *a, **k):
            self.path = f"loader_step{step}" if isinstance(step, int) else "loader_joint"
            if self.path in self.info:  # a second run of the step: the resume
                self.path += "_resumed"
            info = self.info[self.path] = {"checkpoints": [], "iterations": 0}
            # a closed loader's workers may still finish a batch: not counted
            self.old, self.made, self.takes = set(threading.enumerate()), 0, []
            _build.reset_launches()
            t0 = time.perf_counter()
            result = orig(step, *a, **k)
            torch.cuda.synchronize()
            info.update(run_s=time.perf_counter() - t0, launches=dict(_build.LAUNCHES),
                        final_metrics=result.final_metrics)
            return result
        return run

    def _stack(self, orig):
        def stack(examples):
            out = orig(examples)
            if threading.current_thread() not in self.old:
                with self.lock:
                    self.made += 1
            return out
        return stack

    def _make_step(self, orig):
        def build(*a, **k):
            fn = orig(*a, **k)

            def step(batch, draws):
                info = self.info[self.path]
                i, start = info["iterations"], info.get("start")
                info["iterations"] = i + 1
                if start is None and i >= LOADER_WARMUP and (
                        self.takes[i][0] == 0 or i == self.latest):
                    torch.cuda.synchronize()
                    info.update(t0=time.perf_counter(), start=i, backlog_at_start=self.takes[i][0],
                                made_at_start=self.made)
                    self.capturing = True
                elif start is not None and i == start + LOADER_TIMED:
                    torch.cuda.synchronize()
                    info.update(t1=time.perf_counter(),
                                made=self.made - info.pop("made_at_start"),
                                wait_s=sum(w for _, w in self.takes[start + 1:i + 1]))
                    self.prof = torch.profiler.profile(activities=[
                        torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
                    self.prof.__enter__()
                out = fn(batch, draws)
                self.capturing = False
                if start is not None and i == start + LOADER_TIMED + LOADER_PROFILED - 1:
                    torch.cuda.synchronize()
                    self.prof.__exit__(None, None, None)
                    info["profiled"] = device_busy(self.prof)
                    self.prof = None
                return out
            return step
        return build

    def _save(self, orig):
        def save(directory, step, tree, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            orig(directory, step, tree, **kw)
            self.info[self.path]["checkpoints"].append({
                "step": step, "seconds": time.perf_counter() - t0,
                "bytes": _dir_bytes(os.path.join(directory, str(step)))})
        return save

    def _loader(self, *a, **k):
        loader = data_pipeline.TrainLoader(*a, **k)
        self.loaders.append(loader)
        return _TakenLoader(loader, self)

    @contextlib.contextmanager
    def patched(self):
        patches = [(trainer, "train_one_step", self._train_one_step(trainer.train_one_step)),
                   (trainer, "TrainLoader", self._loader),
                   (data_pipeline, "_stack", self._stack(data_pipeline._stack)),
                   (checkpoint, "save", self._save(checkpoint.save))]
        patches += [(pipeline, name, self._make_step(getattr(pipeline, name)))
                    for name in ("make_rpn_train_step", "make_det_train_step",
                                 "make_joint_train_step")]
        patches += [(mod, attr, self._record(name, fn)) for mod, attr, name, fn in (
            (resnet, "conv1_kernel", "conv1", conv1_cuda.conv1),
            (inference, "roi_align", "roi_align", roi_align_cuda.roi_align),
            (pipeline, "roi_align", "roi_align", roi_align_cuda.roi_align),
            (roi_align_cuda, "roi_align_backward", "roi_align_bwd",
             roi_align_cuda.roi_align_backward),
            (nms_cuda, "nms_keep_mask", "nms", nms_cuda.nms_keep_mask),
            (sort_cuda, "topk_sorted", "topk", sort_cuda.topk_sorted))]
        with contextlib.ExitStack() as stack:
            for mod, attr, fn in patches:
                stack.enter_context(mock.patch.object(mod, attr, fn))
            yield

    def cli(self, main, argv):
        """A CLI's main under the instrumentation, its output kept."""
        tee = _Tee(sys.stdout)
        with self.patched(), contextlib.redirect_stdout(tee):
            result = main(argv)
        return result, "".join(tee.text)


class _TakenLoader:
    """A TrainLoader whose batches are counted as the trainer takes them."""

    def __init__(self, loader, run: LoaderRun):
        self.loader, self.run = loader, run

    def __iter__(self):
        it = iter(self.loader)
        try:
            while True:
                backlog, t0 = self.run.made - len(self.run.takes), time.perf_counter()
                item = next(it)
                self.run.takes.append((backlog, time.perf_counter() - t0))
                yield item
        finally:
            it.close()


def join_loader_workers() -> None:
    """Wait for the workers of closed loaders, which end the batch they are
    on; call it only when no loader is open."""
    for t in threading.enumerate():
        if t.name == "TrainLoader-worker":
            t.join()


def loader_alone(records, cfg, workers: int = 0) -> dict:
    """The loader's own rate: batches of LOADER_BATCH as fast as its
    workers (0: its default count) decode them, with nothing consuming them
    but this loop. Each worker makes a whole batch, so batches come in
    rounds of one a worker: the first round is skipped, the next two are
    timed. The workers are joined before it returns, so that a timing after
    it has the cores to itself."""
    loader = data_pipeline.TrainLoader(records, KITTI_CLASS_MAPPING, cfg, LOADER_BATCH,
                                       uint8=True, num_workers=workers)
    it, n = iter(loader), loader.num_workers
    try:
        for _ in range(n):
            next(it)
        t0 = time.perf_counter()
        for _ in range(2 * n):
            next(it)
        sec = time.perf_counter() - t0
    finally:
        it.close()
        join_loader_workers()
    return {"img_per_s": LOADER_BATCH * 2 * n / sec, "workers": n, "batches_timed": 2 * n}


SERVE_FLAGS = ["--kitti", "--device", "cuda", "--resize_dims", "600,1500"]
COMMON_FLAGS = SERVE_FLAGS + ["--batch_size", str(LOADER_BATCH)]


def loader_iterations() -> tuple:
    """(latest window start, iterations a step) of phase 9, which phase 10
    runs as well: the loader holds up to workers + prefetch batches ready,
    and draining them takes 1 / (1 - loader rate / card rate) iterations
    each."""
    probe = data_pipeline.TrainLoader([], KITTI_CLASS_MAPPING, kitti_config(), LOADER_BATCH)
    latest = LOADER_WARMUP + 3 * (probe.num_workers + probe.prefetch)
    return latest, latest + LOADER_TIMED + LOADER_PROFILED


def make_dataset(root: str) -> dict:
    """The KITTI-synthetic dataset of phases 9 and 10, written to ``root``."""
    t0 = time.perf_counter()
    kitti_synth.build_kitti_synth_dataset(root, KITTI_CLASS_MAPPING, n_train=LOADER_TRAIN,
                                          n_val=LOADER_VAL)
    info = {"bytes": _dir_bytes(root), "seconds": time.perf_counter() - t0,
            "train": LOADER_TRAIN, "val": LOADER_VAL}
    log(f"[dataset] KITTI-synthetic: {LOADER_TRAIN} train + {LOADER_VAL} val frames at "
        f"1242x375, {info['bytes']} bytes written in {info['seconds']:.2f} s")
    return info


def phase_loader_train(in_memory: dict, root: str, tmp: str) -> tuple:
    """Phase 9 (the module docstring) on the dataset at ``root``, its
    workdir under ``tmp``. ``in_memory`` holds the img/s of the in-memory
    phases by path. Returns (info, {path: kernel cases})."""
    common = COMMON_FLAGS
    probe = data_pipeline.TrainLoader([], KITTI_CLASS_MAPPING, kitti_config(), LOADER_BATCH)
    latest, total = loader_iterations()
    out = {"cpu_count": os.cpu_count(), "workers": probe.num_workers,
           "latest_window_start": latest, "iterations": total}
    run = LoaderRun(latest)
    work, dets = (os.path.join(tmp, d) for d in ("loader_work", "loader_dets"))
    log(f"[loader_train] os.cpu_count() {out['cpu_count']}, loader "
        f"workers {out['workers']}, {LOADER_TIMED} timed iterations from the first of "
        f"{LOADER_WARMUP}-{latest} that finds no batch ready, of {total}")
    train = ["--voc_paths", root, "--img_set", "train", "--workdir", work,
             "--clip_grad_norm", "10", *common]
    recs, _ = load_dataset([root], "train", resize_min=600, resize_max=1500)
    out["loader_alone"] = loader_alone(recs, kitti_config())
    log(f"[loader_train] the loader alone (uint8 canvases, nothing consuming): "
        f"{out['loader_alone']}")

    _, text = run.cli(cli_train.main, train + ["--network", "vgg16", "--step", "all",
                                              "--phases", f"{total}:1e-3"])
    _, text = run.cli(cli_train.main, train + ["--network", "vgg16", "--step", "1",
                                              "--phases", f"{total + 2}:1e-3"])
    resumed = f"[step 1] resumed from iteration {total} (optimizer count {total})"
    ck = checkpoint.restore(os.path.join(work, "step1"))
    if resumed not in text or ck["count"] != total + 2 or \
            ck["optimizer"]["count"] != total + 2:
        raise RuntimeError(f"step 1 did not resume from {total} and go on to {total + 2}: "
                           f"count {ck['count']}, optimizer count {ck['optimizer']['count']}")
    del ck
    out["resume"] = {"from": total, "to": total + 2,
                     "run_s": run.info["loader_step1_resumed"]["run_s"]}
    run.cli(cli_train.main, train + ["--network", "resnet50", "--step", "joint",
                                     "--phases", f"{total}:1e-3"])
    for step in ("1", "2", "3", "4", "joint"):
        latest = checkpoint.latest_step(os.path.join(work, f"step{step}"))
        if latest != (total + 2 if step == "1" else total):
            raise RuntimeError(f"step {step}: latest checkpoint {latest}")

    _build.reset_launches()
    run.path, run.capturing = "loader_detect", True
    run.info["loader_detect"] = {}
    t0 = time.perf_counter()
    run.cli(cli_detect.main, ["--voc_paths", root, "--img_set", "val", "--workdir", work,
                              "--from_step", "4", "--out_dir", dets, "--network", "vgg16",
                              *common])
    torch.cuda.synchronize()
    run.capturing = False
    run.info["loader_detect"].update(run_s=time.perf_counter() - t0,
                                     launches=dict(_build.LAUNCHES), iterations=1)
    files = sorted(os.listdir(dets)) if os.path.isdir(dets) else []
    aps, _ = run.cli(cli_evaluate.main, ["--voc_path", root, "--dets_path", dets, "--kitti",
                                         "--img_set", "val"])
    out["detect"] = {"files": files, "mAP": aps["mAP"], "aps": aps}
    join_loader_workers()
    if not files or not np.isfinite(aps["mAP"]) or not 0.0 <= aps["mAP"] <= 1.0:
        raise RuntimeError(f"detect/evaluate: files {files}, mAP {aps['mAP']}")

    out["decoder"] = ({"native": True, "library": native_loader.build_info["library"]}
                      if "library" in native_loader.build_info else
                      {"native": False, "pil_because": native_loader.build_info.get("error")})
    out["loader_workers_seen"] = sorted({ld.num_workers for ld in run.loaders})
    out["paths"] = {}
    for path, info in run.info.items():
        if "t1" in info:
            sec = info["t1"] - info["t0"]
            info.update(loader_fed_img_per_s=LOADER_BATCH * LOADER_TIMED / sec,
                        made_img_per_s=LOADER_BATCH * info["made"] / sec,
                        wait_share=info["wait_s"] / sec)
            # with a backlog at the start the rate taken can outrun the rate made
            info["sustained_img_per_s"] = min(info["loader_fed_img_per_s"],
                                              info["made_img_per_s"])
        info = {k: v for k, v in info.items() if k not in ("t0", "t1")}
        info["in_memory_img_per_s"] = in_memory.get(path.replace("loader_", "").replace(
            "joint", "train"))
        out["paths"][path] = info
        log(f"[loader_train {path}] {json.dumps(info)}")
        if path in LOADER_PATHS and path != "loader_detect" and "profiled" not in info:
            raise RuntimeError(f"{path}: no timed and profiled window in {info['iterations']} "
                               "iterations")
        if path in LOADER_PATHS:
            want = expected_launches(path, info["iterations"])
            if info["launches"] != want:
                raise RuntimeError(f"{path}: kernel launches {info['launches']}, expected {want}")
    log(f"[loader_train] decoder {out['decoder']}; os.cpu_count() {out['cpu_count']}; loader "
        f"workers {out['loader_workers_seen']}; mAP after {total} iterations a step (meaningless, "
        f"printed only) {aps['mAP']:.4f}, {len(files)} detection files")
    cases = {}
    for path in LOADER_PATHS:
        cases[path] = check_kernels(run.calls.pop(path, {}), path)
    shutil.rmtree(work)  # five steps' checkpoints, 3.5 GB
    return out, cases


# --------------------------------------------------------------------------
# phase 10: cached_train, the same workflow from the device cache
# --------------------------------------------------------------------------


class CachedRun:
    """Instruments ``train_cached`` and the annotate CLI while the CLIs run,
    without changing what they do. Each ``train_cached`` is a path whose
    kernel launches are counted from its start to its end, with its peak
    memory. Each ``build_device_dataset`` is timed between two
    synchronizes, with the bytes it holds on the card. Chunks are counted,
    and each one's rate taken on the host clock from its start to the next
    chunk's (the chunk ends in its metric read, which waits for the card):
    the first CACHED_WARMUP are the warm-up; the timed window runs on the
    host clock from a synchronize before chunk CACHED_WARMUP to one before
    the chunk CACHED_TIMED // CACHED_CHUNK after it, so it holds
    CACHED_TIMED iterations with the chunks' boundaries and their metric
    reads; the chunk after it runs under ``utils/profiling.device_trace``.
    The kernel calls of the window's first iteration (and of annotate's
    first frame) are recorded, counted as the path's own launches."""

    def __init__(self, trace_dir: str):
        self.trace_dir = trace_dir
        self.info: dict = {}      # path -> what its run measured
        self.calls: dict = {}     # path -> the recorded kernel calls
        self.path = None
        self.capturing = False

    def _record(self, name, fn):
        def wrapped(*args, **kw):
            if self.capturing:
                self.calls.setdefault(self.path, {}).setdefault(name, []).append((args, kw))
            return fn(*args, **kw)
        return wrapped

    def _train_cached(self, orig):
        def run(step, *a, **k):
            self.path = f"cached_step{step}" if isinstance(step, int) else "cached_joint"
            if self.path in self.info:  # a second run of the step: the resume
                self.path += "_resumed"
            info = self.info[self.path] = {"iterations": 0, "chunks": 0, "builds": [],
                                           "chunk_starts": []}
            torch.cuda.synchronize()
            # the earlier steps' weights, which run_four_step_training hands on
            info["allocated_at_start_gb"] = torch.cuda.memory_allocated() / 1e9
            torch.cuda.reset_peak_memory_stats()
            _build.reset_launches()
            t0 = time.perf_counter()
            result = orig(step, *a, **k)
            torch.cuda.synchronize()
            starts = info.pop("chunk_starts")
            info.update(run_s=time.perf_counter() - t0, launches=dict(_build.LAUNCHES),
                        max_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
                        final_metrics=result.final_metrics,
                        # each chunk but the last and the traced one
                        chunk_img_per_s=[None if traced else LOADER_BATCH * n / (b - a)
                                         for (a, n, traced), (b, _, _) in
                                         zip(starts, starts[1:])])
            return result
        return run

    def _build_cache(self, orig):
        def build(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            buckets = orig(*a, **k)
            torch.cuda.synchronize()
            self.info[self.path]["builds"].append({
                "seconds": time.perf_counter() - t0,
                "bytes": sum(b.nbytes for b in buckets.values()),
                "records": sum(b.n for b in buckets.values()),
                "canvases": [list(c) for c in buckets]})
            return buckets
        return build

    def _scan(self, orig):
        def make(step_fn):
            def step(batch, draws):
                info = self.info[self.path]
                i = info["iterations"]
                info["iterations"] = i + 1
                # the window's first iteration
                self.capturing = i == CACHED_WARMUP * CACHED_CHUNK
                try:
                    return step_fn(batch, draws)
                finally:
                    self.capturing = False

            run = orig(step)

            def chunk(bucket, idx, flip, draws):
                info = self.info[self.path]
                c = info["chunks"]
                info["chunks"] = c + 1
                end = CACHED_WARMUP + CACHED_TIMED // CACHED_CHUNK
                if c in (CACHED_WARMUP, end):
                    torch.cuda.synchronize()
                    info["t0" if c == CACHED_WARMUP else "t1"] = time.perf_counter()
                    info["window_iterations" if c == end else "start"] = info["iterations"]
                info["chunk_starts"].append((time.perf_counter(), int(idx.shape[0]), c == end))
                if c != end:
                    return run(bucket, idx, flip, draws)
                with profiling.device_trace(os.path.join(self.trace_dir, self.path)) as prof:
                    out = run(bucket, idx, flip, draws)
                info["profiled"] = dict(device_busy(prof), steps=int(idx.shape[0]),
                                        k1_fwd=kernel_device_us(prof, "roi_align_kernel"))
                return out
            return chunk
        return make

    def _detect_fn(self, orig):
        def make(*a, **k):
            detect = orig(*a, **k)
            calls = [0]

            def once(*args):
                self.capturing = self.path == "annotate" and calls[0] == 0
                calls[0] += 1
                try:
                    return detect(*args)
                finally:
                    self.capturing = False
            return once
        return make

    @contextlib.contextmanager
    def patched(self):
        patches = [(device_cache, "train_cached", self._train_cached(device_cache.train_cached)),
                   (device_cache, "build_device_dataset",
                    self._build_cache(device_cache.build_device_dataset)),
                   (device_cache, "make_scan_train_fn",
                    self._scan(device_cache.make_scan_train_fn)),
                   (cli_annotate, "make_detect_fn", self._detect_fn(inference.make_detect_fn))]
        patches += [(mod, attr, self._record(name, fn)) for mod, attr, name, fn in (
            (resnet, "conv1_kernel", "conv1", conv1_cuda.conv1),
            (inference, "roi_align", "roi_align", roi_align_cuda.roi_align),
            (pipeline, "roi_align", "roi_align", roi_align_cuda.roi_align),
            (roi_align_cuda, "roi_align_backward", "roi_align_bwd",
             roi_align_cuda.roi_align_backward),
            (nms_cuda, "nms_keep_mask", "nms", nms_cuda.nms_keep_mask),
            (sort_cuda, "topk_sorted", "topk", sort_cuda.topk_sorted))]
        with contextlib.ExitStack() as stack:
            for mod, attr, fn in patches:
                stack.enter_context(mock.patch.object(mod, attr, fn))
            yield

    def cli(self, main, argv):
        """A CLI's main under the instrumentation, its output kept."""
        tee = _Tee(sys.stdout)
        with self.patched(), contextlib.redirect_stdout(tee):
            result = main(argv)
        return result, "".join(tee.text)


def _val_frames(root: str, out: str) -> str:
    """The val frames of the dataset at ``root``, copied into ``out``."""
    os.makedirs(out)
    with open(os.path.join(root, "ImageSets", "Main", "val.txt")) as f:
        names = f.read().split()
    for name in names:
        shutil.copy(os.path.join(root, "JPEGImages", name + ".jpg"), out)
    return out


def h5_round_trip(root: str, work: str, tmp: str) -> dict:
    """Where h5py imports: ``cli.export_h5`` of step 4, ``load_keras_h5``
    into a fresh model's state dict, and that model's detections on the
    val frames against the checkpoint's, bit for bit. Where it does not,
    says so: the h5 tools are a host file format, held by the CPU tests."""
    try:
        import h5py  # noqa: F401
    except ImportError as e:
        return {"h5py": False, "why": str(e)}
    from faster_rcnn_tpu_torch.cli import export_h5 as cli_export_h5
    from faster_rcnn_tpu_torch.utils.keras_import import load_keras_h5

    dev = torch.device("cuda")
    flags = ["--voc_paths", root, "--network", "vgg16", *SERVE_FLAGS]
    parser = argparse.ArgumentParser()
    cli_common.add_common_args(parser, training=False)
    cfg = cli_common.config_from_args(parser.parse_args(flags))
    path = os.path.join(tmp, "step4.h5")
    t0 = time.perf_counter()
    written = cli_export_h5.main(flags + ["--workdir", work, "--from_step", "4", "--out", path])
    export_s = time.perf_counter() - t0
    loaded_state, loaded, unmatched = load_keras_h5(path, FasterRCNN(cfg).state_dict())
    ck = trainer._load_step_params(work, 4)
    recs, _ = load_dataset([root], "val", flip=False, resize_min=600, resize_max=1500)
    exs = [data_pipeline.prepare_example(r, KITTI_CLASS_MAPPING, cfg, uint8=True) for r in recs]
    images = torch.tensor(np.stack([e["image"] for e in exs]), device=dev)
    hw = torch.tensor(np.stack([e["img_hw"] for e in exs]), device=dev)
    dets = []
    with uncounted():
        for state in (ck, loaded_state):
            model = FasterRCNN(cfg)
            model.load_state_dict(state)
            dets.append(inference.make_detect_fn(cfg, model, dev)(images, hw))
    same = all(torch.equal(a, b) for a, b in zip(dets[0], dets[1]))
    entries_equal = all(torch.equal(loaded_state[k], v) for k, v in ck.items())
    info = {"h5py": True, "layers_written": len(written), "layers_loaded": len(loaded),
            "unmatched": unmatched, "bytes": os.path.getsize(path), "export_s": export_s,
            "state_equal": entries_equal, "detections_equal": same,
            "detections": int(dets[0].valid.sum())}
    os.remove(path)
    if not (same and entries_equal and not unmatched and len(loaded) == len(written)):
        raise RuntimeError(f"h5 round trip of step 4: {info}")
    return info


def phase_cached_train(rates: dict, root: str, tmp: str) -> tuple:
    """Phase 10 (the module docstring) on the dataset at ``root``. ``rates``
    holds, by step, the in-memory and loader-fed img/s of this run. Returns
    (info, {path: kernel cases})."""
    _, total = loader_iterations()
    work = os.path.join(tmp, "cached_work")
    run = CachedRun(os.path.join(tmp, "traces"))
    train = ["--voc_paths", root, "--img_set", "train", "--workdir", work,
             "--clip_grad_norm", "10", "--device_cache", "--chunk_steps", str(CACHED_CHUNK),
             *COMMON_FLAGS]
    log(f"[cached_train] --device_cache, {total} iterations a step in chunks of "
        f"{CACHED_CHUNK}: {CACHED_TIMED} timed from iteration {CACHED_WARMUP * CACHED_CHUNK}, "
        f"then one profiled chunk")
    out = {"iterations": total, "chunk_steps": CACHED_CHUNK}
    run.cli(cli_train.main, train + ["--network", "vgg16", "--step", "all",
                                     "--phases", f"{total}:1e-3"])
    _, text = run.cli(cli_train.main, train + ["--network", "vgg16", "--step", "1",
                                               "--phases", f"{total + 2}:1e-3"])
    ck = checkpoint.restore(os.path.join(work, "step1"))
    if f"[cached step 1] resumed from iteration {total}" not in text or \
            ck["count"] != total + 2 or ck["optimizer"]["count"] != total + 2 or \
            run.info["cached_step1_resumed"]["iterations"] != 2:
        raise RuntimeError(f"cached step 1 did not resume from {total} and go on to "
                           f"{total + 2}: count {ck['count']}, optimizer count "
                           f"{ck['optimizer']['count']}")
    del ck
    out["resume"] = {"from": total, "to": total + 2,
                     "run_s": run.info["cached_step1_resumed"]["run_s"]}
    log(f"[cached_train resume] step 1 resumed from {total} and went on to {total + 2} in "
        f"{out['resume']['run_s']:.2f} s")
    run.cli(cli_train.main, train + ["--network", "resnet50", "--step", "joint",
                                     "--phases", f"{total}:1e-3"])
    for step in ("1", "2", "3", "4", "joint"):
        latest = checkpoint.latest_step(os.path.join(work, f"step{step}"))
        if latest != (total + 2 if step == "1" else total):
            raise RuntimeError(f"cached step {step}: latest checkpoint {latest}")

    frames = _val_frames(root, os.path.join(tmp, "frames"))
    _build.reset_launches()
    run.path = "annotate"
    t0 = time.perf_counter()
    summary, _ = run.cli(cli_annotate.main, [
        "--voc_paths", root, "--input_dir", frames, "--output_dir", os.path.join(tmp, "annotated"),
        "--workdir", work, "--from_step", "4", "--network", "vgg16", *SERVE_FLAGS])
    torch.cuda.synchronize()
    run.info["annotate"] = {"run_s": time.perf_counter() - t0, "iterations": len(summary),
                            "launches": dict(_build.LAUNCHES),
                            "drawn": {os.path.basename(p): n for p, n in summary}}
    if len(summary) != LOADER_VAL:
        raise RuntimeError(f"annotate: {len(summary)} frames of {LOADER_VAL}")
    log(f"[cached_train annotate] boxes drawn per frame (threshold 0.5): "
        f"{run.info['annotate']['drawn']}, {sum(n for _, n in summary)} in all, "
        f"{run.info['annotate']['run_s']:.2f} s")

    _, stats = run.cli(cli_gt_stats.main, ["--voc_paths", root, "--img_set", "train",
                                           *SERVE_FLAGS])
    out["gt_stats"] = stats.strip().splitlines()
    if len(out["gt_stats"]) != 4 or "(no boxes)" in stats:
        raise RuntimeError(f"gt_stats printed {stats!r}")
    out["h5"] = h5_round_trip(root, work, tmp)
    log(f"[cached_train h5] {out['h5']}" if out["h5"]["h5py"] else
        f"[cached_train h5] h5py does not import on this host ({out['h5']['why']}): "
        "cli.export_h5 and load_keras_h5 not run here; the CPU tests hold them")

    out["paths"] = {}
    for path, info in run.info.items():
        if "t1" in info:
            sec = info.pop("t1") - info.pop("t0")
            n = info.pop("window_iterations") - info.pop("start")
            if n != CACHED_TIMED:
                raise RuntimeError(f"{path}: {n} iterations in the window")
            info["cached_img_per_s"] = LOADER_BATCH * n / sec
        step = path.replace("cached_", "")
        info.update({f"{k}_img_per_s": r.get(step) for k, r in rates.items()})
        out["paths"][path] = info
        log(f"[cached_train {path}] {json.dumps(info)}")
        if path in CACHED_PATHS:
            want = expected_launches(path, info["iterations"])
            if info["launches"] != want:
                raise RuntimeError(f"{path}: kernel launches {info['launches']}, "
                                   f"expected {want}")
        if path in CACHED_PATHS and path != "annotate" and (
                "profiled" not in info or info["iterations"] != total):
            raise RuntimeError(f"{path}: {info['iterations']} iterations, "
                               f"profiled: {'profiled' in info}")
        if not all(np.isfinite(v) for v in info.get("final_metrics", {}).values()):
            raise RuntimeError(f"{path}: final metrics {info['final_metrics']}")
    cases = {}
    for path in CACHED_PATHS:
        cases[path] = check_kernels(run.calls.pop(path, {}), path)
    out["traces"] = {d: _dir_bytes(os.path.join(run.trace_dir, d))
                     for d in os.listdir(run.trace_dir)}
    log(f"[cached_train] device_trace files (bytes): {out['traces']}")
    shutil.rmtree(work)
    return out, cases


# --------------------------------------------------------------------------
# phase 11: multi_gpu, one process per card over NCCL
# --------------------------------------------------------------------------


def _mp_init(rank: int, world: int, store_path: str):
    """This process's card and its NCCL process group (a FileStore
    rendezvous: no port); the kernels built by local rank 0 first. Returns
    the (data = world) mesh and the device."""
    os.environ["LOCAL_RANK"] = str(rank)  # one host: its card, and who builds
    torch.cuda.set_device(rank)
    store = torch.distributed.FileStore(store_path, world)
    torch.distributed.init_process_group("nccl", store=store, rank=rank, world_size=world)
    multihost.build_kernels_once()
    return mesh_lib.create_mesh(), torch.device("cuda", rank)


def _mp_timed(fn, n: int, warmup: int) -> tuple:
    """``fn()`` ``warmup`` times uncounted, then ``n`` times counted: (seconds
    between two synchronizes, launches, peak GB, the last result)."""
    with uncounted():
        for _ in range(warmup):
            fn()
    torch.cuda.synchronize()
    multihost.barrier()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn()
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    return sec, dict(_build.LAUNCHES), torch.cuda.max_memory_allocated() / 1e9, out


def _mp_rank(rank: int, world: int, tmp: str) -> None:
    """One rank of phase 11 (main's docstring): its results to
    ``tmp/rank<r>.pt``. Any error fails the spawn, and so the run."""
    mesh, dev = _mp_init(rank, world, os.path.join(tmp, "store"))
    out = {"rank": rank, "device": torch.cuda.get_device_name(dev)}
    # (a) B = MP_CHECK_B a rank's share of a small global batch, f32: the
    # data-parallel joint step against the local one on all of it, and
    # the sharded detect against the single-card detect
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    b = MP_CHECK_B * world
    base = kitti_config()
    cfg = base.replace(model=dataclasses.replace(base.model, compute_dtype="float32"))
    state = _bias_only_rpn(init_model(1, cfg, "cpu").state_dict(), cfg.anchors.num_anchors)
    rng = np.random.RandomState(5)
    batch = kitti_train_batch(rng, b, cfg)
    draws = pipeline.draw_samples(cfg, b, torch.Generator(device=dev).manual_seed(1))
    got = _train_once(cfg, state, dev, batch, draws, plain=False, mesh=mesh)
    want = _train_once(cfg, state, dev, batch, draws, plain=False)
    out["train_check"] = _step_agreement(state, got, want)
    img, hw = kitti_batch(rng, b, cfg)
    with uncounted():
        single = inference.make_detect_fn(cfg, _model(cfg, state, dev), dev)(img, hw)
        sharded = inference.make_detect_fn(cfg, _model(cfg, state, dev), dev, mesh=mesh)(img, hw)
    out["detect_check"] = _agreement(sharded, single)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    del got, want, single, sharded
    torch.cuda.empty_cache()

    # (b) kitti_config(), global B=MP_B: the data-parallel joint step and
    # the sharded detect, launches counted from 0 over the timed run
    cfg = kitti_config()
    rng = np.random.RandomState(0)
    model = init_model(0, cfg, dev)
    opt = make_optimizer(model, cfg.model.network, cfg.model.freeze_blocks, 1e-3, momentum=0.9,
                         clip_grad_norm=10.0, mesh=mesh)
    step = pipeline.make_joint_train_step(cfg, model, opt, device=dev)
    mesh_lib.replicated(mesh, model.state_dict())
    part = {k: torch.as_tensor(v, device=dev)
            for k, v in mesh_lib.shard_batch(mesh, kitti_train_batch(rng, MP_B, cfg)).items()}
    gen = torch.Generator(device=dev).manual_seed(0)

    def train():
        return step(part, multihost.global_draws(cfg, MP_B, gen, mesh))

    # one recorded step on every rank (each step all-reduces); rank 0
    # checks the kernels on its inputs
    cases, calls = {}, {}
    with recording(calls):
        train()
    if rank == 0:
        cases["multi_gpu_joint"] = check_kernels(calls, "multi_gpu_joint")
    del calls
    sec, launches, peak, metrics = _mp_timed(train, MP_STEPS, TRAIN_WARMUP)
    out["multi_gpu_joint"] = {
        "img_per_s": MP_B * MP_STEPS / sec, "step_ms": sec / MP_STEPS * 1e3,
        "local_batch": len(part["image"]), "launches": launches, "max_memory_gb": peak,
        "metrics": {k: float(v) for k, v in metrics.items()}}
    del model, opt, step, part
    torch.cuda.empty_cache()

    model = init_model(0, cfg, dev)
    detect = inference.make_detect_fn(cfg, model, dev, mesh=mesh)
    img, hw = kitti_batch(rng, MP_B, cfg)
    images, img_hw = torch.tensor(img, device=dev), torch.tensor(hw, device=dev)
    calls = {}
    with recording(calls):
        detect(images, img_hw)
    if rank == 0:
        with torch.inference_mode():
            cases["multi_gpu_detect"] = check_kernels(calls, "multi_gpu_detect")
    del calls
    sec, launches, peak, dets = _mp_timed(lambda: detect(images, img_hw), BATCHES, 1)
    check_dets(dets, MP_B, cfg.rpn.infer_post_nms, cfg.model.num_classes)
    out["multi_gpu_detect"] = {
        "img_per_s": MP_B * BATCHES / sec, "batch_ms": sec / BATCHES * 1e3,
        "local_batch": MP_B // world, "launches": launches, "max_memory_gb": peak,
        "valid_per_image": dets.valid.sum(1).tolist()}
    out["cases"] = cases
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    multihost.barrier()
    torch.distributed.destroy_process_group()


def phase_multi_gpu(local_rates: dict) -> tuple:
    """Phase 11 (main's docstring) on up to MP_MAX_RANKS cards, beside the
    single-card rates of phases 4 and 5 (``local_rates``). Returns (info,
    {path: kernel cases of rank 0})."""
    world = min(MP_MAX_RANKS, torch.cuda.device_count())
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        torch.multiprocessing.start_processes(_mp_rank, args=(world, tmp), nprocs=world,
                                              join=True, start_method="spawn")
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                 for r in range(world)]
    info = {"world": world, "seconds": time.perf_counter() - t0, "global_batch": MP_B,
            "local_rates": local_rates}
    cases = ranks[0].pop("cases")
    for r in ranks:
        r.pop("cases", None)
    info["ranks"] = ranks
    bad = []
    for r in ranks:
        tc, dc = r["train_check"], r["detect_check"]
        if not tc["ok"]:
            bad.append(f"rank {r['rank']}: the data-parallel joint step against the local one")
        if not (dc["valid_a"] == dc["valid_b"] and dc["close_frac"] == 1.0):
            bad.append(f"rank {r['rank']}: the sharded detect against the single-card one")
        for path, n in (("multi_gpu_joint", MP_STEPS), ("multi_gpu_detect", BATCHES)):
            want = expected_launches(path, n)
            if r[path]["launches"] != want:
                bad.append(f"rank {r['rank']} {path}: launches {r[path]['launches']}, "
                           f"expected {want}")
        if not all(np.isfinite(v) for v in r["multi_gpu_joint"]["metrics"].values()):
            bad.append(f"rank {r['rank']}: metrics {r['multi_gpu_joint']['metrics']}")
    for path, key in (("multi_gpu_joint", "train"), ("multi_gpu_detect", "detect")):
        rate = min(r[path]["img_per_s"] for r in ranks)
        info[path] = {"img_per_s": rate, "local_img_per_s": local_rates[key],
                      "ratio_to_one_card": rate / local_rates[key],
                      "launches": ranks[0][path]["launches"],
                      "launches_per_rank": [r[path]["launches"] for r in ranks],
                      "max_memory_gb_per_rank": [r[path]["max_memory_gb"] for r in ranks]}
        log(f"[multi_gpu {path}] {world} rank(s), global B={MP_B}: {json.dumps(info[path])}")
    log(f"[multi_gpu checks] " + json.dumps(
        [{"rank": r["rank"], "train": {k: r["train_check"][k] for k in
                                        ("ok", "loss_rel_err", "worst_param_ratio")},
          "detect": r["detect_check"]} for r in ranks]))
    log(f"[multi_gpu] phase took {info['seconds']:.1f} s")
    if bad:
        raise RuntimeError(f"multi_gpu: {bad}")
    return info, cases


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = phase_card()
    phase_build()

    rng = np.random.RandomState(0)
    cases, launches = {}, {}
    run = KittiDetect(rng, dev)
    calls, first = run.capture()
    with torch.inference_mode():
        cases["detect"] = check_kernels(calls, "detect")
        adversarial = check_topk_adversarial(dev)
        epilogue = check_frozen_epilogue_cases(dev)
    del calls
    det = phase_detect(run, first)
    det["breakdown_ms"] = phase_breakdown(run)
    del run
    torch.cuda.empty_cache()

    train = KittiTrain(rng, dev)
    calls, first = train.capture()
    cases["train"] = check_kernels(calls, "train")
    del calls
    tr = phase_train(train, first)
    nms_later = check_nms_later_step(train)
    del train
    torch.cuda.empty_cache()

    whole = phase_whole_path(rng, dev)
    whole.update(phase_whole_train(rng, dev))

    # this slice's paths, each with a generator of its own
    detects, detect_cases = phase_other_detect(np.random.RandomState(1), dev)
    cases.update(detect_cases)
    four, four_cases = phase_four_step(FourStep(np.random.RandomState(2), dev))
    cases.update(four_cases)
    whole.update(phase_whole_four_step(np.random.RandomState(3), dev))
    torch.cuda.empty_cache()

    in_memory = dict({p: info["img_per_s"] for p, info in four.items()}, train=tr["img_per_s"])
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "kitti")
        dataset = make_dataset(root)
        loader, loader_cases = phase_loader_train(in_memory, root, tmp)
        cases.update(loader_cases)
        loader["dataset"] = dataset
        loader_fed = {p.replace("loader_", ""): info.get("sustained_img_per_s")
                      for p, info in loader["paths"].items()}
        rates = {"in_memory": {k.replace("train", "joint"): v for k, v in in_memory.items()},
                 "loader_fed": loader_fed}
        cached, cached_cases = phase_cached_train(rates, root, tmp)
        cases.update(cached_cases)
    multi, multi_cases = phase_multi_gpu({"train": tr["img_per_s"], "detect": det["img_per_s"]})
    cases.update(multi_cases)

    units = {"detect": (det, BATCHES), "train": (tr, TRAIN_STEPS)}
    units.update({p: (info, BATCHES) for p, info in detects.items()})
    units.update({p: (info, FOUR_STEP_TIMED) for p, info in four.items()})
    # this slice's paths: the launches of the whole run
    units.update({p: (loader["paths"][p], 1) for p in LOADER_PATHS})
    units.update({p: (cached["paths"][p], 1) for p in CACHED_PATHS})
    units.update({p: (multi[p], 1) for p in MP_PATHS})  # rank 0's timed run
    launches = {p: {k: v // n for k, v in info["launches"].items()}
                for p, (info, n) in units.items()}
    log(f"[launches] per call or step {launches}")
    kernels = kernel_entries(cases, launches, adversarial, nms_later)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "kernels": kernels,
                   "cases": dict(cases, topk_adversarial=adversarial, nms_later_step=nms_later,
                                 frozen_epilogue=epilogue),
                   "detect": det, "train": tr, "other_detect": detects, "four_step": four,
                   "whole_path": whole, "loader_train": loader, "cached_train": cached,
                   "multi_gpu": multi},
                  f, indent=1)
    log(card["smi"])
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card["kind"],
                                             "count": card["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
