"""Central configuration for the TPU-native Faster R-CNN framework.

The reference implementation (Kelicious/faster_rcnn) scatters its hyperparameters
across ``shared_constants.py``, per-module constants (rpn_util.py:10-15,
det_util.py:7-10) and inline magic numbers (det_util.py:71-77, 136-158).  Here every
knob lives in one immutable, hashable dataclass tree so it can be closed over by
jitted programs and threaded through ``jax.tree_util`` without retracing surprises.

Design note: all pipeline sizes (pre/post-NMS proposal counts, sample sizes, max
ground-truth boxes, canvas dims) are *static* — on TPU every shape must be known at
compile time, so the reference's dynamic truncations (e.g. ``sorted_idxs[0:12000]``
at det_util.py:73) become fixed pad-and-mask dimensions here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np


def compute_anchor_dims(
    scales: Tuple[int, ...], ratios: Tuple[Tuple[int, int], ...]
) -> np.ndarray:
    """Derive integer (height, width) anchor dims from scales and aspect ratios.

    Reproduces the area-preserving derivation of shared_constants.py:9-11 /
    util.py:242-253 exactly, including the float floor-division ``//`` and the
    truncating ``astype(int)``: for each (scale s, ratio (h, w)) the naive anchor
    ``[s*h, s*w]`` is shrunk by ``sqrt(s*h*s*w)/s`` so its area is ~s^2.
    """
    naive = np.array([[s * h, s * w] for s in scales for h, w in ratios])
    r = np.array([math.sqrt(s * h * s * w) / s for s in scales for h, w in ratios])
    return (naive // r[:, None]).astype(int)


@dataclasses.dataclass(frozen=True)
class AnchorConfig:
    """Anchor generation parameters (shared_constants.py:7-11)."""

    scales: Tuple[int, ...] = (16, 32, 64, 128, 256, 512)
    ratios: Tuple[Tuple[int, int], ...] = ((1, 1), (1, 2), (2, 1))

    @property
    def dims(self) -> np.ndarray:
        """Integer (A, 2) array of anchor (height, width) pairs."""
        return compute_anchor_dims(self.scales, self.ratios)

    @property
    def num_anchors(self) -> int:
        return len(self.scales) * len(self.ratios)


@dataclasses.dataclass(frozen=True)
class RpnConfig:
    """RPN target assignment + sampling (rpn_util.py:10-15) and proposal
    generation (det_util.py:71-77, 153-156)."""

    pos_iou: float = 0.7           # rpn_util.py:10 POS_OVERLAP
    neg_iou: float = 0.3           # rpn_util.py:11 NEG_OVERLAP
    sample_size: int = 256         # rpn_util.py:14 SAMPLE_SIZE
    max_pos_samples: int = 128     # rpn_util.py:15 MAX_POS_SAMPLES
    # Proposal pipeline (fixed shapes; reference values det_util.py:73,77,153,156)
    # train_pre_nms deviates from the reference's 12000: 6000 (the Detectron
    # default) is mAP-neutral on the real-annotation proxy (0.5951 vs 0.5960
    # on 2,510 real-GT val images, NOTES.md r3) and saves ~12 ms/step at B=16
    # (chained stage breakdown: proposals 26.2 -> 14.3 ms).
    train_pre_nms: int = 6000
    train_post_nms: int = 2000
    infer_pre_nms: int = 8000
    infer_post_nms: int = 300
    nms_iou: float = 0.7
    # blocked-NMS tile: larger = fewer serial phases but more work per phase.
    # Exact-greedy for any tile; 512 measured fastest on v5e (6000->2000:
    # 9.1/6.1/4.9/5.5 ms at tile 128/256/512/1024, B=16 — NOTES.md r3).
    nms_tile: int = 512

    # Loss normalizers (loss_functions.py:8-11)
    n_cls: float = 256.0
    n_reg: float = 2400.0
    lambda_reg: float = 10.0


@dataclasses.dataclass(frozen=True)
class DetConfig:
    """Detector (Fast R-CNN head) target assignment + sampling
    (det_util.py:7-10, 260-306) and inference decode (voc_dets.py:20-88)."""

    min_iou: float = 0.1           # det_util.py:7 CLASSIFIER_MIN_OVERLAP
    pos_iou: float = 0.5           # det_util.py:8 CLASSIFIER_POS_OVERLAP
    num_rois: int = 64             # shared_constants.py:18 NUM_ROIS
    pos_fraction: float = 0.25     # det_util.py:266 desired_pos = num//4
    pool_size: int = 7             # vgg.py:18 / resnet.py:22 POOLING_REGIONS
    # Final per-class NMS at inference (voc_dets.py:76).  The reference also
    # caps detections at 2000/class (voc_dets.py:76) — with <=300 ROIs total
    # that cap can never bind, so it is intentionally not a knob here.
    final_nms_iou: float = 0.5
    det_threshold: float = 0.0     # voc_dets.py:17 DEFAULT_DET_THRESHOLD
    # RoI-align implementation: 'pallas' (fused MXU kernel, VMEM-resident
    # feature map — 1.13 ms/300 ROIs on v5e vs einsum 1.88 / gather 2.62,
    # NOTES.md round 2), 'einsum' (separable-bilinear matmuls), or 'gather'
    # (4-tap HBM gathers).  Off-TPU, 'pallas' automatically routes to the
    # einsum path (identical numerics via the shared _tap_weights), so the
    # default is safe on every backend; 'pallas_interpret' forces the Pallas
    # interpreter for kernel-exactness tests.
    roi_align_impl: str = "pallas"


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Input pipeline: resize policy (shared_constants.py:16-17,
    shapes.py:106-123) and fixed-canvas padding (TPU-native addition)."""

    resize_min: int = 600          # RESIZE_MIN_SIZE
    resize_max: int = 1000         # RESIZE_MAX_SIZE
    # Static canvas the resized image is padded into. Must satisfy
    # canvas_h >= resize_min, canvas_w >= resize_max for the standard policy.
    canvas_h: int = 608
    canvas_w: int = 1024
    max_gt_boxes: int = 64         # VOC2007 max objects/image is 42
    flip_augment: bool = True      # args_util.py:24-26 horizontal-flip doubling

    @property
    def canvas(self) -> Tuple[int, int]:
        return (self.canvas_h, self.canvas_w)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Backbone + head selection (vgg.py / resnet.py factory functions)."""

    network: str = "resnet50"      # one of: vgg16, resnet50, resnet101
    num_classes: int = 21          # includes background (VOC 20+bg)
    # Backbone feature stride at the RPN conv layer (vgg.py:21, resnet.py:24)
    stride: int = 16
    pooling_regions: int = 7
    # l2 regularization (vgg.py:22-25: None for vgg; resnet.py:26-27: 1e-4)
    weight_decay: float = 0.0
    # Blocks whose parameters are frozen, by 1-based block/stage index
    # (vgg16_base freeze_blocks=[1,2] vgg.py:91; resnet50_base [1,2,3]
    # resnet.py:395; step-3 freezes the whole base train_rpn_step3.py:60-81).
    freeze_blocks: Tuple[int, ...] = (1, 2, 3)
    # Compute dtype for conv/matmul heavy layers; params and box math stay fp32.
    compute_dtype: str = "bfloat16"
    # ResNet stem-conv lowering (ops/conv1_pallas.py; ignored by VGG16).
    # 'pallas_v2' (default, production): selection-einsum phase split + one
    # K=192 MXU dot per output row — measured 4.02 ms at B=16 608x1024 bf16
    # on v5e vs 'xla' 5.82 ms (the nn.Conv lowering, ~1% MXU util at C=3)
    # and 'pallas' (v1) 11.8 ms.  Numerics: 2.5e-3 max-rel vs XLA in bf16
    # (same accumulation contract); automatic XLA fallback off-TPU, so CPU
    # goldens are bit-identical.  '*_interpret' for kernel-exactness tests.
    conv1_impl: str = "pallas_v2"

    @property
    def final_conv_filters(self) -> int:
        return {"vgg16": 512, "resnet50": 1024, "resnet101": 1024}[self.network]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training schedule (README.md:53-62; args_util.py:30-59)."""

    phases: Tuple[Tuple[int, float], ...] = ((60000, 1e-3), (20000, 1e-4))
    optimizer: str = "sgd"         # sgd (momentum 0.9) or adam, args_util.py:48-59
    momentum: float = 0.9
    batch_size: int = 1            # global batch; reference hardcodes 1
    save_frequency: int = 2000     # train_util.py:58
    seed: int = 0
    # global-norm gradient clipping (0 = off, reference behavior); recommended
    # ~10.0 for joint / from-scratch training
    clip_grad_norm: float = 0.0


@dataclasses.dataclass(frozen=True)
class FasterRcnnConfig:
    """Top-level config bundle."""

    anchors: AnchorConfig = dataclasses.field(default_factory=AnchorConfig)
    rpn: RpnConfig = dataclasses.field(default_factory=RpnConfig)
    det: DetConfig = dataclasses.field(default_factory=DetConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)

    def replace(self, **kw) -> "FasterRcnnConfig":
        return dataclasses.replace(self, **kw)

    @property
    def conv_h(self) -> int:
        return self.data.canvas_h // self.model.stride

    @property
    def conv_w(self) -> int:
        return self.data.canvas_w // self.model.stride


def kitti_config() -> FasterRcnnConfig:
    """Preset matching the reference's KITTI runs: 600x1500 resize
    (README commands / BASELINE.md), 10-class mapping, anchors 16..512."""
    cfg = FasterRcnnConfig()
    return cfg.replace(
        data=dataclasses.replace(cfg.data, resize_max=1500, canvas_w=1504),
        model=dataclasses.replace(cfg.model, num_classes=10),
    )


def voc_config(network: str = "resnet50") -> FasterRcnnConfig:
    cfg = FasterRcnnConfig()
    wd = {"vgg16": 0.0, "resnet50": 1e-4, "resnet101": 1e-4}[network]
    freeze = {"vgg16": (1, 2), "resnet50": (1, 2, 3), "resnet101": (1, 2, 3)}[network]
    return cfg.replace(
        model=dataclasses.replace(
            cfg.model, network=network, weight_decay=wd, freeze_blocks=freeze
        )
    )
