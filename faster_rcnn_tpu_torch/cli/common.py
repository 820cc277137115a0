"""Shared argparse plumbing for the CLIs.

Counterpart of faster_rcnn_tpu/cli/common.py: the same flags, mapped onto
the same config, without the JAX-only compile cache, and with ``--device``
(``cuda`` by default; ``cpu`` runs the kernels' plain versions), the
explicit device every entry point of the port takes. ``--multihost``
trains one process per card under ``torchrun`` (parallel/multihost.py).
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Tuple

from faster_rcnn_tpu_torch.config import FasterRcnnConfig, voc_config
from faster_rcnn_tpu_torch.data.voc import KITTI_CLASS_MAPPING, VOC_CLASS_MAPPING
from faster_rcnn_tpu_torch.train.schedule import phases_from_str


def resize_dims_from_str(s: str) -> Tuple[int, int]:
    """"600,1000" -> (600, 1000) (args_util.py:62-68)."""
    mn, mx = s.split(",")
    return int(mn), int(mx)


def anchor_scales_from_str(s: str) -> Tuple[int, ...]:
    """"16,32,64,128,256,512" -> tuple (args_util.py:71-77)."""
    return tuple(int(x) for x in s.split(","))


def add_common_args(p: argparse.ArgumentParser, training: bool = True) -> None:
    p.add_argument("--voc_paths", required=True,
                   help="comma-separated dataset base paths (VOC layout)")
    p.add_argument("--img_set", default="trainval")
    p.add_argument("--network", default="resnet50",
                   choices=("vgg16", "resnet50", "resnet101"))
    p.add_argument("--resize_dims", default="600,1000",
                   help="min_size,max_size resize policy")
    p.add_argument("--anchor_scales", default="16,32,64,128,256,512")
    p.add_argument("--kitti", action="store_true",
                   help="use KITTI class mapping (9+bg)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda (the kernels) or cpu (their plain versions)")
    if training:
        p.add_argument("--phases", default="60000:1e-3,20000:1e-4",
                       help="iterations:lr[,iterations:lr...]")
        p.add_argument("--optimizer", default="sgd", choices=("sgd", "adam"))
        p.add_argument("--batch_size", type=int, default=1)
        p.add_argument("--save_frequency", type=int, default=2000)
        p.add_argument("--workdir", default="./workdir")
        p.add_argument("--seed", type=int, default=0)
        p.add_argument("--clip_grad_norm", type=float, default=0.0,
                       help="global-norm gradient clip (0=off; ~10 for joint)")
        p.add_argument("--freeze_blocks", default=None,
                       help="comma list of backbone blocks to freeze "
                            "(default: per-network preset; 'none' to train all)")
        p.add_argument("--flip", action="store_true", default=True)
        p.add_argument("--no-flip", dest="flip", action="store_false")
        p.add_argument("--multihost", action="store_true",
                       help="multi-process training: global mesh over all "
                            "hosts' devices, per-host dataset shards "
                            "(parallel/multihost.py); batch_size is global")
        p.add_argument("--uint8_pipeline", action="store_true", default=True,
                       help="ship raw uint8 RGB canvases to the device and "
                            "preprocess there (4x less H2D; default)")
        p.add_argument("--no-uint8_pipeline", dest="uint8_pipeline",
                       action="store_false",
                       help="ship host-preprocessed float32 canvases instead")


def _round_up(x: int, m: int = 32) -> int:
    return ((x + m - 1) // m) * m


def config_from_args(args) -> FasterRcnnConfig:
    cfg = voc_config(args.network)
    fb = getattr(args, "freeze_blocks", None)
    if fb is not None:
        blocks = () if fb == "none" else tuple(int(b) for b in fb.split(","))
        cfg = cfg.replace(model=dataclasses.replace(cfg.model, freeze_blocks=blocks))
    mn, mx = resize_dims_from_str(args.resize_dims)
    num_classes = len(KITTI_CLASS_MAPPING) if args.kitti else len(VOC_CLASS_MAPPING)
    cfg = cfg.replace(
        anchors=dataclasses.replace(cfg.anchors, scales=anchor_scales_from_str(args.anchor_scales)),
        data=dataclasses.replace(
            cfg.data,
            resize_min=mn,
            resize_max=mx,
            canvas_h=_round_up(mn),
            canvas_w=_round_up(mx),
        ),
        model=dataclasses.replace(cfg.model, num_classes=num_classes),
    )
    if hasattr(args, "phases"):
        cfg = cfg.replace(
            train=dataclasses.replace(
                cfg.train,
                phases=tuple(tuple(p) for p in phases_from_str(args.phases)),
                optimizer=args.optimizer,
                batch_size=args.batch_size,
                save_frequency=args.save_frequency,
                seed=args.seed,
                clip_grad_norm=args.clip_grad_norm,
            )
        )
    return cfg


def class_mapping_from_args(args):
    return KITTI_CLASS_MAPPING if args.kitti else VOC_CLASS_MAPPING
