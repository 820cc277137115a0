"""Batch inference -> VOC comp3 detection files (voc_dets.py rebuild).

    python -m faster_rcnn_tpu_torch.cli.detect --voc_paths /data/VOC2007test \\
        --img_set test --workdir ./workdir --out_dir ./dets

Counterpart of faster_rcnn_tpu/cli/detect.py: the detect program
(``inference.make_detect_fn``, one per canvas) over the imageset in
batches, the last batch padded with its last example, with the weights of
a training step's latest checkpoint; writes ``comp3_det_test_{cls}.txt``
files for the evaluator. Runs on the GPU (``--device cpu``: the plain
versions on the CPU).
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from faster_rcnn_tpu_torch import resolve_device
from faster_rcnn_tpu_torch.cli.common import (add_common_args, class_mapping_from_args,
                                              config_from_args)
from faster_rcnn_tpu_torch.data.pipeline import canvas_for, prepare_example
from faster_rcnn_tpu_torch.data.voc import load_dataset
from faster_rcnn_tpu_torch.inference import detections_to_records, make_detect_fn, write_dets
from faster_rcnn_tpu_torch.models.detector import FasterRCNN
from faster_rcnn_tpu_torch.train.trainer import _load_step_params


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    add_common_args(p, training=False)
    p.add_argument("--workdir", default="./workdir",
                   help="training workdir with step3/step4 checkpoints")
    p.add_argument("--from_step", default="4",
                   help="checkpoint step to load the detector head from")
    p.add_argument("--out_dir", default="./dets")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--det_threshold", type=float, default=0.0)
    p.add_argument("--uint8_pipeline", action="store_true", default=True,
                   help="ship raw uint8 RGB canvases; preprocess on device "
                        "(4x less H2D — the production serving config; default)")
    p.add_argument("--no-uint8_pipeline", dest="uint8_pipeline", action="store_false")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    cfg = config_from_args(args)
    class_mapping = class_mapping_from_args(args)
    rev = {v: k for k, v in class_mapping.items()}
    class_names = [rev[i] for i in range(len(rev))]

    model = FasterRCNN(cfg)
    model.load_state_dict(_load_step_params(args.workdir, args.from_step))

    records, ratios = load_dataset(
        args.voc_paths.split(","), args.img_set, flip=False,
        resize_min=cfg.data.resize_min, resize_max=cfg.data.resize_max,
    )
    print(f"{len(records)} images to process")

    detect_fns = {}

    def detect_for(canvas):
        if canvas not in detect_fns:
            cfg_c = cfg.replace(
                data=dataclasses.replace(cfg.data, canvas_h=canvas[0], canvas_w=canvas[1])
            )
            detect_fns[canvas] = make_detect_fn(cfg_c, model, device)
        return detect_fns[canvas]

    # bucket by canvas, batch, run
    dets_by_cls = {}
    buckets = {}
    for rec, ratio in zip(records, ratios):
        buckets.setdefault(canvas_for(rec, cfg), []).append((rec, ratio))

    t0 = time.time()
    n_done = 0
    for canvas, items in buckets.items():
        fn = detect_for(canvas)
        b = args.batch_size
        for i in range(0, len(items), b):
            chunk = items[i : i + b]
            pad = b - len(chunk)
            exs = [prepare_example(r, class_mapping, cfg, canvas,
                                   uint8=args.uint8_pipeline) for r, _ in chunk]
            exs += [exs[-1]] * pad
            images = np.stack([e["image"] for e in exs])
            hw = np.stack([e["img_hw"] for e in exs])
            dets = fn(images, hw)
            recs = detections_to_records(
                dets, [ratio for _, ratio in chunk] + [1.0] * pad, class_names
            )
            for (rec, _), img_dets in zip(chunk, recs):
                for det in img_dets:
                    if det["prob"] < args.det_threshold:
                        continue
                    dets_by_cls.setdefault(det["cls_name"], {}).setdefault(
                        rec.name, []
                    ).append(det)
            n_done += len(chunk)
            if n_done % 100 < b:
                rate = n_done / (time.time() - t0)
                print(f"{n_done}/{len(records)} images ({rate:.2f} img/s)")

    write_dets(dets_by_cls, args.out_dir)
    print(f"wrote detections for {len(dets_by_cls)} classes to {args.out_dir}")
    print(f"total: {len(records)} images in {time.time()-t0:.1f}s")


if __name__ == "__main__":
    main()
