"""Annotate video frames / images with detections (annotate_video.py rebuild).

    python -m faster_rcnn_tpu_torch.cli.annotate --input_dir frames/ \\
        --output_dir out/ --workdir ./workdir --kitti

Counterpart of faster_rcnn_tpu/cli/annotate.py: every PNG and JPEG in
``--input_dir`` goes through the detect program (uint8 canvases,
``inference.make_detect_fn``) with the weights of a training step's latest
checkpoint, and is saved with its boxes drawn by PIL. Like the reference
(annotate_video.py:27-44) it skips 'DontCare'/'Misc' and boxes that cross
the image's border. Runs on the GPU (``--device cpu``: the plain versions
on the CPU).
"""

from __future__ import annotations

import argparse
import glob
import os

from PIL import Image as PilImage
from PIL import ImageDraw

from faster_rcnn_tpu_torch import resolve_device
from faster_rcnn_tpu_torch.cli.common import (add_common_args, class_mapping_from_args,
                                              config_from_args)
from faster_rcnn_tpu_torch.data.pipeline import prepare_example
from faster_rcnn_tpu_torch.data.voc import ImageRecord
from faster_rcnn_tpu_torch.inference import detections_to_records, make_detect_fn
from faster_rcnn_tpu_torch.models.detector import FasterRCNN
from faster_rcnn_tpu_torch.train.trainer import _load_step_params

SKIP_CLASSES = {"DontCare", "Misc"}  # annotate_video.py:27
_COLORS = [
    (230, 25, 75), (60, 180, 75), (255, 225, 25), (0, 130, 200), (245, 130, 48),
    (145, 30, 180), (70, 240, 240), (240, 50, 230), (210, 245, 60), (250, 190, 190),
]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    add_common_args(p, training=False)
    p.add_argument("--input_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--workdir", default="./workdir")
    p.add_argument("--from_step", default="4")
    p.add_argument("--det_threshold", type=float, default=0.5)
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    cfg = config_from_args(args)
    class_mapping = class_mapping_from_args(args)
    rev = {v: k for k, v in class_mapping.items()}
    class_names = [rev[i] for i in range(len(rev))]

    model = FasterRCNN(cfg)
    model.load_state_dict(_load_step_params(args.workdir, args.from_step))
    # uint8 serving: raw RGB canvases in, preprocessed on the device
    detect = make_detect_fn(cfg, model, device)

    os.makedirs(args.output_dir, exist_ok=True)
    frames = sorted(
        glob.glob(os.path.join(args.input_dir, "*.png"))
        + glob.glob(os.path.join(args.input_dir, "*.jpg"))
    )
    summary = []  # (frame path, boxes actually drawn)
    for path in frames:
        with PilImage.open(path) as im:
            im = im.convert("RGB")
            w, h = im.width, im.height
            rec = ImageRecord(os.path.basename(path), w, h, [], path)
            rec, ratio = rec.resize_within_bounds(cfg.data.resize_min, cfg.data.resize_max)
            ex = prepare_example(rec, class_mapping, cfg, uint8=True)
            dets = detect(ex["image"][None], ex["img_hw"][None])
            recs = detections_to_records(dets, [ratio], class_names)[0]

            draw = ImageDraw.Draw(im)
            n_drawn = 0
            for det in recs:
                if det["prob"] < args.det_threshold or det["cls_name"] in SKIP_CLASSES:
                    continue
                x1, y1, x2, y2 = det["bbox"]
                # skip boundary-crossing boxes (annotate_video.py:35-38)
                if x1 < 0 or y1 < 0 or x2 >= w or y2 >= h:
                    continue
                color = _COLORS[class_mapping[det["cls_name"]] % len(_COLORS)]
                draw.rectangle([x1, y1, x2, y2], outline=color, width=2)
                draw.text((x1 + 2, y1 + 2), f"{det['cls_name']} {det['prob']:.2f}", fill=color)
                n_drawn += 1
            im.save(os.path.join(args.output_dir, os.path.basename(path)))
            print(f"annotated {path}: {n_drawn}/{len(recs)} detections drawn")
            summary.append((path, n_drawn))
    return summary


if __name__ == "__main__":
    main()
