"""mAP evaluation CLI (eval_dets.py rebuild).

    python -m faster_rcnn_tpu_torch.cli.evaluate --voc_path /data/VOC2007test \\
        --dets_path ./dets --img_set test

A copy of faster_rcnn_tpu/cli/evaluate.py over the port's evaluator; it
runs on the host (numpy) and returns the APs and the mAP.
"""

from __future__ import annotations

import argparse

from faster_rcnn_tpu_torch.data.voc import KITTI_CLASS_MAPPING, VOC_CLASS_MAPPING
from faster_rcnn_tpu_torch.evaluate import eval_all


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--voc_path", required=True)
    p.add_argument("--dets_path", default="./dets")
    p.add_argument("--kitti", action="store_true")
    p.add_argument("--img_set", default="val", choices=("val", "test", "trainval", "train"))
    args = p.parse_args(argv)

    mapping = KITTI_CLASS_MAPPING if args.kitti else VOC_CLASS_MAPPING
    return eval_all(args.dets_path, args.voc_path, mapping, img_set=args.img_set)


if __name__ == "__main__":
    main()
