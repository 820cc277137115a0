"""Ground-truth object statistics (gt_object_stats.py rebuild).

A copy of faster_rcnn_tpu/cli/gt_stats.py over the port's modules; it runs
on the host only.

Prints descriptive stats of GT box heights/widths/areas after resize —
used to choose anchor scales for a dataset (e.g. KITTI 16..512).

    python -m faster_rcnn_tpu_torch.cli.gt_stats --voc_paths /data/KITTI --img_set train
"""

from __future__ import annotations

import argparse

import numpy as np

from faster_rcnn_tpu_torch.cli.common import add_common_args
from faster_rcnn_tpu_torch.data.voc import load_dataset


def describe(name: str, values: np.ndarray) -> None:
    if len(values) == 0:
        print(f"{name}: (no boxes)")
        return
    qs = np.percentile(values, [0, 25, 50, 75, 100])
    print(
        f"{name}: count={len(values)} mean={values.mean():.1f} std={values.std():.1f} "
        f"min={qs[0]:.1f} p25={qs[1]:.1f} p50={qs[2]:.1f} p75={qs[3]:.1f} max={qs[4]:.1f}"
    )


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    add_common_args(p, training=False)
    p.add_argument("--obj_class", default=None, help="restrict to one class")
    args = p.parse_args(argv)

    mn, mx = (int(x) for x in args.resize_dims.split(","))
    records, _ = load_dataset(
        args.voc_paths.split(","), args.img_set, flip=False, resize_min=mn, resize_max=mx
    )
    heights, widths, areas = [], [], []
    for rec in records:
        for b in rec.gt_boxes:
            if args.obj_class and b.obj_cls != args.obj_class:
                continue
            h = b.y2 - b.y1
            w = b.x2 - b.x1
            heights.append(h)
            widths.append(w)
            areas.append(h * w)

    describe("height", np.asarray(heights))
    describe("width", np.asarray(widths))
    describe("area", np.asarray(areas))
    if areas:
        print("sqrt(area) percentiles (anchor-scale guide):",
              [round(float(x), 1) for x in np.percentile(np.sqrt(areas), [5, 25, 50, 75, 95])])


if __name__ == "__main__":
    main()
