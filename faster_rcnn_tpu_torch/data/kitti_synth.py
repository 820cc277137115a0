"""Synthetic KITTI-statistics dataset for training-quality evidence at the

A copy of faster_rcnn_tpu/data/kitti_synth.py, which the port may not import.
headline KITTI geometry (reference notes:290: ResNet-50, resize 600,1500,
anchor scales 16..512, mAP 0.7136).

No KITTI data ships in this environment (the reference mount carries only
VOC_test), so — unlike the VOC proxy, which reuses 5,011 REAL annotation
XMLs — this module *synthesizes* annotations whose marginals match the
published KITTI object-detection label statistics, then renders pixels with
the same per-class texture model as the VOC proxy
(data/synth_render.render_image):

* canvas 1242x375 (the KITTI camera crop) -> resize_within_bounds(600,1500)
  lands on the 1500x453 geometry / 94-col conv grid the reference trains at;
* 9 classes with the empirical frequency skew (car ~55% of labels, DontCare
  ~22%, person ~9%, down to Person_sitting ~0.4%) — exercising extreme class
  imbalance in the det head;
* per-class size/aspect models spanning the anchor range: distant DontCare
  regions (~15 px) up to close trucks/trams (several hundred px wide), so
  anchor scales 16 AND 512 both receive positive matches;
* a ground-plane prior: box bottom edges concentrate in the lower half of
  the image and apparent size shrinks with elevation, like real road scenes.

Output is VOC-layout (Annotations/*.xml 1-based coords, JPEGImages,
ImageSets/Main) so the whole production stack — loader, KITTI class map,
trainer, detector, evaluator — runs unchanged with --kitti.

Determinism matches synth_render: every image depends only on (name, seed).
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

from faster_rcnn_tpu_torch.data.synth_render import _rng_for, render_image

# (class, relative label frequency) — KITTI object-benchmark label counts
# (Car 28742, DontCare 11295, Pedestrian 4487, Van 2914, Cyclist 1627,
# Truck 1094, Misc 973, Tram 511, Person_sitting 222), mapped through the
# reference's class renames (Car->car, Pedestrian->person,
# voc_data_helpers.py KITTI mapping).
CLASS_FREQ: Sequence[Tuple[str, float]] = (
    ("car", 28742.0),
    ("DontCare", 11295.0),
    ("person", 4487.0),
    ("Van", 2914.0),
    ("Cyclist", 1627.0),
    ("Truck", 1094.0),
    ("Misc", 973.0),
    ("Tram", 511.0),
    ("Person_sitting", 222.0),
)

# Per-class (height range px, aspect w/h range) at the 1242x375 canvas.
# Heights span the anchor ladder: 15 px DontCare .. 300 px trams.
SIZE_MODEL: Dict[str, Tuple[Tuple[float, float], Tuple[float, float]]] = {
    "car": ((22.0, 180.0), (1.4, 2.8)),
    "DontCare": ((12.0, 60.0), (0.8, 3.0)),
    "person": ((35.0, 220.0), (0.28, 0.55)),
    "Van": ((30.0, 220.0), (1.1, 2.2)),
    "Cyclist": ((35.0, 200.0), (0.45, 0.95)),
    "Truck": ((45.0, 300.0), (1.2, 3.2)),
    "Misc": ((20.0, 150.0), (0.5, 2.5)),
    "Tram": ((50.0, 320.0), (1.5, 5.0)),
    "Person_sitting": ((30.0, 120.0), (0.45, 0.9)),
}

WIDTH, HEIGHT = 1242, 375
HORIZON = 150.0  # px from top: boxes' bottom edges sit below this


def _sample_objects(rng: np.random.RandomState) -> List[Tuple[str, Tuple[int, int, int, int]]]:
    """One scene: class-frequency-weighted objects on a ground-plane prior."""
    names = [c for c, _ in CLASS_FREQ]
    freqs = np.array([f for _, f in CLASS_FREQ])
    probs = freqs / freqs.sum()
    n = int(np.clip(rng.poisson(5.3), 1, 18))  # KITTI mean ~5.3 labels/img
    out = []
    for _ in range(n):
        cls = names[rng.choice(len(names), p=probs)]
        (h_lo, h_hi), (a_lo, a_hi) = SIZE_MODEL[cls]
        # log-uniform heights: the distant tail dominates real road scenes
        h = float(np.exp(rng.uniform(np.log(h_lo), np.log(h_hi))))
        w = h * rng.uniform(a_lo, a_hi)
        h, w = min(h, HEIGHT - 2.0), min(w, WIDTH - 2.0)
        # ground plane: bottom edge y2 below the horizon, larger boxes lower
        frac = (h - h_lo) / max(h_hi - h_lo, 1.0)
        y2_lo = HORIZON + frac * 0.5 * (HEIGHT - HORIZON)
        y2 = rng.uniform(min(y2_lo, HEIGHT - 2.0), HEIGHT - 1.0)
        y1 = max(0.0, y2 - h)
        x1 = rng.uniform(0.0, WIDTH - 1.0 - w)
        box = (int(round(x1)), int(round(y1)),
               int(round(x1 + w)), int(round(min(y2, HEIGHT - 1.0))))
        if box[2] - box[0] >= 4 and box[3] - box[1] >= 4:
            out.append((cls, box))
    return out


def _write_xml(path: str, name: str, objects) -> None:
    """VOC-format XML; corners stored 1-based (parse_annotation shifts -1)."""
    lines = [
        "<annotation>",
        f"\t<filename>{name}.jpg</filename>",
        "\t<size>",
        f"\t\t<width>{WIDTH}</width>",
        f"\t\t<height>{HEIGHT}</height>",
        "\t\t<depth>3</depth>",
        "\t</size>",
    ]
    for cls, (x1, y1, x2, y2) in objects:
        lines += [
            "\t<object>",
            f"\t\t<name>{cls}</name>",
            "\t\t<difficult>0</difficult>",
            "\t\t<bndbox>",
            f"\t\t\t<xmin>{x1 + 1}</xmin>",
            f"\t\t\t<ymin>{y1 + 1}</ymin>",
            f"\t\t\t<xmax>{x2 + 1}</xmax>",
            f"\t\t\t<ymax>{y2 + 1}</ymax>",
            "\t\t</bndbox>",
            "\t</object>",
        ]
    lines.append("</annotation>")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def build_kitti_synth_dataset(
    out_dir: str,
    class_mapping: Dict[str, int],
    n_train: int = 1500,
    n_val: int = 750,
    seed: int = 0,
    jpeg_quality: int = 92,
) -> List[str]:
    """Materialize the synthetic KITTI-layout dataset; returns image names."""
    from PIL import Image as PilImage

    for d in ("JPEGImages", "Annotations", os.path.join("ImageSets", "Main")):
        os.makedirs(os.path.join(out_dir, d), exist_ok=True)

    names: List[str] = []
    sets = {"train": n_train, "val": n_val}
    for set_name, count in sets.items():
        lst = [f"k{set_name[0]}{i:06d}" for i in range(count)]
        with open(os.path.join(out_dir, "ImageSets", "Main", set_name + ".txt"),
                  "w") as f:
            f.write("\n".join(lst) + "\n")
        for nm in lst:
            rng = _rng_for(nm, seed)
            objects = _sample_objects(rng)
            _write_xml(os.path.join(out_dir, "Annotations", nm + ".xml"),
                       nm, objects)
            boxes = [b for _, b in objects]
            cls_idx = [class_mapping[c] for c, _ in objects]
            img = render_image(nm, HEIGHT, WIDTH, boxes, cls_idx, seed=seed)
            PilImage.fromarray(img).save(
                os.path.join(out_dir, "JPEGImages", nm + ".jpg"),
                quality=jpeg_quality,
            )
        names.extend(lst)
    return names
