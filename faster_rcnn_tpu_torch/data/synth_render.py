"""Deterministic synthetic pixels for REAL VOC annotations (mAP-parity proxy).

A copy of faster_rcnn_tpu/data/synth_render.py, which the port may not import.

No images survive in this environment beyond one JPEG, but the reference
mount carries 5,011 real VOC2007 trainval annotation XMLs with real class
frequencies, box statistics, crowding, and difficult flags
(test_data/VOC_test/Annotations, SURVEY.md §4 fixtures).  This module renders
deterministic synthetic pixels AT those ground-truth boxes — each class gets
a distinctive (hue, stripe-orientation, stripe-period) texture — over a
cluttered achromatic background, producing a dataset whose *geometry and
label statistics are exactly VOC2007's* while the appearance model stays
learnable from scratch.

Training on these images and evaluating 20-class mAP with the VOC evaluator
exercises per-class regression decode, class imbalance (e.g. 'person' is ~30%
of boxes), difficult-box exclusion, anchor coverage across the real box-size
distribution, and multi-object NMS behavior — none of which the 2-class
rectangle smoke test (scripts/synthetic_e2e.py) can see.

Determinism: every image's pixels depend only on (image name, class list,
boxes, global seed) — re-rendering is reproducible across runs/processes.
"""

from __future__ import annotations

import colorsys
import hashlib
import os
import shutil
from typing import Dict, List, Sequence, Tuple

import numpy as np


def class_style(cls_idx: int) -> Dict:
    """Visual identity for a class index: base/stripe RGB + orientation/period.

    Hues are golden-ratio spaced (maximally separated for any class count);
    stripe orientation cycles through 4 directions and the period factor
    through 3 values, so classes differ in more than color alone.
    """
    hue = (cls_idx * 0.6180339887) % 1.0
    base = np.array(colorsys.hsv_to_rgb(hue, 0.80, 0.85)) * 255.0
    stripe = np.array(colorsys.hsv_to_rgb((hue + 0.5) % 1.0, 0.70, 0.55)) * 255.0
    return {
        "base": base.astype(np.float32),
        "stripe": stripe.astype(np.float32),
        "orient": cls_idx % 4,           # 0=horiz, 1=vert, 2=diag, 3=anti-diag
        "period_div": 4 + (cls_idx % 3),  # stripes per min-side: 4..6
    }


def _stripe_mask(h: int, w: int, orient: int, period: int) -> np.ndarray:
    yy, xx = np.mgrid[0:h, 0:w]
    t = (yy, xx, yy + xx, yy - xx + w)[orient]
    return ((t // period) % 2).astype(bool)


def _rng_for(name: str, seed: int) -> np.random.RandomState:
    digest = hashlib.sha256(f"{seed}:{name}".encode()).digest()
    return np.random.RandomState(np.frombuffer(digest[:4], np.uint32)[0])


def render_image(
    name: str,
    height: int,
    width: int,
    boxes: Sequence[Tuple[int, int, int, int]],
    class_indices: Sequence[int],
    seed: int = 0,
) -> np.ndarray:
    """(H, W, 3) uint8 RGB: cluttered gray background + class textures at boxes.

    ``boxes`` are 0-based [x1, y1, x2, y2] inclusive pixel coords (the parsed
    VOC convention after the -1 shift, voc_data_helpers.py:111-114).  Objects
    draw largest-first so smaller (often overlapping) boxes stay visible on
    top — real VOC scenes are heavily nested (chairs, crowds).
    """
    rng = _rng_for(name, seed)

    # background: mid-gray base + low-frequency luminance blobs + achromatic
    # clutter rectangles + pixel noise (gray clutter can't imitate a class —
    # class identity is carried by saturated hue + stripes)
    img = np.full((height, width, 3), 110.0, np.float32)
    coarse = rng.randn(max(2, height // 64), max(2, width // 64)) * 18.0
    reps_y = -(-height // coarse.shape[0])
    reps_x = -(-width // coarse.shape[1])
    img += np.kron(coarse, np.ones((reps_y, reps_x)))[:height, :width, None]
    for _ in range(rng.randint(6, 14)):
        cw = rng.randint(20, max(21, width // 3))
        ch = rng.randint(20, max(21, height // 3))
        cx = rng.randint(0, max(1, width - cw))
        cy = rng.randint(0, max(1, height - ch))
        img[cy:cy + ch, cx:cx + cw] += rng.uniform(-35, 35)

    order = sorted(
        range(len(boxes)),
        key=lambda i: -(boxes[i][2] - boxes[i][0]) * (boxes[i][3] - boxes[i][1]),
    )
    for i in order:
        x1, y1, x2, y2 = (int(v) for v in boxes[i])
        x1, y1 = max(0, x1), max(0, y1)
        x2, y2 = min(width - 1, x2), min(height - 1, y2)
        if x2 <= x1 or y2 <= y1:
            continue
        bh, bw = y2 - y1 + 1, x2 - x1 + 1
        st = class_style(int(class_indices[i]))
        period = max(3, min(bh, bw) // st["period_div"])
        patch = np.where(
            _stripe_mask(bh, bw, st["orient"], period)[..., None],
            st["stripe"][None, None, :],
            st["base"][None, None, :],
        )
        # dark border helps localization supervision hit the exact GT extent
        b = max(1, min(bh, bw) // 24)
        patch[:b], patch[-b:], patch[:, :b], patch[:, -b:] = 20.0, 20.0, 20.0, 20.0
        img[y1:y2 + 1, x1:x2 + 1] = patch

    img += rng.randn(height, width, 3) * 6.0
    return np.clip(img, 0, 255).astype(np.uint8)


def build_proxy_dataset(
    src_voc: str,
    out_dir: str,
    class_mapping: Dict[str, int],
    img_sets: Sequence[str] = ("train", "val"),
    seed: int = 0,
    jpeg_quality: int = 92,
    limit: int = 0,
) -> List[str]:
    """Materialize a VOC-layout dataset: real annotations + rendered pixels.

    Copies Annotations/ImageSets from ``src_voc`` (read-only reference mount)
    for the union of ``img_sets`` and renders one JPEG per annotation.
    Returns the list of image names rendered.  ``limit`` > 0 truncates each
    set (scaled-down CI variant).
    """
    from PIL import Image as PilImage

    from faster_rcnn_tpu_torch.data.voc import parse_annotation

    names: List[str] = []
    per_set: Dict[str, List[str]] = {}
    for s in img_sets:
        with open(os.path.join(src_voc, "ImageSets", "Main", s + ".txt")) as f:
            lst = [ln.split()[0] for ln in f if ln.strip()]
        if limit:
            lst = lst[:limit]
        per_set[s] = lst
        names.extend(n for n in lst if n not in set(names))

    for d in ("JPEGImages", "Annotations", os.path.join("ImageSets", "Main")):
        os.makedirs(os.path.join(out_dir, d), exist_ok=True)
    for s, lst in per_set.items():
        with open(os.path.join(out_dir, "ImageSets", "Main", s + ".txt"), "w") as f:
            f.write("\n".join(lst) + "\n")

    for n in names:
        shutil.copyfile(
            os.path.join(src_voc, "Annotations", n + ".xml"),
            os.path.join(out_dir, "Annotations", n + ".xml"),
        )
        rec = parse_annotation(src_voc, n)  # original-size record (no resize)
        boxes = [tuple(b.corners.astype(int)) for b in rec.gt_boxes]
        cls = [class_mapping[b.obj_cls] for b in rec.gt_boxes]
        img = render_image(n, rec.height, rec.width, boxes, cls, seed=seed)
        PilImage.fromarray(img).save(
            os.path.join(out_dir, "JPEGImages", n + ".jpg"), quality=jpeg_quality
        )
    return names
