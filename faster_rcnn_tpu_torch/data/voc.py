"""VOC / KITTI-as-VOC dataset layer.

A copy of faster_rcnn_tpu/data/voc.py, which the port may not import.

Rebuild of data/voc_data_helpers.py + the relevant parts of shapes.py:

* XML annotation parsing with the 1-based -> 0-based coordinate shift
  (voc_data_helpers.py:111-114);
* class mappings for VOC (20 + bg) and KITTI (9 + bg)
  (voc_data_helpers.py:10-45) — background is always the LAST index;
* imageset file reading (voc_data_helpers.py:132-138);
* annotation-less KITTI test images are synthesized IN MEMORY — the
  reference writes XML files into the dataset directory as a side effect
  (voc_data_helpers.py:74-97), a quirk consciously fixed here;
* lazy pixel loading with horizontal-flip doubling (args_util.py:24-26) and
  the min-600/max-1000 resize policy (shapes.py:106-123).

Images load via PIL (the environment has no OpenCV); pixels are RGB.  The
reference's cv2.INTER_CUBIC resize becomes PIL BICUBIC — equivalent filters,
not bit-identical (documented deviation, irrelevant at mAP level).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Sequence, Tuple
from xml.etree import ElementTree

import numpy as np

IMAGES_DIR = "JPEGImages"
ANNOTATIONS_DIR = "Annotations"
IMAGESETS_DIR = "ImageSets/Main"

VOC_CLASS_MAPPING: Dict[str, int] = {
    "aeroplane": 0, "bicycle": 1, "bird": 2, "boat": 3, "bottle": 4,
    "bus": 5, "car": 6, "cat": 7, "chair": 8, "cow": 9, "diningtable": 10,
    "dog": 11, "horse": 12, "motorbike": 13, "person": 14, "pottedplant": 15,
    "sheep": 16, "sofa": 17, "train": 18, "tvmonitor": 19, "bg": 20,
}

KITTI_CLASS_MAPPING: Dict[str, int] = {
    "car": 0, "person": 1, "Cyclist": 2, "DontCare": 3, "Misc": 4,
    "Person_sitting": 5, "Tram": 6, "Truck": 7, "Van": 8, "bg": 9,
}


@dataclasses.dataclass
class GtBox:
    """One annotated object: class name, VOC 'difficult' flag, 0-based corners."""

    obj_cls: str
    difficult: bool
    x1: float
    y1: float
    x2: float
    y2: float

    @property
    def corners(self) -> np.ndarray:
        return np.array([self.x1, self.y1, self.x2, self.y2], np.float32)

    def resize(self, ratio: float) -> "GtBox":
        return GtBox(self.obj_cls, self.difficult,
                     self.x1 * ratio, self.y1 * ratio, self.x2 * ratio, self.y2 * ratio)

    def hflip(self, width: float) -> "GtBox":
        return GtBox(self.obj_cls, self.difficult,
                     width - self.x2, self.y1, width - self.x1, self.y2)


@dataclasses.dataclass
class ImageRecord:
    """Image metadata + lazy pixel access (shapes.Image rebuild).

    ``width``/``height`` are the *desired* dims; pixels are resized on load.
    """

    name: str
    width: int
    height: int
    gt_boxes: List[GtBox]
    image_path: str
    flipped: bool = False
    resize_ratio: float = 1.0

    @property
    def cache_key(self) -> str:
        return self.name + str(self.flipped)

    def resize(self, ratio: float) -> "ImageRecord":
        return dataclasses.replace(
            self,
            width=int(round(self.width * ratio)),
            height=int(round(self.height * ratio)),
            gt_boxes=[b.resize(ratio) for b in self.gt_boxes],
            resize_ratio=self.resize_ratio * ratio,
        )

    def resize_within_bounds(self, min_size: int, max_size: int) -> Tuple["ImageRecord", float]:
        """Shorter side -> min_size unless the longer side would exceed
        max_size (shapes.py:106-123)."""
        short = min(self.width, self.height)
        long = max(self.width, self.height)
        min_ratio = min_size / short
        ratio = max_size / long if min_ratio * long > max_size else min_ratio
        return self.resize(ratio), ratio

    def horizontal_flip(self) -> "ImageRecord":
        return dataclasses.replace(
            self,
            gt_boxes=[b.hflip(self.width) for b in self.gt_boxes],
            flipped=not self.flipped,
        )

    def load_pixels(self) -> np.ndarray:
        """RGB float32 (height, width, 3), resized + flipped per metadata."""
        from PIL import Image as PilImage

        with PilImage.open(self.image_path) as im:
            im = im.convert("RGB")
            if (im.width, im.height) != (self.width, self.height):
                im = im.resize((self.width, self.height), PilImage.BICUBIC)
            arr = np.asarray(im, np.float32)
        if self.flipped:
            arr = arr[:, ::-1, :]
        return arr


def parse_annotation(base_path: str, img_name: str) -> ImageRecord:
    """Parse one VOC XML (voc_data_helpers.py:68-125 semantics).  For
    annotation-less images (KITTI test) the record is synthesized in memory
    from the image header instead of writing XML into the dataset."""
    ann_path = os.path.join(base_path, ANNOTATIONS_DIR, img_name + ".xml")
    images_base = os.path.join(base_path, IMAGES_DIR)

    if not os.path.exists(ann_path):
        for ext in (".png", ".jpg", ".jpeg"):
            image_path = os.path.join(images_base, img_name + ext)
            if os.path.exists(image_path):
                break
        else:
            raise FileNotFoundError(f"no annotation or image for {img_name}")
        from PIL import Image as PilImage

        with PilImage.open(image_path) as im:
            width, height = im.width, im.height
        return ImageRecord(img_name, width, height, [], image_path)

    root = ElementTree.parse(ann_path).getroot()
    image_path = os.path.join(images_base, root.find("filename").text)
    size = root.find("size")
    width = int(size.find("width").text)
    height = int(size.find("height").text)

    gt_boxes = []
    for obj in root.findall("object"):
        name = obj.find("name").text
        bb = obj.find("bndbox")
        # 1-based annotations -> 0-based coords (voc_data_helpers.py:111-114)
        x1 = int(float(bb.find("xmin").text)) - 1
        x2 = int(float(bb.find("xmax").text)) - 1
        y1 = int(float(bb.find("ymin").text)) - 1
        y2 = int(float(bb.find("ymax").text)) - 1
        diff_node = obj.find("difficult")
        difficult = diff_node is not None and int(diff_node.text) == 1
        gt_boxes.append(GtBox(name, difficult, x1, y1, x2, y2))

    return ImageRecord(img_name, width, height, gt_boxes, image_path)


def imageset_names(base_path: str, set_name: str) -> List[str]:
    path = os.path.join(base_path, IMAGESETS_DIR, set_name + ".txt")
    with open(path) as f:
        return [line.rstrip("\n") for line in f if line.strip()]


def load_dataset(
    base_paths: Sequence[str],
    img_set: str,
    flip: bool = True,
    resize_min: int = 600,
    resize_max: int = 1000,
) -> Tuple[List[ImageRecord], List[float]]:
    """Multi-dataset load + flip doubling + resize, mirroring
    args_util.py:7-27 base_paths_to_imgs followed by util.py:209-226
    resize_imgs.  Returns (records, resize_ratios)."""
    records: List[ImageRecord] = []
    for base in base_paths:
        for name in imageset_names(base, img_set):
            records.append(parse_annotation(base, name))
    if flip:
        records = records + [r.horizontal_flip() for r in records]

    resized, ratios = [], []
    for r in records:
        rr, ratio = r.resize_within_bounds(resize_min, resize_max)
        resized.append(rr)
        ratios.append(ratio)
    return resized, ratios
