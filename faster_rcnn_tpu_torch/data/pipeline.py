"""Host input pipeline: fixed-canvas padded batches with background prefetch.

Counterpart of faster_rcnn_tpu/data/pipeline.py, the same code over the
port's modules. The loader runs threads, never processes: a process forked
after CUDA is initialised cannot use it. Its batches are numpy arrays; the
trainer pins them and copies them to the device (train/trainer.py).

The reference trains batch-1, loading + resizing each image from disk with
cv2 inside the hot loop (shapes.py:24-29, SURVEY.md §3.1 "DISK + HOST CPU").
Here the host pipeline:

* pads each resized image into a static canvas (one step function and one
  set of anchor constants per canvas) and
  records the true (h, w) so anchors over padding are excluded on device;
* buckets by orientation — VOC's min-600/max-1000 policy yields landscape
  (<=608 x <=1024) and portrait (<=1024 x <=608) images; each bucket gets its
  own canvas so landscape batches don't pay portrait padding (aspect-ratio
  grouping);
* shuffles per epoch like train_util.py:38-43 (round-robin, reshuffle at
  wraparound) and prefetches decoded batches on worker threads so the GPU
  need not wait on JPEG decode.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from faster_rcnn_tpu_torch.config import FasterRcnnConfig
from faster_rcnn_tpu_torch.data.voc import ImageRecord
from faster_rcnn_tpu_torch.models.detector import preprocess_rgb


def canvas_for(record: ImageRecord, cfg: FasterRcnnConfig) -> Tuple[int, int]:
    """Canvas (h, w) for a record: cfg canvas for landscape, swapped for
    portrait."""
    ch, cw = cfg.data.canvas
    if record.height > record.width and ch < cw:
        return (cw, ch)
    return (ch, cw)


def prepare_example(
    record: ImageRecord,
    class_mapping: Dict[str, int],
    cfg: FasterRcnnConfig,
    canvas: Optional[Tuple[int, int]] = None,
    uint8: bool = False,
) -> Dict[str, np.ndarray]:
    """Decode + preprocess one image into fixed-shape arrays.

    Uses the native C++ pipeline (decode+resize+flip+preprocess+pad in one
    GIL-free call, data/native_loader.py) when available, else PIL.

    ``uint8=True`` ships the RAW resized RGB canvas as uint8 — 4x less
    host->device traffic; the BGR flip + mean subtraction then happens on
    device (train/pipeline.ingest_images / make_detect_fn uint8_input)."""
    from faster_rcnn_tpu_torch.data.native_loader import load_canvas_native, load_canvas_native_u8

    ch, cw = canvas or canvas_for(record, cfg)
    h, w = record.height, record.width
    if h > ch or w > cw:
        raise ValueError(f"image {record.name} ({h}x{w}) exceeds canvas ({ch}x{cw})")

    native = load_canvas_native_u8 if uint8 else load_canvas_native
    img = native(record.image_path, ch, cw, h, w, record.flipped)
    if img is None:
        pixels = record.load_pixels()
        if uint8:
            # pad with the mean RGB pixel: device-side mean subtraction then
            # maps padding to ~0, matching the float path's post-preprocess
            # zero canvas
            img = np.empty((ch, cw, 3), np.uint8)
            img[:] = np.array([124, 117, 104], np.uint8)
            img[:h, :w] = np.clip(np.round(pixels), 0, 255).astype(np.uint8)
        else:
            img = np.zeros((ch, cw, 3), np.float32)
            img[:h, :w] = preprocess_rgb(pixels)

    g = cfg.data.max_gt_boxes
    gt_boxes = np.zeros((g, 4), np.float32)
    gt_class = np.full((g,), len(class_mapping) - 1, np.int32)
    gt_valid = np.zeros((g,), bool)
    for i, box in enumerate(record.gt_boxes[:g]):
        gt_boxes[i] = box.corners
        gt_class[i] = class_mapping[box.obj_cls]
        gt_valid[i] = True

    return {
        "image": img,
        "gt_boxes": gt_boxes,
        "gt_class": gt_class,
        "gt_valid": gt_valid,
        "img_hw": np.array([h, w], np.int32),
    }


def _stack(examples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    return {k: np.stack([e[k] for e in examples]) for k in examples[0]}


class TrainLoader:
    """Infinite shuffled batch iterator with orientation bucketing.

    Yields (canvas, batch) tuples; batches are orientation-homogeneous so each
    canvas corresponds to one step function. A worker whose batch fails (an
    unreadable image, say) hands the exception to the consumer, which raises
    it where the JAX package's loader would wait for that batch forever.
    """

    def __init__(
        self,
        records: Sequence[ImageRecord],
        class_mapping: Dict[str, int],
        cfg: FasterRcnnConfig,
        batch_size: int,
        seed: int = 0,
        prefetch: int = 4,
        num_workers: int = 0,  # 0 = auto, scaled to batch size (see below)
        uint8: bool = False,
    ):
        self.cfg = cfg
        self.class_mapping = class_mapping
        self.batch_size = batch_size
        self.uint8 = uint8
        self.rng = np.random.RandomState(seed)
        self.buckets: Dict[Tuple[int, int], List[ImageRecord]] = {}
        for r in records:
            self.buckets.setdefault(canvas_for(r, cfg), []).append(r)
        self.prefetch = prefetch
        if num_workers <= 0:
            import os

            # Auto worker count scales with the batch this process must feed,
            # one thread a core: a fixed small cap would starve larger
            # batches. Each worker holds at most one prepared batch beside
            # the prefetch queue, so host memory is bounded by (workers +
            # prefetch) batches (44 MB each as uint8 at the 608x1504 canvas,
            # B=16).
            num_workers = min(os.cpu_count() or 1, max(8, batch_size))
        self.num_workers = num_workers

    def _record_stream(self) -> Iterator[Tuple[Tuple[int, int], List[ImageRecord]]]:
        """Round-robin over epochs; reshuffle each epoch (train_util.py:38-43).
        Emits full orientation-homogeneous batches.

        Partial batches CARRY ACROSS epoch boundaries (the reference's
        round-robin is likewise continuous).  Resetting them per epoch would
        starve any orientation bucket smaller than the batch size — and
        livelock the loader outright when no bucket ever fills (e.g. a tiny
        dataset with batch_size > len(records)), spinning epochs forever
        without yielding.
        """
        pending: Dict[Tuple[int, int], List[ImageRecord]] = {}
        while True:
            order = []
            for canvas, recs in self.buckets.items():
                idx = self.rng.permutation(len(recs))
                order.extend((canvas, recs[i]) for i in idx)
            self.rng.shuffle(order)
            for canvas, rec in order:
                pending.setdefault(canvas, []).append(rec)
                if len(pending[canvas]) == self.batch_size:
                    yield canvas, pending.pop(canvas)

    def __iter__(self) -> Iterator[Tuple[Tuple[int, int], Dict[str, np.ndarray]]]:
        stream = self._record_stream()
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        lock = threading.Lock()
        stop = threading.Event()

        def worker():
            while not stop.is_set():
                with lock:
                    try:
                        canvas, recs = next(stream)
                    except StopIteration:  # pragma: no cover - infinite stream
                        return
                try:
                    item = (canvas, _stack(
                        [prepare_example(r, self.class_mapping, self.cfg, canvas,
                                         uint8=self.uint8) for r in recs]
                    ))
                except Exception as e:  # noqa: BLE001 - the consumer raises it
                    item = e
                # bounded put that re-checks stop: a plain q.put would block
                # forever once the consumer goes away, leaking one thread (and
                # its pinned batch buffers) per abandoned iterator
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.2)
                        break
                    except queue.Full:
                        continue
                if isinstance(item, Exception):
                    return

        threads = [
            threading.Thread(target=worker, daemon=True, name="TrainLoader-worker")
            for _ in range(self.num_workers)
        ]
        for t in threads:
            t.start()
        try:
            while True:
                item = q.get()
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            # generator close()/GC runs this: workers observe `stop` and exit
            stop.set()
            while not q.empty():  # unblock any putter stuck on a full queue
                try:
                    q.get_nowait()
                except queue.Empty:  # pragma: no cover
                    break
