#!/usr/bin/env python3
"""Time the port's host data path (faster_rcnn_tpu_torch/data/) on this
machine's CPU: no GPU is used.

    python3 scripts/bench_loader_torch.py [frames]

It writes ``frames`` KITTI-synthetic 1242x375 JPEGs (default 64, as the
loader_train phase does) to a temporary directory and, for each decoder
the host has (the native libjpeg one, if it builds, and PIL), times
``prepare_example`` into a 608x1504 uint8 canvas on one thread, and
``TrainLoader`` batches of 16 at 1, 2, 4 and 8 workers with
``chip_smoke.loader_alone``, the same timing as chip_smoke.py's
loader_train phase prints. It prints one JSON line per decoder, with
``os.cpu_count()`` and why the native decoder did not build, if it did
not.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time
from unittest import mock

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import LOADER_TRAIN, loader_alone  # noqa: E402
from faster_rcnn_tpu_torch.config import kitti_config  # noqa: E402
from faster_rcnn_tpu_torch.data import kitti_synth, native_loader  # noqa: E402
from faster_rcnn_tpu_torch.data import pipeline as data_pipeline  # noqa: E402
from faster_rcnn_tpu_torch.data.voc import KITTI_CLASS_MAPPING, load_dataset  # noqa: E402


def main(frames: int = LOADER_TRAIN) -> None:
    cfg = kitti_config()
    with tempfile.TemporaryDirectory() as root:
        kitti_synth.build_kitti_synth_dataset(root, KITTI_CLASS_MAPPING, n_train=frames,
                                              n_val=0)
        records, _ = load_dataset([root], "train", resize_min=600, resize_max=1500)
        decoders = ["native", "pil"] if native_loader.available() else ["pil"]
        for decoder in decoders:
            with mock.patch.object(native_loader, "load_canvas_native_u8",
                                   native_loader.load_canvas_native_u8 if decoder == "native"
                                   else (lambda *a, **k: None)):
                one = records[:16]
                data_pipeline.prepare_example(one[0], KITTI_CLASS_MAPPING, cfg, uint8=True)
                t0 = time.perf_counter()
                for r in one:
                    data_pipeline.prepare_example(r, KITTI_CLASS_MAPPING, cfg, uint8=True)
                single = len(one) / (time.perf_counter() - t0)
                rates = {w: loader_alone(records, cfg, w)["img_per_s"] for w in (1, 2, 4, 8)}
            print(json.dumps({"decoder": decoder, "cpu_count": os.cpu_count(),
                              "native_build_error": native_loader.build_info.get("error"),
                              "prepare_example_img_per_s": single,
                              "loader_img_per_s_by_workers": rates}), flush=True)


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:]))
