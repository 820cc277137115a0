"""Unified training CLI: the reference's four scripts as one command.

    python -m faster_rcnn_tpu_torch.cli.train --step 1 --voc_paths /data/VOC2007 ...
    python -m faster_rcnn_tpu_torch.cli.train --step all ...

Counterpart of faster_rcnn_tpu/cli/train.py: the weight handoff between
steps goes through the workdir's checkpoints, and a re-run resumes from
them. Runs on the GPU (``--device cpu``: the plain versions on the CPU).
``--device_cache`` puts the whole uint8 dataset on the device and trains
from it (train/device_cache.py). ``--multihost`` trains data-parallel, one
process per card, ``--batch_size`` being the global batch:

    torchrun --nproc_per_node 4 -m faster_rcnn_tpu_torch.cli.train --multihost ...

It joins the process group first, before anything touches a card; under a
multi-process launch a command line without it fails, and so does one with
it outside such a launch.
"""

from __future__ import annotations

import argparse
import dataclasses

from faster_rcnn_tpu_torch import resolve_device
from faster_rcnn_tpu_torch.cli.common import (add_common_args, class_mapping_from_args,
                                              config_from_args)
from faster_rcnn_tpu_torch.data.voc import load_dataset
from faster_rcnn_tpu_torch.parallel.multihost import maybe_initialize
from faster_rcnn_tpu_torch.train.trainer import run_four_step_training


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    add_common_args(p, training=True)
    p.add_argument("--step", default="all",
                   help="1|2|3|4, comma list (e.g. 1,2), 'all', or 'joint' "
                        "(single-pass approximate-joint training)")
    p.add_argument("--device_cache", action="store_true",
                   help="upload the whole dataset to the device (uint8) and train "
                        "from it (train/device_cache.py); flip augmentation moves "
                        "to the device, so --flip's host doubling is off")
    p.add_argument("--chunk_steps", type=int, default=50,
                   help="with --device_cache: steps enqueued between two reads "
                        "of the metrics (and checkpoint chances)")
    args = p.parse_args(argv)
    if args.multihost:
        # before any tensor reaches a card: it makes the local card current
        maybe_initialize(require=True, device=args.device)
    device = resolve_device(args.device)

    cfg = config_from_args(args)
    class_mapping = class_mapping_from_args(args)
    records, _ = load_dataset(
        args.voc_paths.split(","),
        args.img_set,
        flip=args.flip and not args.device_cache,
        resize_min=cfg.data.resize_min,
        resize_max=cfg.data.resize_max,
    )
    print(f"loaded {len(records)} training records")

    if args.step == "all":
        steps = (1, 2, 3, 4)
    elif args.step == "joint":
        steps = ("joint",)
    else:
        steps = tuple(int(s) for s in str(args.step).split(","))
    if args.device_cache and not args.flip:
        # the on-device flip follows cfg.data.flip_augment
        cfg = cfg.replace(data=dataclasses.replace(cfg.data, flip_augment=False))
    extra = (dict(chunk_steps=args.chunk_steps) if args.device_cache
             else dict(uint8_pipeline=args.uint8_pipeline))
    results = run_four_step_training(
        cfg, records, class_mapping, args.workdir, steps=steps,
        batch_size=args.batch_size, save_frequency=args.save_frequency,
        seed=args.seed, use_device_cache=args.device_cache, device=device,
        multihost=args.multihost, **extra,
    )
    for s, r in results.items():
        print(f"step {s} final metrics: {r.final_metrics}")
    return results


if __name__ == "__main__":
    main()
