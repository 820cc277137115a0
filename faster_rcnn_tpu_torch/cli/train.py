"""Unified training CLI: the reference's four scripts as one command.

    python -m faster_rcnn_tpu_torch.cli.train --step 1 --voc_paths /data/VOC2007 ...
    python -m faster_rcnn_tpu_torch.cli.train --step all ...

Counterpart of faster_rcnn_tpu/cli/train.py: the weight handoff between
steps goes through the workdir's checkpoints, and a re-run resumes from
them. Runs on the GPU (``--device cpu``: the plain versions on the CPU).
The JAX package's ``--device_cache`` and ``--multihost`` are not ported
yet, so a command line that passes them fails.
"""

from __future__ import annotations

import argparse

from faster_rcnn_tpu_torch import resolve_device
from faster_rcnn_tpu_torch.cli.common import (add_common_args, class_mapping_from_args,
                                              config_from_args)
from faster_rcnn_tpu_torch.data.voc import load_dataset
from faster_rcnn_tpu_torch.train.trainer import run_four_step_training


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    add_common_args(p, training=True)
    p.add_argument("--step", default="all",
                   help="1|2|3|4, comma list (e.g. 1,2), 'all', or 'joint' "
                        "(single-pass approximate-joint training)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    cfg = config_from_args(args)
    class_mapping = class_mapping_from_args(args)
    records, _ = load_dataset(
        args.voc_paths.split(","),
        args.img_set,
        flip=args.flip,
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
    results = run_four_step_training(
        cfg, records, class_mapping, args.workdir, steps=steps,
        batch_size=args.batch_size, save_frequency=args.save_frequency,
        seed=args.seed, uint8_pipeline=args.uint8_pipeline, device=device,
    )
    for s, r in results.items():
        print(f"step {s} final metrics: {r.final_metrics}")
    return results


if __name__ == "__main__":
    main()
