"""Export a trained checkpoint as a Keras-layout weights h5.

    python -m faster_rcnn_tpu_torch.cli.export_h5 --workdir ./workdir \\
        --from_step joint --out frcnn_weights.h5

Counterpart of faster_rcnn_tpu/cli/export_h5.py: writes the layer and
weight names the reference's ``by_name`` loaders read (vgg.py:191-195,
resnet.py:481-485), the inverse of utils/keras_import.load_keras_h5. Runs
on the host; it needs ``h5py``.
"""

from __future__ import annotations

import argparse

from faster_rcnn_tpu_torch.cli.common import add_common_args
from faster_rcnn_tpu_torch.train.trainer import _load_step_params
from faster_rcnn_tpu_torch.utils.keras_import import save_keras_h5


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    add_common_args(p, training=False)
    p.add_argument("--workdir", default="./workdir",
                   help="training workdir with step checkpoints")
    p.add_argument("--from_step", default="joint",
                   help="checkpoint to export: 1|2|3|4|joint")
    p.add_argument("--out", required=True, help="output .h5 path")
    args = p.parse_args(argv)

    written = save_keras_h5(_load_step_params(args.workdir, args.from_step), args.out)
    print(f"wrote {len(written)} layers to {args.out}")
    return written


if __name__ == "__main__":
    main()
