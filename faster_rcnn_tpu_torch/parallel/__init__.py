"""Parameter freezing and the optimizer (counterpart of faster_rcnn_tpu/parallel)."""
