"""Device ms of a detect call's stage ``decode`` (the per-ROI argmax, the class
boxes and K3's class-offset NMS), between the CUDA events at the edges of the
port's span of it: the mean over the traced calls."""

from portbench import spans

COMBINE = "max"


def read(t):
    return spans.stage_ms(t, "frcnn.detect", "decode")
