"""Device ms of a detect call's stage ``roi_align_head`` (K1's RoI align, stage 5
or fc6/fc7 and the softmax), between the CUDA events at the edges of the port's
span of it: the mean over the traced calls."""

from portbench import spans

COMBINE = "max"


def read(t):
    return spans.stage_ms(t, "frcnn.detect", "roi_align_head")
