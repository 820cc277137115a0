"""Device ms of a detect call's stage ``rpn_proposals`` (the RPN head, its
sigmoid, the box decode, K4's top-k and K3's NMS), between the CUDA events at
the edges of the port's span of it: the mean over the traced calls."""

from portbench import spans

COMBINE = "max"


def read(t):
    return spans.stage_ms(t, "frcnn.detect", "rpn_proposals")
