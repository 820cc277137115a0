"""Device ms of a detect call's stage ``ingest`` (the upload of the frames and
their sizes, the BGR flip, the float conversion and the mean subtraction),
between the CUDA events at the edges of the port's span of it: the mean over
the traced calls."""

from portbench import spans

COMBINE = "max"


def read(t):
    return spans.stage_ms(t, "frcnn.detect", "ingest")
