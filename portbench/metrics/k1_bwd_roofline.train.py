"""The K1 RoI-align backward's least time over its device time in the traced
train steps, in %."""

from portbench import readers

COMBINE = "mean"


def read(t):
    return readers.roofline_pct(t, "k1_bwd")
