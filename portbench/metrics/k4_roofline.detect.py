"""The K4 top-k's least time over its device time in the traced detect calls,
all five kernels of a launch, in %."""

from portbench import readers

COMBINE = "mean"


def read(t):
    return readers.roofline_pct(t, "k4")
