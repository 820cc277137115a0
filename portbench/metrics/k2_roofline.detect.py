"""The K2 stem conv's least time over its device time in the traced detect
calls, in %."""

from portbench import readers

COMBINE = "mean"


def read(t):
    return readers.roofline_pct(t, "k2")
