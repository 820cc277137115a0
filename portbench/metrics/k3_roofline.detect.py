"""The K3 NMS's least time (IoU pairs of these inputs) over its device time in
the traced detect calls, both launches a call, in %."""

from portbench import readers

COMBINE = "mean"


def read(t):
    return readers.roofline_pct(t, "k3")
