"""Model FLOPs of the traced detect calls' images over the H100's bf16 peak for
the traced window, in %."""

from portbench import readers

COMBINE = "mean"


def read(t):
    return readers.mfu_pct(t)
