"""Device ms of the joint step's stage ending at its mark 'det_targets', from
CUDA events at the step's own marks, the mean over the traced steps."""

from portbench import readers

COMBINE = "max"


def read(t):
    return readers.mark_ms(t, "det_targets")
