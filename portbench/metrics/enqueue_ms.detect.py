"""Host ms from a detect call's issue to its return, before the readback: the
median over the window's calls."""

from portbench import readers

COMBINE = "max"


def read(t):
    return readers.enqueue_ms(t)
