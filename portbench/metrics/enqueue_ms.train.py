"""Host ms from a train step's issue to its return: the median over the
window's steps."""

from portbench import readers

COMBINE = "max"


def read(t):
    return readers.enqueue_ms(t)
