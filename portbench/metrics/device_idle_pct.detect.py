"""Share of the traced window of detect calls in which no device operation ran,
in %."""

from portbench import readers

COMBINE = "max"


def read(t):
    return readers.idle_pct(t)
