"""Share of the traced window of train steps in which no device operation ran,
in %; the largest rank's."""

from portbench import readers

COMBINE = "max"


def read(t):
    return readers.idle_pct(t)
