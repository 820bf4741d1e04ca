"""The device's idle share in the traced stretch of a serving window, %."""

from portbench.metrics._trace import idle_share


def read(run):
    return idle_share(run)
