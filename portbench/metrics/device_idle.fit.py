"""The device's idle share over the traced whole fits, %."""

from portbench.metrics._trace import idle_share


def read(run):
    return idle_share(run)
