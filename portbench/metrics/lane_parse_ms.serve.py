"""The binary lane's parse of a frame (receive into the staging slot and
check), mean ms over the window: the program's ``parse`` stage."""

from portbench.metrics._stages import mean_ms


def read(run):
    return mean_ms(run, "parse")
