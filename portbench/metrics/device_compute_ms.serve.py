"""A flush's device part on the host's clock: the upload, the launches
and their execution up to the flush's one fence, mean ms over the window
(the program's ``device_compute`` stage)."""

from portbench.metrics._stages import mean_ms


def read(run):
    return mean_ms(run, "device_compute")
