"""A frame's wait in the micro-batcher before its flush starts: the means
of the program's ``enqueue`` and ``flush_wait`` stages over the window,
added, ms."""

from portbench.metrics._stages import mean_ms


def read(run):
    a, b = mean_ms(run, "enqueue"), mean_ms(run, "flush_wait")
    return None if a is None or b is None else a + b
