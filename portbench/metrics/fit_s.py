"""Seconds a whole fit: from the window's start to the end of its last
fit (the one under way at ``--seconds`` finishes), over the fits. Host
clock; every fit ends with the device synchronised."""


def read(run):
    times = run.window.get("fit_times_s")
    if not times:
        return None
    return run.window["elapsed_s"] / len(times)
