"""Shared by the stage readers: the mean of a request stage over the
window (``request_stage_duration_seconds{stage}``, sum over count), ms."""


def mean_ms(run, stage):
    c = run.window.get("counters")
    if not c or stage not in c["stages"]:
        return None
    total, count = c["stages"][stage]
    return 1000.0 * total / count if count else None
