"""Shared by the readers of the traced stretch."""

from portbench import counters, peaks


def idle_share(run):
    """100 × the traced stretch's share in which no operation ran on the
    device (the union of its kernels', copies' and sets' intervals)."""
    tr = run.trace
    if tr is None or not tr.device_ops or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)


def flush_mix(run):
    """{bucket: share of the traced stretch's flushes}, or None."""
    buckets = counters.flush_buckets(run.window.get("trace_counters") or {})
    total = sum(buckets.values())
    if not total:
        return None
    return {b: k / total for b, k in buckets.items()}


def kernel_roofline(run, count_part, time_part, least_of_call):
    """100 × the least time of the traced calls of a kernel (counted by
    the device operations named with ``count_part``) over their device
    time (every operation named with ``time_part``). ``least_of_call(b)``
    is a call's least seconds at flush bucket b."""
    tr, pk, mix = run.trace, run.peaks, flush_mix(run)
    if tr is None or pk is None or mix is None:
        return None
    _, calls = tr.kernel(count_part)
    busy, _ = tr.kernel(time_part)
    if not calls or busy <= 0:
        return None
    least = calls * sum(share * least_of_call(b, pk) for b, share in mix.items())
    return 100.0 * least / busy


def least(cost, pk):
    ops, nbytes = cost
    return peaks.least_seconds(ops, nbytes, pk)
