"""Rows a flush over the window (``scorer_microbatch_size``, sum over
count): how much the micro-batcher coalesces."""


def read(run):
    c = run.window.get("counters")
    fr = c.get("flush_rows") if c else None
    if not fr or not fr["count"]:
        return None
    return fr["sum"] / fr["count"]
