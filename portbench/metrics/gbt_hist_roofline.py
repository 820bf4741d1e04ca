"""``gbt_hist``'s share of its roofline over the traced fits, %: the least
time of a fit's histogram calls (``costs/gbt_hist``: a level's at 2^l
nodes and the leaf sums, each tree) scaled to the calls in the trace,
over the device time of the kernel's three launches, by name."""

from portbench import peaks


def read(run):
    tr, pk = run.trace, run.peaks
    if tr is None or pk is None:
        return None
    _, calls = tr.kernel("gbt_hist_accumulate")
    busy, _ = tr.kernel("gbt_hist_")
    if not calls or busy <= 0:
        return None
    m, d = run.cfg["model"], run.cfg["data"]["d"]
    mod = run.cost("gbt_hist")
    plan = mod.fit_calls(run.window["rows"], d, m["n_trees"], m["max_depth"], m["n_bins"])
    per_fit = sum(k * peaks.least_seconds(*mod.cost(**shape), pk) for shape, k in plan)
    calls_per_fit = sum(k for _, k in plan)
    return 100.0 * per_fit * calls / calls_per_fit / busy
