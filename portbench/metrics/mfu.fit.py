"""The whole fit's share of the float32 peak over the traced fits, %: a
fit's operations (``costs/fit``: gradients, histograms, gains, routing,
leaves) times the traced fits, over their seconds on the host's clock,
at NVIDIA's published peak (``peaks.py``)."""


def read(run):
    tr, pk = run.trace, run.peaks
    fits = run.window.get("trace_fits")
    if tr is None or pk is None or not fits or tr.window_s <= 0:
        return None
    m = run.cfg["model"]
    ops, _ = run.cost("fit").cost(run.window["rows"], run.cfg["data"]["d"], m["n_trees"],
                                  m["max_depth"], m["n_bins"])
    return 100.0 * ops * fits / tr.window_s / pk["fp32_flops"]
