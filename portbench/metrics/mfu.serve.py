"""The whole flush's share of the float32 peak in the traced stretch, %:
its flushes' operations (``costs/flush``: the score, the explain leg and
the drift fold at each flush's bucket) over the stretch's seconds on
the host's clock, at NVIDIA's published peak (``peaks.py``)."""

from portbench import counters

_ELEM = {"float32": 4, "bfloat16": 2, "int8": 1}


def read(run):
    tr, pk = run.trace, run.peaks
    buckets = counters.flush_buckets(run.window.get("trace_counters") or {})
    if tr is None or pk is None or not buckets or tr.window_s <= 0:
        return None
    cfg = run.cfg
    m, serve = cfg["model"], cfg["serve"]
    forest = (m["n_trees"], m["max_depth"], m["n_bins"]) if cfg["family"] == "gbt" else None
    k = serve["explain_k"] if serve["explain"] == "topk" else 0
    cost = run.cost("flush").cost
    ops = sum(n * cost(b, cfg["data"]["d"], elem_bytes=_ELEM[serve["wire"]], explain_k=k,
                       forest=forest)[0] for b, n in buckets.items())
    return 100.0 * ops / tr.window_s / pk["fp32_flops"]
