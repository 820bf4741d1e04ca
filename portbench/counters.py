"""The program's counters a serving run reads (``service/metrics``), taken
before and after a stretch of the run: the request stages' sums and
counts, the rows per flush (bucket counts, sum, count) and the flushes by
path. Read in the serving process, where the program keeps them."""

from __future__ import annotations


def snapshot() -> dict:
    from fraud_detection_tpu_torch.service import metrics

    out: dict = {"stages": {}, "flushes": {}}
    for key, child in metrics.request_stage_duration._children.items():
        out["stages"][key[0]] = (child.value, child.count)
    size = metrics.microbatch_size._children.get(())
    if size is not None:
        out["flush_rows"] = {
            "buckets": list(zip(metrics.microbatch_size.buckets, size.buckets)),
            "sum": size.value, "count": size.count,
        }
    for key, child in metrics.scorer_flushes._children.items():
        out["flushes"][key[0]] = out["flushes"].get(key[0], 0.0) + child.value
    return out


def delta(a: dict, b: dict) -> dict:
    """What happened between snapshots ``a`` and ``b``."""
    out: dict = {"stages": {}, "flushes": {}}
    for stage, (s, c) in b["stages"].items():
        s0, c0 = a["stages"].get(stage, (0.0, 0))
        out["stages"][stage] = (s - s0, c - c0)
    for path, v in b["flushes"].items():
        out["flushes"][path] = v - a["flushes"].get(path, 0.0)
    if "flush_rows" in b:
        fa = a.get("flush_rows", {"buckets": [(le, 0) for le, _ in b["flush_rows"]["buckets"]],
                                  "sum": 0.0, "count": 0})
        out["flush_rows"] = {
            "buckets": [(le, n - n0) for (le, n), (_, n0)
                        in zip(b["flush_rows"]["buckets"], fa["buckets"])],
            "sum": b["flush_rows"]["sum"] - fa["sum"],
            "count": b["flush_rows"]["count"] - fa["count"],
        }
    return out


def flush_buckets(d: dict, min_bucket: int = 8) -> dict[int, int]:
    """Flushes by the power-of-two bucket the scorer pads them to, from the
    rows-per-flush histogram's cumulative counts (bucket edges 1, 2, 4, ...)."""
    fr = d.get("flush_rows")
    if not fr:
        return {}
    out: dict[int, int] = {}
    prev = 0
    for le, cum in fr["buckets"]:
        k = int(cum - prev)
        prev = cum
        if k:
            b = max(int(le), min_bucket)
            out[b] = out.get(b, 0) + k
    return out
