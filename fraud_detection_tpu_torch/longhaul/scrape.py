"""Cross-host scrape: one merged drift window, one fleet SLO view.

The port's counterpart of the JAX package's ``longhaul/scrape.py``. Every
host's ``scrape`` op returns its contribution stamped with the membership
epoch that host believes (``host.py``). The merge accepts only
contributions of the coordinator's epoch — the split-brain guard: a host on
the wrong side of a partition keeps serving its stale view, but its window
never double-counts into the fleet aggregate, because the partition is what
froze its epoch. Stale contributions are counted
(``longhaul_scrape_stale_epoch{host}``) and dropped.

Drift windows merge by leaf sum — ``mesh/shardflush``'s merge over device
shards, one level up: decayed histograms are linear in their rows, so the
sum of per-host windows is the window one host would hold over the union
stream (one decay schedule fleet-wide). A contribution's window is its six
leaves in ``monitor/drift.WINDOW_FIELDS`` order; the merge is a
:class:`~fraud_detection_tpu_torch.monitor.drift.DriftWindow` of numpy
leaves.

SLO status merges raw window counts (good and bad events add across
hosts); burn rate and budget remaining derive from the sums, not from an
average of per-host ratios. The result refreshes
``longhaul_fleet_budget_remaining{slo}``.
"""

from __future__ import annotations

import logging

import numpy as np

from fraud_detection_tpu_torch.longhaul import codec
from fraud_detection_tpu_torch.monitor.drift import DriftWindow
from fraud_detection_tpu_torch.service import metrics

log = logging.getLogger("fraud_detection_tpu_torch.longhaul")


def merge_drift_windows(contributions: list, epoch: int):
    """Sum same-epoch per-host windows into one fleet window.

    ``contributions`` are ``scrape`` op results (dicts with ``host_id``,
    ``epoch`` and ``window``, a packed six-leaf list). Returns
    ``(DriftWindow | None, accepted_hosts, stale_hosts)``.
    """
    merged = None
    accepted: list[str] = []
    stale: list[str] = []
    for con in contributions:
        host = str(con.get("host_id", "?"))
        if int(con.get("epoch", -1)) != int(epoch):
            stale.append(host)
            metrics.longhaul_scrape_stale_epoch.labels(host).inc()
            log.warning(
                "longhaul scrape: dropping stale-epoch contribution "
                "from %s (theirs=%s fleet=%d)", host, con.get("epoch"), epoch,
            )
            continue
        accepted.append(host)
        if con.get("window") is None:
            continue
        win = DriftWindow(
            *(codec.unpack_array(d).astype(np.float32) for d in con["window"])
        )
        if merged is None:
            merged = win
        else:
            merged = DriftWindow(
                *(a + b for a, b in zip(merged.tensors(), win.tensors()))
            )
    return merged, accepted, stale


def merge_slo_status(contributions: list, epoch: int) -> dict:
    """Fleet ``/slo/status``: add same-epoch raw counts per SLO, derive burn
    and budget from the sums, refresh the fleet budget gauges."""
    agg: dict[str, dict] = {}
    for con in contributions:
        if int(con.get("epoch", -1)) != int(epoch):
            continue  # merge_drift_windows counted the stale contribution
        for name, d in (con.get("slo") or {}).items():
            a = agg.setdefault(
                name,
                {
                    "objective": float(d.get("objective", 0.0)),
                    "window_good": 0,
                    "window_bad": 0,
                    "total_good": 0,
                    "total_bad": 0,
                    "hosts": 0,
                },
            )
            a["window_good"] += int(d.get("window_good", 0))
            a["window_bad"] += int(d.get("window_bad", 0))
            a["total_good"] += int(d.get("total_good", 0))
            a["total_bad"] += int(d.get("total_bad", 0))
            a["hosts"] += 1
    for name, a in agg.items():
        total = a["window_good"] + a["window_bad"]
        err_budget = max(1.0 - a["objective"], 1e-9)
        bad_rate = (a["window_bad"] / total) if total else 0.0
        a["burn_rate"] = round(bad_rate / err_budget, 4)
        a["budget_remaining"] = round(1.0 - a["burn_rate"], 4)
        metrics.longhaul_fleet_budget_remaining.labels(name).set(a["budget_remaining"])
    return agg


def fleet_scrape(clients: list, epoch: int) -> dict:
    """One fleet scrape: ask every reachable host, merge with the epoch
    fence. ``clients`` expose ``call(op, args)`` (the front's
    :class:`~fraud_detection_tpu_torch.longhaul.front.HostHandle` or
    anything shaped like it). An unreachable host is skipped: a scrape never
    blocks the fleet on a dead peer."""
    contributions = []
    unreachable: list[str] = []
    for cl in clients:
        try:
            contributions.append(cl.call("scrape", {}))
        except (OSError, RuntimeError) as exc:
            unreachable.append(getattr(cl, "host_id", "?"))
            log.warning("longhaul scrape: %s unreachable: %s",
                        getattr(cl, "host_id", "?"), exc)
    window, accepted, stale = merge_drift_windows(contributions, epoch)
    slo = merge_slo_status(contributions, epoch)
    rows_seen = sum(
        int(c.get("rows_seen", 0))
        for c in contributions
        if int(c.get("epoch", -1)) == int(epoch)
    )
    return {
        "epoch": int(epoch),
        "window": window,
        "slo": slo,
        "rows_seen": rows_seen,
        "accepted": accepted,
        "stale": stale,
        "unreachable": unreachable,
    }
