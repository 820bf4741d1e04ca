"""The SLO engine: are the lanes inside their latency and availability
budget right now?

The JAX package's ``telemetry/slo.py`` on the port, host code, with the
same arithmetic (the multi-window, multi-burn-rate shape):

- each served series (the ``json``, ``msgpack`` and ``binary`` lanes;
  ``shard<N>`` for each shard of the serving mesh's front) carries two
  objectives from the ``SLO_*`` settings: availability (requests answered without a shed, an
  outage or an internal error) and latency (requests under
  ``SLO_LATENCY_P99_MS``);
- each series keeps good/bad counts in coarse time buckets (10 s) covering
  the largest window; the burn rate over a window (5m, 1h, 6h) is
  ``(bad/total) / (1 − objective)``. Recording is two integer adds under
  one lock; the rates are derived at scrape and status time only;
- exports ``slo_burn_rate{slo,window}``, ``slo_error_budget_remaining{slo}``
  (refreshed at the ``/metrics`` scrape and by ``GET /slo/status``) and
  ``slo_requests_total{slo,verdict}``, the inputs of
  ``monitoring/prometheus/rules/slo-alerts.yml``.

Bad for availability: admission sheds (429), outages (503) and internal
failures. Client input errors (422) never touch the SLO. A failed request
burns availability only, never latency.
"""

from __future__ import annotations

import threading
import time

from fraud_detection_tpu_torch import config
from fraud_detection_tpu_torch.service import metrics

#: the sliding windows burn rates derive over, seconds. The largest doubles
#: as the error-budget proxy window for ``slo_error_budget_remaining``.
DEFAULT_WINDOWS: dict[str, float] = {"5m": 300.0, "1h": 3600.0, "6h": 21600.0}

#: the ingest lanes every deployment declares objectives for.
LANES = ("json", "msgpack", "binary")

AVAILABILITY = "availability"
LATENCY = "latency"


class _Series:
    """One objective's sliding good/bad counters: a ring of coarse time
    buckets covering the largest window. O(1) record; rate derivation
    walks the ring (bounded, scrape-time only)."""

    __slots__ = ("objective", "bucket_s", "n", "t0", "head", "good", "bad",
                 "total_good", "total_bad")

    def __init__(self, objective: float, span_s: float, bucket_s: float):
        if not 0.0 < objective < 1.0:
            raise ValueError(f"objective must be in (0, 1), got {objective}")
        self.objective = objective
        self.bucket_s = bucket_s
        self.n = max(2, int(span_s / bucket_s) + 1)
        self.t0: float | None = None  # bucket index of self.head
        self.head = 0
        self.good = [0] * self.n
        self.bad = [0] * self.n
        self.total_good = 0
        self.total_bad = 0

    def _advance(self, now: float) -> None:
        idx = int(now / self.bucket_s)
        if self.t0 is None:
            self.t0 = idx
            return
        steps = idx - self.t0
        if steps <= 0:
            return
        for _ in range(min(steps, self.n)):
            self.head = (self.head + 1) % self.n
            self.good[self.head] = 0
            self.bad[self.head] = 0
        self.t0 = idx

    def record(self, good: bool, now: float) -> None:
        self._advance(now)
        if good:
            self.good[self.head] += 1
            self.total_good += 1
        else:
            self.bad[self.head] += 1
            self.total_bad += 1

    def window_counts(self, window_s: float, now: float) -> tuple[int, int]:
        """(good, bad) summed over the trailing ``window_s``."""
        self._advance(now)
        k = min(self.n, max(1, int(window_s / self.bucket_s)))
        g = b = 0
        for i in range(k):
            j = (self.head - i) % self.n
            g += self.good[j]
            b += self.bad[j]
        return g, b

    def burn_rate(self, window_s: float, now: float) -> float:
        g, b = self.window_counts(window_s, now)
        total = g + b
        if total == 0:
            return 0.0
        return (b / total) / (1.0 - self.objective)


class SLOEngine:
    """The declared objectives and their sliding counters. One engine per
    process (module-level :func:`engine`); tests construct their own with
    an injected clock and/or compressed windows."""

    def __init__(
        self,
        windows: dict[str, float] | None = None,
        bucket_s: float = 10.0,
        now_fn=time.monotonic,
        latency_threshold_s: float | None = None,
    ):
        self.windows = dict(windows or DEFAULT_WINDOWS)
        self.longest = max(self.windows, key=self.windows.get)
        self.bucket_s = bucket_s
        self.now_fn = now_fn
        self.latency_threshold_s = (
            latency_threshold_s
            if latency_threshold_s is not None
            else config.slo_latency_threshold_s()
        )
        self._series: dict[str, _Series] = {}
        self._lock = threading.Lock()
        self._counters: dict[tuple[str, str], object] = {}

    # -- declaration --------------------------------------------------------
    def _slo_name(self, kind: str, series: str) -> str:
        return f"{kind}:{series}"

    def _get_series(self, kind: str, series: str) -> _Series:
        name = self._slo_name(kind, series)
        s = self._series.get(name)
        if s is None:
            objective = (
                config.slo_availability_objective(series)
                if kind == AVAILABILITY
                else config.slo_latency_objective(series)
            )
            span = max(self.windows.values())
            s = _Series(objective, span, self.bucket_s)
            self._series[name] = s
        return s

    def declare_lanes(self, lanes=LANES) -> None:
        """Materialize the lane objectives up front so their gauge series
        exist (at 0 burn) from the first scrape, not the first error."""
        with self._lock:
            for lane in lanes:
                self._get_series(AVAILABILITY, lane)
                self._get_series(LATENCY, lane)

    def declare_shards(self, n: int) -> None:
        with self._lock:
            for i in range(n):
                self._get_series(AVAILABILITY, f"shard{i}")
                self._get_series(LATENCY, f"shard{i}")

    # -- recording ----------------------------------------------------------
    def _count(self, slo: str, verdict: str) -> None:
        key = (slo, verdict)
        c = self._counters.get(key)
        if c is None:
            c = self._counters[key] = metrics.slo_requests.labels(slo, verdict)
        c.inc()

    def record(
        self, series: str, ok: bool, duration_s: float | None = None
    ) -> None:
        """One request outcome for ``series`` (a lane name or
        ``shard<N>``): ``ok`` feeds the availability objective;
        ``duration_s`` (when the request completed) feeds the latency
        objective — a failed request burns availability budget only, so an
        outage cannot double-bill as slowness."""
        now = self.now_fn()
        with self._lock:
            self._get_series(AVAILABILITY, series).record(ok, now)
            if ok and duration_s is not None:
                fast = duration_s <= self.latency_threshold_s
                self._get_series(LATENCY, series).record(fast, now)
        self._count(self._slo_name(AVAILABILITY, series),
                    "good" if ok else "bad")
        if ok and duration_s is not None:
            self._count(self._slo_name(LATENCY, series),
                        "fast" if fast else "slow")

    # -- derivation / export ------------------------------------------------
    def snapshot(self) -> dict:
        """Per-SLO burn rates, budget remaining, objective, and totals —
        the ``/slo/status`` body and the gauge refresh source."""
        now = self.now_fn()
        out: dict = {}
        with self._lock:
            for name, s in self._series.items():
                burns = {
                    w: round(s.burn_rate(span, now), 4)
                    for w, span in self.windows.items()
                }
                g, b = s.window_counts(self.windows[self.longest], now)
                out[name] = {
                    "objective": s.objective,
                    "burn_rate": burns,
                    "budget_remaining": round(1.0 - burns[self.longest], 4),
                    "window_good": g,
                    "window_bad": b,
                    "total_good": s.total_good,
                    "total_bad": s.total_bad,
                }
        return out

    def export_gauges(self) -> dict:
        """Refresh ``slo_burn_rate{slo,window}`` and
        ``slo_error_budget_remaining{slo}`` from the live counters; returns
        the snapshot it exported (so ``/slo/status`` pays one derivation)."""
        snap = self.snapshot()
        for name, d in snap.items():
            for w, rate in d["burn_rate"].items():
                metrics.slo_burn_rate.labels(name, w).set(rate)
            metrics.slo_error_budget_remaining.labels(name).set(
                d["budget_remaining"]
            )
        return snap

    def fast_burn(self, series: str, kind: str = AVAILABILITY) -> bool:
        """The fast-burn page condition as the engine computes it (both
        short windows over SLO_FAST_BURN) — what the range's
        ``slo_burn_under_shed`` scenario and tests pin without a live
        Prometheus."""
        now = self.now_fn()
        threshold = config.slo_fast_burn()
        short = sorted(self.windows.items(), key=lambda kv: kv[1])[:2]
        with self._lock:
            s = self._series.get(self._slo_name(kind, series))
            if s is None:
                return False
            return all(
                s.burn_rate(span, now) > threshold for _, span in short
            )


_engine: SLOEngine | None = None
_engine_lock = threading.Lock()


def engine() -> SLOEngine | None:
    """The process-wide engine, or None when ``SLO_ENABLED=0``."""
    global _engine
    if not config.slo_enabled():
        return None
    if _engine is None:
        with _engine_lock:
            if _engine is None:
                _engine = SLOEngine()
    return _engine


def record_lane(lane: str, ok: bool, duration_s: float | None = None) -> None:
    """Module-level convenience for the ingest edges (None-safe, one
    attribute load when disabled)."""
    e = engine()
    if e is not None:
        e.record(lane, ok, duration_s)


def record_shard(
    shard_id: int, ok: bool, duration_s: float | None = None
) -> None:
    e = engine()
    if e is not None:
        e.record(f"shard{shard_id}", ok, duration_s)


def _reset_for_tests() -> None:
    global _engine
    with _engine_lock:
        _engine = None
