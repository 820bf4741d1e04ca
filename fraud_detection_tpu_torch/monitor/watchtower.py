"""The watchtower coordinator, lean: drift thresholds and ``/monitor/status``.

One instance per serving process. It loads the baseline profile beside the
served model, owns the :class:`DriftMonitor` (whose window the fused flush
folds on the device) and evaluates the thresholds into a status
(``warming`` below ``WATCHTOWER_MIN_ROWS``, else ``ok`` or ``drift``), a
recommendation (``none`` or ``retrain``) and the Prometheus gauges.

On the split flush path :meth:`Watchtower.observe` hands each scored batch
to one ingest thread (bounded backlog, drop-and-count), so monitoring never
blocks a request; ``/monitor/feedback`` hands labeled rows to the same
thread, which folds them into the calibration window only. Shadow scoring
and the retrain trigger task are not ported yet: ``shadow`` and ``ledger``
read ``None`` in the status body.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
import time
from dataclasses import dataclass

from fraud_detection_tpu_torch import config
from fraud_detection_tpu_torch.monitor.baseline import BaselineProfile, load_profile
from fraud_detection_tpu_torch.monitor.drift import DriftMonitor
from fraud_detection_tpu_torch.service import metrics

log = logging.getLogger("fraud_detection_tpu_torch.watchtower")

RECOMMENDATIONS = (
    "none", "retrain", "promote_challenger", "rollback_challenger"
)


@dataclass(frozen=True)
class Thresholds:
    """Drift thresholds: the reference's defaults (PSI 0.2, KS 0.15, ECE
    0.1, challenger disagreement 0.05, 512 rows); :meth:`from_config` reads
    ``WATCHTOWER_{PSI,KS,ECE,DISAGREE}_THRESHOLD`` and
    ``WATCHTOWER_MIN_ROWS``."""

    psi: float = 0.2
    ks: float = 0.15
    ece: float = 0.1
    disagree: float = 0.05
    min_rows: int = 512

    @classmethod
    def from_config(cls) -> "Thresholds":
        return cls(
            psi=config.watchtower_psi_threshold(),
            ks=config.watchtower_ks_threshold(),
            ece=config.watchtower_ece_threshold(),
            disagree=config.watchtower_disagree_threshold(),
            min_rows=config.watchtower_min_rows(),
        )


class Watchtower:
    def __init__(
        self,
        profile: BaselineProfile,
        thresholds: Thresholds | None = None,
        halflife_rows: float | None = None,
        max_backlog: int = 32,
        device=None,
    ):
        self.thresholds = thresholds or Thresholds.from_config()
        self.drift = DriftMonitor(profile, halflife_rows=halflife_rows, device=device)
        self._queue: queue.Queue = queue.Queue(maxsize=max_backlog)
        self._stop = False
        self._thread = threading.Thread(
            target=self._ingest_loop, name="watchtower-ingest", daemon=True
        )
        self._thread.start()

    def observe(
        self, rows, scores, labels=None, calibration_only=False,
        drift_done=False,
    ) -> bool:
        """Queue one scored batch for monitoring. Non-blocking; returns
        False when the backlog bound forced a drop (counted).

        ``labels`` carries delayed fraud labels (``/monitor/feedback``):
        labeled rows fold into the calibration window. With
        ``calibration_only`` (a feedback replay: the rows were already
        observed live) they update only the calibration state, never the
        drift histograms. With ``drift_done`` (the fused path: the window
        already folded in the flush) the batch is only counted."""
        try:
            self._queue.put_nowait(
                (rows, scores, labels, calibration_only, drift_done)
            )
        except queue.Full:
            metrics.watchtower_batches_dropped.inc()
            return False
        return True

    def _ingest_loop(self) -> None:
        while True:
            item = self._queue.get()
            try:
                if item is None or self._stop:
                    return
                rows, scores, labels, calibration_only, drift_done = item
                if not drift_done:
                    self.drift.update(
                        rows, scores, labels, calibration_only=calibration_only
                    )
                metrics.watchtower_batches_observed.inc()
            except Exception:
                log.warning("watchtower ingest failed", exc_info=True)
            finally:
                self._queue.task_done()

    def drain(self, timeout: float = 5.0) -> bool:
        """Wait for queued batches to finish ingesting (tests/shutdown)."""
        deadline = time.monotonic() + timeout
        while self._queue.unfinished_tasks:
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.002)
        return True

    def status(self) -> dict:
        """Threshold evaluation + gauge refresh + recommendation (a small
        host sync; /monitor/status and scrapes, never per batch)."""
        thr = self.thresholds
        d = self.drift.stats()
        warming = d["window_rows"] < thr.min_rows
        flags = {
            "feature_psi": d["feature_psi_max"] > thr.psi,
            "feature_ks": d["feature_ks_max"] > thr.ks,
            "score_psi": d["score_psi"] > thr.psi,
            "score_ks": d["score_ks"] > thr.ks,
            "calibration": d["n_labeled"] >= thr.min_rows
            and d["ece"] > thr.ece,
        }
        if warming:
            flags = {k: False for k in flags}
        drifting = any(flags.values())
        recommendation = "retrain" if drifting else "none"
        # a warming window's stats are empty-histogram smoothing noise: the
        # gauges read 0 until min_rows so fresh deploys don't page
        g = dict.fromkeys(
            ("feature_psi_max", "feature_ks_max", "score_psi", "score_ks"),
            0.0,
        ) if warming else d
        metrics.watchtower_feature_psi_max.set(g["feature_psi_max"])
        metrics.watchtower_feature_ks_max.set(g["feature_ks_max"])
        metrics.watchtower_score_psi.set(g["score_psi"])
        metrics.watchtower_score_ks.set(g["score_ks"])
        metrics.watchtower_ece.set(
            d["ece"] if d["n_labeled"] >= thr.min_rows else 0.0
        )
        metrics.watchtower_window_rows.set(d["window_rows"])
        metrics.watchtower_drift_detected.set(1 if drifting else 0)
        for action in RECOMMENDATIONS:
            metrics.watchtower_recommendation.labels(action).set(
                1 if action == recommendation else 0
            )
        return {
            "enabled": True,
            "status": "warming" if warming else ("drift" if drifting else "ok"),
            "recommendation": recommendation,
            "flags": flags,
            "drift": d,
            "shadow": None,
            "ledger": None,
            "challenger_source": None,
            "thresholds": {
                "psi": thr.psi,
                "ks": thr.ks,
                "ece": thr.ece,
                "disagree": thr.disagree,
                "min_rows": thr.min_rows,
            },
        }

    def close(self) -> None:
        """Stop the ingest thread; still-queued batches are discarded."""
        self._stop = True
        try:
            self._queue.put_nowait(None)  # wake the blocked get()
        except queue.Full:
            pass  # the thread sees _stop on its next dequeue
        self._thread.join(timeout=5.0)


def resolve_profile_dir(model_source: str) -> str | None:
    """The artifact directory that may hold ``monitor_profile.npz`` for a
    ``load_production_model`` source: the registry version's, the native
    directory, or the joblib file's directory."""
    kind, _, rest = model_source.partition(":")
    if kind == "registry":
        from fraud_detection_tpu_torch.tracking import TrackingClient

        try:
            return TrackingClient().registry.resolve(rest)
        except (FileNotFoundError, ValueError) as e:
            log.debug("profile dir resolution failed for %s: %s", rest, e)
            return None
    if kind == "native":
        return rest
    if kind == "joblib":
        return os.path.dirname(rest) or "."
    return None


def build_watchtower(model, model_source: str, device=None):
    """Serving-side factory: the watchtower over the ``monitor_profile.npz``
    beside the served model (:func:`resolve_profile_dir`), or None when
    ``WATCHTOWER_ENABLED=0``, when there is no profile (logged at WARNING
    under ``WATCHTOWER_ENABLED=1``, else at INFO) or when it does not match
    the model's features."""
    enabled = config.watchtower_enabled()
    if enabled is False:
        return None
    profile_dir = resolve_profile_dir(model_source)
    profile = load_profile(profile_dir) if profile_dir else None
    if profile is None:
        log.log(
            logging.WARNING if enabled else logging.INFO,
            "no monitor_profile.npz beside model (%s) — serving unmonitored",
            model_source,
        )
        return None
    if list(profile.feature_names) != list(model.feature_names):
        log.warning(
            "baseline profile feature names do not match the served model — "
            "serving unmonitored (stale profile beside a newer model?)"
        )
        return None
    wt = Watchtower(profile, device=device if device is not None else model.device)
    log.info("watchtower active: baseline over %d rows", profile.n_rows)
    return wt

