"""The watchtower coordinator: drift, shadow, thresholds and the retrain
trigger behind ``/monitor/status``.

One instance per serving process. It loads the baseline profile beside the
served model, owns the :class:`DriftMonitor` (whose window the fused flush
folds on the device) and, when a challenger is registered at
``models:/{name}@shadow``, a :class:`~.shadow.ShadowScorer`. It evaluates
the thresholds into a status (``warming`` below ``WATCHTOWER_MIN_ROWS``,
else ``ok`` or ``drift``), a recommendation (``none``, ``retrain``,
``promote_challenger`` or ``rollback_challenger``) and the Prometheus
gauges. With ``WATCHTOWER_RETRAIN_TRIGGER=1`` a drift episode enqueues one
``watchtower.trigger_retrain`` task (:data:`RETRAIN_TASK`) through the
``retrain_sender``; with ``CONDUCTOR_AUTO_PROMOTE=1`` a ``promote_challenger``
or ``rollback_challenger`` recommendation enqueues one of the conductor's
tasks through the ``action_sender``, latched once an episode. A hot swap
rebinds the monitor to the promoted champion (:meth:`Watchtower.
rebind_champion`, with its ledger table) and the challenger to the new
``@shadow`` (:meth:`Watchtower.rebind_challenger`).

:meth:`Watchtower.observe` hands each scored batch to one ingest thread
(bounded backlog, drop-and-count), so monitoring never blocks a request:
on the split path it folds the drift window there, and the shadow
challenger re-scores a sample of batches there (its ``fused_score`` or
forest launches, off the request path); ``/monitor/feedback`` hands
labeled rows to the same thread, which folds them into the calibration
window only. With a ledger-widened model, :func:`build_watchtower` binds
its table to the drift monitor (the flush updates it) and the status body's
``ledger`` reads the table's occupancy, collisions and evictions, exported
as the ``ledger_*`` series.
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
from fraud_detection_tpu_torch.monitor.shadow import ShadowScorer
from fraud_detection_tpu_torch.service import metrics
from fraud_detection_tpu_torch.utils import lockdep

log = logging.getLogger("fraud_detection_tpu_torch.watchtower")

RETRAIN_TASK = "watchtower.trigger_retrain"

RECOMMENDATIONS = (
    "none", "retrain", "promote_challenger", "rollback_challenger"
)


def _challenger_explainer(challenger):
    """The challenger's attribution callable ``phi(rows) -> (n, d)`` for
    the shadow's reason-code comparison: its own ``explain_batch`` (linear
    SHAP, or the forest's TreeSHAP on the ``tree_shap`` kernel), run on the
    watchtower's ingest thread. None when it has no ``explain_batch``."""
    import numpy as np

    if not hasattr(challenger, "explain_batch"):
        return None

    def phi(rows):
        return np.asarray(
            challenger.explain_batch(np.asarray(rows, np.float32))[0], np.float64
        )

    return phi


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


def _recommend(
    warming: bool, flags: dict, shadow: dict | None, thr: Thresholds
) -> str:
    """The recommendation from the drift flags and the shadow window."""
    if warming:
        return "none"
    drifting = any(flags.values())
    shadow_ready = shadow is not None and shadow["window_rows"] >= thr.min_rows
    if drifting:
        if shadow_ready and flags.get("score_psi") and shadow["score_psi"] <= thr.psi:
            return "promote_challenger"
        return "retrain"
    if shadow_ready and shadow["disagreement"] > thr.disagree:
        return "rollback_challenger"
    return "none"


class Watchtower:
    def __init__(
        self,
        profile: BaselineProfile,
        challenger=None,
        challenger_source: str | None = None,
        thresholds: Thresholds | None = None,
        sample_rate: float | None = None,
        halflife_rows: float | None = None,
        retrain_sender=None,
        action_sender=None,
        max_backlog: int = 32,
        device=None,
        mesh=None,
    ):
        self.thresholds = thresholds or Thresholds.from_config()
        self._sample_rate = sample_rate
        self._halflife_rows = halflife_rows
        self._device = device
        # the serving mesh (parallel/mesh.Mesh): the drift window and the
        # ledger table then carry a shard axis (mesh/shardflush)
        self._mesh = mesh
        self.drift = self._make_drift(profile)
        self.shadow = (
            ShadowScorer(
                challenger.scorer, profile, sample_rate=sample_rate,
                halflife_rows=halflife_rows,
                explainer=_challenger_explainer(challenger),
            )
            if challenger is not None else None
        )
        self.challenger_source = challenger_source
        # retrain_sender(reason) enqueues RETRAIN_TASK, once a drift episode
        self._retrain_sender = retrain_sender
        # action_sender(task_name, reason) enqueues the conductor's promote
        # or rollback task under CONDUCTOR_AUTO_PROMOTE=1, latched once a
        # recommendation episode like the retrain trigger
        self._action_sender = action_sender
        self._retrain_latched = False
        self._action_latched: str | None = None
        # the table counts cumulative totals; a scrape advances the
        # Counters by the delta since the last one
        self._ledger_counts = {"hash_collisions": 0.0, "evictions": 0.0}
        # a scrape and a /monitor/status call may evaluate status() at once:
        # the latch's check and set must be atomic
        self._retrain_lock = lockdep.lock("watchtower.retrain")
        self._queue: queue.Queue = queue.Queue(maxsize=max_backlog)
        self._stop = False
        self._thread = threading.Thread(
            target=self._ingest_loop, name="watchtower-ingest", daemon=True
        )
        self._thread.start()

    def _make_drift(self, profile) -> DriftMonitor:
        """A drift monitor over ``profile``: the serving mesh's
        ``MeshDriftMonitor`` when the watchtower was built with one (so a
        hot swap's rebind keeps the shards), else the single-window one."""
        if self._mesh is not None:
            from fraud_detection_tpu_torch.mesh.shardflush import MeshDriftMonitor

            return MeshDriftMonitor(profile, self._mesh, halflife_rows=self._halflife_rows)
        return DriftMonitor(
            profile, halflife_rows=self._halflife_rows, device=self._device
        )

    def wants_rows(self) -> bool:
        """True when a fused flush (drift already folded) must still hand
        over its rows: a shadow challenger is bound."""
        return self.shadow is not None

    def observe(
        self, rows, scores, labels=None, calibration_only=False,
        drift_done=False, reasons=None,
    ) -> bool:
        """Queue one scored batch for monitoring. Non-blocking; returns
        False when the backlog bound forced a drop (counted).

        ``labels`` carries delayed fraud labels (``/monitor/feedback``):
        labeled rows fold into the calibration window. With
        ``calibration_only`` (a feedback replay: the rows were already
        observed live) they update only the calibration state, never the
        drift histograms. With ``drift_done`` (the fused path: the window
        already folded in the flush) the batch is only counted and, with a
        shadow bound, re-scored by the challenger on a sample. ``reasons``
        is the champion's serve-time top-k indices for the shadow's
        reason-divergence window."""
        try:
            self._queue.put_nowait(
                (rows, scores, labels, calibration_only, drift_done, reasons)
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
                (rows, scores, labels, calibration_only, drift_done,
                 reasons) = item
                if not drift_done:
                    self.drift.update(
                        rows, scores, labels, calibration_only=calibration_only
                    )
                metrics.watchtower_batches_observed.inc()
                if (
                    self.shadow is not None
                    and rows is not None
                    and not calibration_only
                    and self.shadow.maybe_observe(rows, scores, reasons)
                ):
                    metrics.watchtower_shadow_batches.inc()
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
        sh = self.shadow.stats() if self.shadow is not None else None
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
        recommendation = _recommend(warming, flags, sh, thr)
        self._maybe_trigger_retrain(recommendation, d)
        self._maybe_send_action(recommendation, d, sh)
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
        if sh is not None:
            # the same warm-up suppression as the drift gauges
            shadow_warm = sh["window_rows"] >= thr.min_rows
            metrics.watchtower_shadow_disagreement.set(
                sh["disagreement"] if shadow_warm else 0.0
            )
            metrics.watchtower_shadow_score_psi.set(
                sh["score_psi"] if shadow_warm else 0.0
            )
            rd = sh["reason_divergence"]
            metrics.watchtower_shadow_reason_divergence.set(
                rd if rd is not None and shadow_warm else 0.0
            )
        return {
            "enabled": True,
            "status": "warming" if warming else ("drift" if drifting else "ok"),
            "recommendation": recommendation,
            "flags": flags,
            "drift": d,
            "shadow": sh,
            "ledger": self._refresh_ledger_metrics(),
            "challenger_source": self.challenger_source,
            "thresholds": {
                "psi": thr.psi,
                "ks": thr.ks,
                "ece": thr.ece,
                "disagree": thr.disagree,
                "min_rows": thr.min_rows,
            },
        }

    def _refresh_ledger_metrics(self) -> dict | None:
        """Export the table's telemetry: the occupancy gauge, and the
        collision and eviction Counters advanced by the table totals' delta
        since the last scrape. None when no ledger is bound."""
        stats = self.drift.ledger_stats()
        if stats is None:
            metrics.ledger_active.set(0)
            return None
        metrics.ledger_active.set(1)
        metrics.ledger_slot_occupancy.set(stats["slot_occupancy"])
        for key, counter in (
            ("hash_collisions", metrics.ledger_hash_collisions),
            ("evictions", metrics.ledger_evictions),
        ):
            delta = stats[key] - self._ledger_counts[key]
            if delta > 0:
                counter.inc(delta)
            # a negative delta: a rebound table, the baseline restarts
            self._ledger_counts[key] = stats[key]
        return stats

    def _maybe_trigger_retrain(self, recommendation: str, d: dict) -> None:
        """One ``RETRAIN_TASK`` a drift episode: latched until the
        recommendation leaves ``retrain``; a failed send re-arms."""
        with self._retrain_lock:
            if recommendation != "retrain":
                self._retrain_latched = False  # episode over; re-arm
                return
            if self._retrain_latched or self._retrain_sender is None:
                return
            if not config.watchtower_retrain_trigger():
                return
            self._retrain_latched = True  # before the send: a racing
            # status() must not enqueue twice while the broker call runs
            try:
                self._retrain_sender(
                    f"drift detected: "
                    f"feature_psi_max={d['feature_psi_max']:.4f} "
                    f"score_psi={d['score_psi']:.4f} ece={d['ece']:.4f}"
                )
                metrics.watchtower_retrain_triggers.inc()
                log.warning("watchtower fired retrain trigger task %s", RETRAIN_TASK)
            except Exception as e:
                self._retrain_latched = False  # retry on the next evaluation
                log.error("retrain trigger enqueue failed: %s", e)

    def _maybe_send_action(
        self, recommendation: str, d: dict, sh: dict | None
    ) -> None:
        """Enqueue the conductor's promote/rollback task for this episode
        (the ``CONDUCTOR_AUTO_PROMOTE`` opt-in). Latched on the
        recommendation's value: one task an episode, re-armed when the
        recommendation changes; a failed send re-arms."""
        if recommendation not in ("promote_challenger", "rollback_challenger"):
            with self._retrain_lock:
                self._action_latched = None  # episode over; re-arm
            return
        if self._action_sender is None or not config.conductor_auto_promote():
            return
        with self._retrain_lock:
            if self._action_latched == recommendation:
                return
            self._action_latched = recommendation
        from fraud_detection_tpu_torch.lifecycle.conductor import (
            PROMOTE_TASK,
            ROLLBACK_TASK,
        )

        task = PROMOTE_TASK if recommendation == "promote_challenger" else ROLLBACK_TASK
        reason = (
            f"watchtower {recommendation}: score_psi={d['score_psi']:.4f} "
            f"shadow_psi={(sh or {}).get('score_psi', float('nan')):.4f} "
            f"disagreement={(sh or {}).get('disagreement', float('nan')):.4f}"
        )
        try:
            self._action_sender(task, reason)
            log.warning("watchtower enqueued conductor task %s", task)
        except Exception as e:
            with self._retrain_lock:
                self._action_latched = None  # retry on the next evaluation
            log.error("conductor action enqueue failed: %s", e)

    # -- the hot swap (driven by lifecycle.ModelReloader) -------------------
    def rebind_champion(self, profile, ledger=None) -> None:
        """A promotion went live: point drift monitoring at the NEW
        champion's baseline profile with a fresh window (the old window's
        evidence was gathered against the old baseline). Without a profile
        the old baseline keeps serving: stale monitoring beats none.

        ``ledger`` is the promoted artifact's ``(LedgerSpec, state)`` pair
        when the new champion is ledger-widened: the entity table rebinds
        WITH the model (its weights were trained against the replayed
        history that snapshot ends on), bound before the new monitor is
        published, so a flush that reads the monitor finds the table on
        it; the collision/eviction counter baselines restart."""
        if profile is None:
            log.warning(
                "promoted model has no baseline profile — drift window "
                "keeps the previous baseline"
            )
        drift = self.drift if profile is None else self._make_drift(profile)
        if ledger is not None:
            drift.bind_ledger(*ledger)
            log.warning(
                "ledger rebound with the promoted champion "
                "(%d slots, halflife %.0fs)", ledger[0].slots, ledger[0].halflife_s,
            )
        if ledger is not None or profile is not None:
            self._ledger_counts = {"hash_collisions": 0.0, "evictions": 0.0}
        if profile is None:
            return
        self.drift = drift
        if self.shadow is not None:
            # the old challenger IS usually the new champion: comparing a
            # model with itself reads as perfect agreement. The reloader
            # rebinds or clears it right after through the @shadow sweep
            self.shadow = None
            self.challenger_source = None
        log.warning("watchtower rebound to the promoted champion's baseline")

    def rebind_challenger(self, challenger, source: str | None) -> None:
        """The ``@shadow`` alias changed: swap the challenger scorer (fresh
        shadow window), or drop shadow scoring when the alias went away."""
        if challenger is None:
            self.shadow = None
            self.challenger_source = None
            log.info("shadow challenger unbound")
            return
        explainer = _challenger_explainer(challenger)
        if self.shadow is None:
            self.shadow = ShadowScorer(
                challenger.scorer, self.drift.profile,
                sample_rate=self._sample_rate, halflife_rows=self._halflife_rows,
                explainer=explainer,
            )
        else:
            self.shadow.swap_scorer(challenger.scorer, explainer=explainer)
        self.challenger_source = source
        log.warning("shadow challenger rebound to %s", source)

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


def build_watchtower(model, model_source: str, device=None, retrain_sender=None,
                     action_sender=None, mesh=None):
    """Serving-side factory: the watchtower over the ``monitor_profile.npz``
    beside the served model (:func:`resolve_profile_dir`), or None when
    ``WATCHTOWER_ENABLED=0``, when there is no profile (logged at WARNING
    under ``WATCHTOWER_ENABLED=1``, else at INFO) or when it does not match
    the model's features. The shadow challenger is the registry's
    ``@shadow`` model (``service.loading.load_shadow_model``), on the same
    device, when its wire schema (the base feature names) matches the
    champion's: a widened challenger shadows a narrow champion through its
    null path. ``mesh`` (the serving mesh) shards the drift window and the
    ledger table over its shards (``mesh/shardflush``)."""
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
    device = device if device is not None else model.device
    challenger = challenger_source = None
    try:
        from fraud_detection_tpu_torch.service.loading import load_shadow_model

        resolved = load_shadow_model(device=device)
        if resolved is not None:
            challenger, challenger_source = resolved
            if list(getattr(challenger, "base_feature_names",
                            challenger.feature_names)) != list(
                getattr(model, "base_feature_names", model.feature_names)
            ):
                # caught once here; in the ingest loop it would fail on
                # every sampled batch while the stats never accumulate
                log.warning(
                    "shadow challenger %s feature schema does not match the "
                    "champion — monitoring without it", challenger_source,
                )
                challenger = challenger_source = None
    except Exception as e:
        log.warning("shadow model load failed (%s); monitoring without one", e)
    wt = Watchtower(
        profile, challenger=challenger, challenger_source=challenger_source,
        retrain_sender=retrain_sender, action_sender=action_sender, device=device,
        mesh=mesh,
    )
    spec = getattr(model, "ledger_spec", None)
    if spec is not None:
        # a widened family: the flush runs the ledger program from the
        # first batch, over the table stamped beside the weights
        wt.drift.bind_ledger(spec, getattr(model, "ledger_state", None))
        metrics.ledger_active.set(1)
        log.info(
            "ledger bound: %d slots, halflife %.0fs, %d base + %d velocity features",
            spec.slots, spec.halflife_s, spec.n_base, spec.n_features - spec.n_base,
        )
    log.info("watchtower active: baseline over %d rows, challenger=%s",
             profile.n_rows, challenger_source or "none")
    return wt

