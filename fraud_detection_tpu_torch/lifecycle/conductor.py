"""The conductor: closes the watchtower loop end to end.

The port's copy of the JAX package's ``lifecycle/conductor.py``. The
watchtower detects drift and *recommends* — ``retrain`` /
``promote_challenger`` / ``rollback_challenger``. The conductor acts on the
recommendations through an idempotent, crash-resumable state machine
persisted in the lifecycle store::

    idle ──(retrain task)──▶ retraining ──gate pass──▶ gated ──@shadow──▶ shadowing
      ▲                          │                                          │
      │                      gate fail                           promote /  │ rollback
      │                          ▼                                          ▼
      └─(new episode)─ rolled_back ◀─ rolling_back ◀─ promoting ──alias──▶ done
                                           ▲              (rollback)          │
                                           └──────────────────────────────────┘

Every transition is a compare-and-set on the persisted row
(:meth:`LifecycleStore.transition`, a single guarded UPDATE), with the
*intent* (challenger version, prior champion version, rollback target)
written BEFORE the side effect (the registry alias flip). A worker killed
mid-step resumes via :meth:`Conductor.resume`:

- ``retraining``   → the fit left no partial registry state. The row
                     carries its owner and a heartbeat (``updated_at``,
                     refreshed every ``stale_after/3`` s while the fit
                     runs); resume re-runs the episode ONLY after an
                     atomic stale-steal succeeds, so a second worker
                     starting mid-retrain cannot hijack a live episode;
- ``gated``        → challenger registered but ``@shadow`` possibly not
                     set: re-set the alias (idempotent) and move on;
- ``promoting``    → the alias either moved or did not: setting it to the
                     recorded target again is a no-op if it did —
                     promotion never double-applies or skips a model;
- ``rolling_back`` → the rollback intent is persisted but the alias
                     restore possibly unapplied: re-apply (idempotent)
                     and finalize to ``rolled_back``.

The named :func:`~fraud_detection_tpu_torch.range.faults.fire` points
(``conductor.gated.pre_alias``, ``conductor.promoting.pre_alias`` /
``.mid_alias`` / ``.pre_finalize``, ``conductor.rolling_back.pre_alias``)
let a drill kill the process between those steps.

The CAS also carries the retrain latch across processes: a second
``trigger_retrain`` task landing while an episode is in flight loses the
``idle → retraining`` transition and is dropped.

The retrain runs on the conductor's device (the card unless ``DEVICE=cpu``
or ``device=`` asks for the CPU): SMOTE's k-NN through ``knn_topk``, the
gate's scoring through ``fused_score``.
"""

from __future__ import annotations

import logging
import os
import socket
import threading
import time
import uuid

from fraud_detection_tpu_torch import config
from fraud_detection_tpu_torch.device import resolve_device
from fraud_detection_tpu_torch.lifecycle import store as st
from fraud_detection_tpu_torch.lifecycle.retrain import RetrainResult, run_retrain
from fraud_detection_tpu_torch.lifecycle.store import LifecycleStore
from fraud_detection_tpu_torch.range.faults import fire
from fraud_detection_tpu_torch.service import metrics

log = logging.getLogger("fraud_detection_tpu_torch.lifecycle")

# Task names the worker dispatches to the conductor (the watchtower's retrain
# task is monitor/watchtower.py's RETRAIN_TASK).
PROMOTE_TASK = "lifecycle.promote_challenger"
ROLLBACK_TASK = "lifecycle.rollback_challenger"
FEEDBACK_TASK = "lifecycle.record_feedback"

# Episode states that must not be interrupted by a new retrain.
_BUSY = (st.RETRAINING, st.GATED, st.PROMOTING, st.ROLLING_BACK)
_RESTARTABLE = (st.IDLE, st.DONE, st.ROLLED_BACK, st.SHADOWING)


class Conductor:
    def __init__(
        self,
        store: LifecycleStore | None = None,
        tracking_client=None,
        model_name: str | None = None,
        retrain_kwargs: dict | None = None,
        on_promote=None,
        device=None,
    ):
        from fraud_detection_tpu_torch.tracking import TrackingClient

        # the champion loads and the retrain runs here: the card unless the
        # caller (or DEVICE=cpu) asks for the CPU
        self.device = resolve_device(device)
        self.store = store or st.open_lifecycle_store()
        self.client = tracking_client or TrackingClient()
        self.name = model_name or config.model_name()
        self.retrain_kwargs = dict(retrain_kwargs or {})
        # serving-side hook: called with the promoted version after an alias
        # flip so the hosting process can hot-reload its own model
        self.on_promote = on_promote
        # episode ownership: stamped on the RETRAINING row so resume() can
        # tell a crashed worker's episode from a live one (the uuid suffix
        # makes a restarted pod with the same host:pid a new owner)
        self.owner = f"{socket.gethostname()}:{os.getpid()}:{uuid.uuid4().hex[:8]}"

    # -- helpers -----------------------------------------------------------
    @property
    def registry(self):
        return self.client.registry

    def _champion_version(self) -> int | None:
        return self.registry.get_version_by_alias(
            self.name, config.model_stage()
        )

    def _shadow_version(self) -> int | None:
        return self.registry.get_version_by_alias(
            self.name, config.shadow_stage()
        )

    def _load_champion(self):
        from fraud_detection_tpu_torch.models import load_any_model

        uri = f"models:/{self.name}@{config.model_stage()}"
        return load_any_model(self.registry.resolve(uri), device=self.device)

    def _export_state(self, state: str) -> None:
        for s in st.STATES:
            metrics.lifecycle_state.labels(s).set(1 if s == state else 0)
        counts = self.store.feedback_counts()
        metrics.lifecycle_feedback_rows.labels("window").set(counts["window"])
        metrics.lifecycle_feedback_rows.labels("reservoir").set(
            counts["reservoir"]
        )

    def status(self) -> dict:
        s = self.store.get_state(self.name)
        s["feedback"] = self.store.feedback_counts()
        s["shadow_version"] = self._shadow_version()
        s["prod_version"] = self._champion_version()
        return s

    # -- feedback ingest (the worker-side durable path) --------------------
    def record_feedback(self, features, scores, labels) -> int:
        n = self.store.add_feedback(features, scores, labels)
        counts = self.store.feedback_counts()
        metrics.lifecycle_feedback_rows.labels("window").set(counts["window"])
        metrics.lifecycle_feedback_rows.labels("reservoir").set(
            counts["reservoir"]
        )
        return n

    # -- retrain episode ---------------------------------------------------
    def _heartbeat_loop(self, stop: threading.Event) -> None:
        # first beat immediately: the CAS stamped host time, this restamps
        # with the database's clock before any staleness math can run
        interval = max(1.0, config.lifecycle_retrain_stale_after() / 3.0)
        while True:
            try:
                self.store.heartbeat(self.name, self.owner)
            except Exception:
                log.debug("lifecycle heartbeat failed", exc_info=True)
            if stop.wait(interval):
                return

    def handle_retrain(self, reason: str = "") -> dict:
        """The ``watchtower.trigger_retrain`` task body: CAS-latch, fit,
        gate, register at ``@shadow``. Returns a summary dict (logged by the
        worker; also the test surface)."""
        if not self.store.transition(
            self.name, _RESTARTABLE, st.RETRAINING,
            reason=reason, owner=self.owner,
        ):
            # another worker owns the episode — the cross-process latch
            state = self.store.get_state(self.name)["state"]
            log.warning(
                "retrain request dropped: episode already %s", state
            )
            metrics.lifecycle_retrains.labels("skipped").inc()
            return {"outcome": "skipped", "state": state}
        self._export_state(st.RETRAINING)
        # heartbeat for the whole fit: keeps the episode provably live so a
        # concurrently starting worker's resume() can't stale-steal it
        stop_beat = threading.Event()
        beat = threading.Thread(
            target=self._heartbeat_loop, args=(stop_beat,),
            name="lifecycle-heartbeat", daemon=True,
        )
        beat.start()
        t0 = time.time()
        try:
            try:
                champion_version = self._champion_version()
                champion = self._load_champion()
            except (FileNotFoundError, ValueError) as e:
                self._fail_retrain(f"no champion to retrain from: {e}")
                log.error("retrain aborted — no champion resolvable: %s", e)
                return {"outcome": "failed", "error": str(e)}
            try:
                result = run_retrain(
                    self.store,
                    champion,
                    champion_version,
                    reason=reason,
                    tracking_client=self.client,
                    **{"device": self.device, **self.retrain_kwargs},
                )
            except Exception as e:
                self._fail_retrain(f"retrain failed: {e}")
                log.exception("conductor retrain failed")
                return {"outcome": "failed", "error": str(e)}
            finally:
                metrics.lifecycle_retrain_duration.observe(time.time() - t0)
            return self._finish_retrain(result)
        finally:
            stop_beat.set()

    def _fail_retrain(self, reason: str, metric: str = "failed", **fields) -> None:
        """Terminal-failure leg of an owned episode (fit error or gate
        rejection): roll the row back only if we still own it — a
        stale-stolen episode belongs to its new owner, and exporting/rolling
        OUR failure onto THEIR live state would report a rollback that never
        happened."""
        if self.store.transition(
            self.name, (st.RETRAINING,), st.ROLLED_BACK,
            owner_guard=self.owner, owner=None, reason=reason, **fields,
        ):
            self._export_state(st.ROLLED_BACK)
            metrics.lifecycle_retrains.labels(metric).inc()
        else:
            metrics.lifecycle_retrains.labels("lost_ownership").inc()
            log.error(
                "retrain episode ownership lost before failure rollback "
                "(state now %s) — leaving the new owner's episode alone",
                self.store.get_state(self.name)["state"],
            )

    def _finish_retrain(self, result: RetrainResult) -> dict:
        if not result.gate.passed:
            self._fail_retrain(
                "gate failed: " + "; ".join(result.gate.reasons),
                metric="gate_failed",
                gate=result.gate.to_json(),
                champion_version=result.champion_version,
                challenger_version=None,  # nothing registered this episode
            )
            log.warning(
                "challenger rejected by gate: %s", "; ".join(result.gate.reasons)
            )
            return {"outcome": "gate_failed", "reasons": result.gate.reasons}
        counts = self.store.feedback_counts()
        version = self.registry.register(
            self.name,
            result.artifact_dir,
            run_id=result.run_id,
            metrics={
                k: float(v)
                for k, v in result.gate.metrics.items()
            },
            lineage={
                "parent_version": result.champion_version,
                "trained_by": "conductor",
                "feedback_window_rows": counts["window"],
                "feedback_reservoir_rows": counts["reservoir"],
                "gate": result.gate.to_json(),
            },
        )
        # intent persisted BEFORE the alias write: a crash between the two
        # re-sets the alias on resume instead of losing the challenger
        if not self.store.transition(
            self.name, (st.RETRAINING,), st.GATED,
            owner_guard=self.owner, owner=None,
            challenger_version=version,
            champion_version=result.champion_version,
            gate=result.gate.to_json(),
        ):
            # episode was stale-stolen mid-fit (heartbeat thread starved?):
            # another worker owns a fresh episode — leave its state and the
            # aliases alone; the registered version stays unaliased lineage
            state = self.store.get_state(self.name)["state"]
            metrics.lifecycle_retrains.labels("lost_ownership").inc()
            log.error(
                "retrain episode ownership lost (state now %s) — challenger "
                "v%d registered but NOT aliased", state, version,
            )
            return {"outcome": "lost_ownership", "version": version}
        self._export_state(st.GATED)
        # fraud-range kill point: challenger registered + intent persisted,
        # @shadow alias not yet written — resume() must re-alias, not
        # re-register (the duplicate-registration drill)
        fire("conductor.gated.pre_alias", version=version)
        self.registry.set_alias(self.name, config.shadow_stage(), version)
        if not self.store.transition(self.name, (st.GATED,), st.SHADOWING):
            return self._shadow_alias_lost_race(version)
        self._export_state(st.SHADOWING)
        metrics.lifecycle_retrains.labels("gated").inc()
        log.warning(
            "challenger v%d registered at @%s (parent v%s) — shadowing",
            version, config.shadow_stage(), result.champion_version,
        )
        return {
            "outcome": "gated",
            "version": version,
            "gate": result.gate.to_json(),
        }

    def _shadow_alias_lost_race(self, version: int) -> dict:
        """GATED → SHADOWING lost. Two winners are possible and they want
        opposite things:

        - a concurrent worker finalized the SAME challenger (two resumers
          on one GATED row): the alias we set is exactly the one it wants —
          leave it;
        - a concurrent rollback won GATED → ROLLED_BACK: its delete_alias
          ran before our set_alias and was a no-op — drop the alias we just
          wrote so the rejected challenger is not left shadow-scoring."""
        state = self.store.get_state(self.name)["state"]
        self._export_state(state)
        if state in (st.SHADOWING, st.PROMOTING, st.DONE):
            log.info(
                "GATED→SHADOWING lost to a concurrent finalizer of the same "
                "challenger v%d (state now %s) — alias kept", version, state,
            )
            return {"outcome": "shadowing", "version": version, "state": state}
        self.registry.delete_alias(self.name, config.shadow_stage())
        metrics.lifecycle_retrains.labels("lost_race").inc()
        log.warning(
            "challenger v%d was rolled back concurrently with its @%s "
            "aliasing (state now %s) — alias dropped",
            version, config.shadow_stage(), state,
        )
        return {"outcome": "rolled_back", "version": version, "state": state}

    # -- promotion / rollback ----------------------------------------------
    def handle_promote(self, reason: str = "", force: bool = False) -> dict:
        """Flip ``@prod`` to the shadowing challenger. Normally consumes a
        watchtower ``promote_challenger`` recommendation (state must be
        ``shadowing``); ``force=True`` is the operator override that
        promotes whatever ``@shadow`` points at regardless of state
        (the promotion runbook)."""
        shadow = self._shadow_version()
        if shadow is None:
            log.warning("promote requested but no @shadow alias exists")
            return {"outcome": "no_challenger"}
        prior = self._champion_version()
        from_states = st.STATES if force else (st.SHADOWING,)
        if not self.store.transition(
            self.name, from_states, st.PROMOTING,
            challenger_version=shadow, champion_version=prior, reason=reason,
        ):
            state = self.store.get_state(self.name)["state"]
            log.warning(
                "promote dropped: state %s is not shadowing (force=False)",
                state,
            )
            return {"outcome": "skipped", "state": state}
        self._export_state(st.PROMOTING)
        return self._complete_promotion()

    def _complete_promotion(self) -> dict:
        """The promoting → done leg. Separated so :meth:`resume` can finish
        a half-applied promotion: both registry writes are idempotent and
        the recorded intent (challenger_version) is the single source of
        truth for WHAT gets promoted."""
        state = self.store.get_state(self.name)
        target = state.get("challenger_version")
        prior = state.get("champion_version")
        if target is None:
            self.store.transition(
                self.name, (st.PROMOTING,), st.ROLLED_BACK,
                reason="promoting state carried no challenger version",
            )
            self._export_state(st.ROLLED_BACK)
            return {"outcome": "failed", "error": "no recorded target version"}
        # fraud-range kill points around the promotion's registry writes:
        # pre_alias = intent persisted, nothing applied; mid_alias = @prod
        # moved but @shadow not yet dropped; pre_finalize = both applied,
        # DONE not recorded. resume() must converge every one of them to
        # exactly-once promotion.
        fire("conductor.promoting.pre_alias", target=target)
        self.registry.set_alias(self.name, config.model_stage(), int(target))
        fire("conductor.promoting.mid_alias", target=target)
        self.registry.delete_alias(self.name, config.shadow_stage())
        fire("conductor.promoting.pre_finalize", target=target)
        if not self.store.transition(self.name, (st.PROMOTING,), st.DONE):
            # a concurrent rollback won PROMOTING → ROLLING_BACK while our
            # alias writes were in flight; the state machine picked IT, so
            # converge the aliases to its intent (idempotent re-apply)
            after = self.store.get_state(self.name)
            cur = after["state"]
            if cur in (st.ROLLING_BACK, st.ROLLED_BACK) and prior is not None:
                self.registry.set_alias(
                    self.name, config.model_stage(), int(prior)
                )
                self.registry.delete_alias(self.name, config.shadow_stage())
            self._export_state(cur)
            log.error(
                "promotion finalize lost a race (state now %s) — aliases "
                "converged to the winner's intent", cur,
            )
            return {"outcome": "lost_race", "state": cur}
        self._export_state(st.DONE)
        metrics.lifecycle_promotions.inc()
        log.warning(
            "promoted challenger v%s to @%s (prior champion v%s retained "
            "for rollback)",
            target, config.model_stage(), prior,
        )
        if self.on_promote is not None:
            try:
                self.on_promote(int(target))
            except Exception:
                log.warning("on_promote hook failed", exc_info=True)
        return {"outcome": "promoted", "version": int(target), "prior": prior}

    def _complete_rollback(self) -> dict:
        """The rolling_back → rolled_back leg. Separated so :meth:`resume`
        can finish a half-applied promotion rollback: the recorded prior
        champion is the single source of truth for WHAT gets restored, and
        both registry writes are idempotent."""
        state = self.store.get_state(self.name)
        prior = state.get("champion_version")
        if prior is None:
            self.store.transition(
                self.name, (st.ROLLING_BACK,), st.ROLLED_BACK,
                reason="rolling_back state carried no prior champion",
            )
            self._export_state(st.ROLLED_BACK)
            return {"outcome": "failed", "error": "no prior champion recorded"}
        # fraud-range kill point: rollback intent persisted, alias restore
        # not yet applied — resume() completes it
        fire("conductor.rolling_back.pre_alias", prior=prior)
        self.registry.set_alias(self.name, config.model_stage(), int(prior))
        self.registry.delete_alias(self.name, config.shadow_stage())
        if not self.store.transition(
            self.name, (st.ROLLING_BACK,), st.ROLLED_BACK
        ):
            # a concurrent force-promote stole the episode; it applies its
            # own aliases after ours — report the loss, change nothing more
            cur = self.store.get_state(self.name)["state"]
            self._export_state(cur)
            log.error("rollback finalize lost a race (state now %s)", cur)
            return {"outcome": "lost_race", "state": cur}
        self._export_state(st.ROLLED_BACK)
        metrics.lifecycle_rollbacks.inc()
        log.warning("rolled @%s back to v%s", config.model_stage(), prior)
        return {"outcome": "rolled_back", "restored": int(prior)}

    def handle_rollback(self, reason: str = "") -> dict:
        """Two rollback shapes, selected by where the episode stands:

        - **challenger rollback** (state shadowing/gated — watchtower's
          ``rollback_challenger``): drop the ``@shadow`` alias; ``@prod``
          never moved, so nothing else changes;
        - **promotion rollback** (state promoting/done): record the intent
          first (CAS to ``rolling_back`` — same discipline as
          ``promoting``), then restore ``@prod`` to the recorded prior
          champion and drop ``@shadow``. A crash between the CAS and the
          alias writes leaves a ``rolling_back`` row that resume()
          completes."""
        state = self.store.get_state(self.name)
        current = state["state"]
        if current in (st.PROMOTING, st.DONE, st.ROLLING_BACK):
            if state.get("champion_version") is None:
                log.error("rollback requested but no prior champion recorded")
                return {"outcome": "failed", "error": "no prior champion"}
            if current != st.ROLLING_BACK and not self.store.transition(
                self.name, (st.PROMOTING, st.DONE), st.ROLLING_BACK,
                reason=reason or "promotion rolled back",
            ):
                now = self.store.get_state(self.name)["state"]
                log.warning("rollback dropped: lost race (state now %s)", now)
                return {"outcome": "skipped", "state": now}
            self._export_state(st.ROLLING_BACK)
            return self._complete_rollback()
        if not self.store.transition(
            self.name, (st.SHADOWING, st.GATED), st.ROLLED_BACK,
            reason=reason or "challenger rolled back",
        ):
            log.info("rollback dropped: no episode in progress (%s)", current)
            return {"outcome": "skipped", "state": current}
        self.registry.delete_alias(self.name, config.shadow_stage())
        self._export_state(st.ROLLED_BACK)
        metrics.lifecycle_rollbacks.inc()
        log.warning("challenger @%s unregistered", config.shadow_stage())
        return {"outcome": "rolled_back", "restored": None}

    # -- crash recovery ----------------------------------------------------
    def resume(self) -> dict | None:
        """Pick up a DEAD worker's episode mid-step (called at worker
        startup). No-op when the state machine is parked — or when the
        episode is provably live (a retraining row whose owner is still
        heartbeating must not be hijacked by a scale-up or rolling
        restart)."""
        state = self.store.get_state(self.name)
        current = state["state"]
        self._export_state(current)
        if current == st.RETRAINING:
            # an interrupted fit left no registry side effects, so re-running
            # is safe — but only a stale row (no heartbeat for stale_after
            # seconds) is provably a dead owner's. The steal is a guarded
            # UPDATE: a live owner's concurrent heartbeat wins the race.
            stale_after = config.lifecycle_retrain_stale_after()
            if not self.store.reclaim_stale_retrain(self.name, stale_after):
                age = time.time() - float(state.get("updated_at") or 0.0)
                log.info(
                    "retraining episode appears live (owner %s, heartbeat "
                    "%.0fs ago < stale threshold %.0fs) — not resuming",
                    state.get("owner"), age, stale_after,
                )
                return None
            log.warning(
                "reclaimed stale retrain episode (dead owner %s) — re-running",
                state.get("owner"),
            )
            return self.handle_retrain(
                reason=(state.get("reason") or "") + " [resumed]"
            )
        if current == st.GATED:
            version = state.get("challenger_version")
            if version is not None:
                log.warning("resuming: re-aliasing gated challenger v%s", version)
                self.registry.set_alias(
                    self.name, config.shadow_stage(), int(version)
                )
                if not self.store.transition(
                    self.name, (st.GATED,), st.SHADOWING
                ):
                    return self._shadow_alias_lost_race(int(version))
                self._export_state(st.SHADOWING)
                return {"outcome": "resumed_shadowing", "version": version}
            self.store.transition(
                self.name, (st.GATED,), st.ROLLED_BACK,
                reason="gated state carried no challenger version",
            )
            self._export_state(st.ROLLED_BACK)
            return {"outcome": "failed"}
        if current == st.PROMOTING:
            log.warning("resuming interrupted promotion")
            return self._complete_promotion()
        if current == st.ROLLING_BACK:
            log.warning("resuming interrupted promotion rollback")
            return self._complete_rollback()
        return None
