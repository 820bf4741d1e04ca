"""The asynchronous SHAP worker.

The port's own copy of the JAX package's ``service/worker.py``: it claims
``xai_tasks.compute_shap`` tasks from the broker in batches, scores and
explains each batch on the model's device with one ``predict_proba`` and
one ``explain_batch`` — the logistic family through the ``fused_score``
kernel and the linear closed form coef·(x − μ), the GBT family through its
forest walk and the ``tree_shap`` kernel — and writes COMPLETED rows to the
results DB, which ``GET /explain/{transaction_id}`` reads back.

Semantics kept from the reference:

- task name ``xai_tasks.compute_shap(transaction_id, input_data, corr_id
  [, traceparent [, serve_topk]])`` (xai_tasks.py:63, api/worker.py:65);
- acks_late + max_retries=5, retry countdown 5 s on DB errors / 10 s on
  other errors, FAILED status after exhaustion (xai_tasks.py:63,137-163);
- a worker-side metrics endpoint on :8001 (xai_tasks.py:52-56), here a
  stdlib ``http.server`` thread serving :func:`metrics.render`;
- the model loaded once at startup, not per task.

The lifecycle tasks run the conductor (``lifecycle/conductor.py``) on the
worker's device: ``watchtower.trigger_retrain`` (retrain → gate →
``@shadow``, SMOTE's k-NN through ``knn_topk`` and the gate's scoring
through ``fused_score`` on the card), ``lifecycle.promote_challenger``,
``lifecycle.rollback_challenger`` and ``lifecycle.record_feedback``. The
conductor's store is ``LIFECYCLE_DB_URL`` (default: the broker's
database); it opens at the first lifecycle task, so a worker without a
usable store keeps explaining. :meth:`XaiWorker.run_forever` resumes a dead
worker's half-done episode before its first claim, and a promotion this
worker applies hot-reloads its own model. The ``traceparent`` argument
links each task's ``compute_shap`` span to the request that queued it
(``service/tracing``; with ``OTEL_EXPORTER_OTLP_ENDPOINT`` set). The entry
point installs the compile sentinel before the model loads, warms the
ladder under its expected mark, and refreshes the device-memory gauges
every ~30 s of its poll loop.

Run: ``python -m fraud_detection_tpu_torch.service.worker`` (on ``cuda``;
``DEVICE=cpu`` runs it on the CPU).
"""

from __future__ import annotations

import logging
import signal
import socket
import sqlite3
import threading
import time
import uuid

import numpy as np

from fraud_detection_tpu_torch import config
from fraud_detection_tpu_torch.device import resolve_device
from fraud_detection_tpu_torch.ops.scorer import _bucket
from fraud_detection_tpu_torch.service import metrics
from fraud_detection_tpu_torch.service.tracing import setup_tracing, span
from fraud_detection_tpu_torch.service.db import ResultsDB
from fraud_detection_tpu_torch.service.errors import (
    DatabaseError,
    StoreAuthError,
    StoreError,
)
from fraud_detection_tpu_torch.service.loading import load_production_model
from fraud_detection_tpu_torch.service.taskq import TASK_NAME, Broker, Task
from fraud_detection_tpu_torch.telemetry import compile_sentinel, devicemem

log = logging.getLogger("fraud_detection_tpu_torch.worker")

DB_RETRY_COUNTDOWN = 5.0   # xai_tasks.py:137-141
OTHER_RETRY_COUNTDOWN = 10.0


class XaiWorker:
    def __init__(
        self,
        broker_url: str | None = None,
        database_url: str | None = None,
        worker_id: str | None = None,
        poll_interval: float = 0.2,
        max_batch: int = 64,
        device=None,
    ):
        """A worker over the production model (``service.loading``) on
        ``device`` (default: ``DEVICE``, itself defaulting to ``cuda``).
        Raises at once when ``cuda`` is asked for and no card is present."""
        dev = resolve_device(device)
        self.device = dev
        self.worker_id = worker_id or f"{socket.gethostname()}-{uuid.uuid4().hex[:6]}"
        self.broker = Broker(broker_url)
        self.db = ResultsDB(database_url)
        self.poll_interval = poll_interval
        self.max_batch = max_batch
        self._stop = threading.Event()
        self._conductor = None  # built at the first lifecycle task
        self.model, source = load_production_model(device=dev)
        self.model.raw_explainer()  # build + cache (tree_shap's tables too)
        metrics.model_loaded.set(1)
        log.info("worker %s up on %s; model from %s", self.worker_id, dev, source)

    # -- task bodies -------------------------------------------------------
    #: tolerance of the serve-time vs backfill attribution comparison; a
    #: family widens it through an ``explain_consistency_atol`` attribute
    #: (the GBT family does: a bin flip moves φ by a leaf-value delta)
    EXPLAIN_CONSISTENCY_ATOL = 5e-2

    @property
    def _explain_atol(self) -> float:
        return float(
            getattr(
                self.model,
                "explain_consistency_atol",
                self.EXPLAIN_CONSISTENCY_ATOL,
            )
        )

    def _check_explain_consistency(
        self, phi, serve_topk, correlation_id, transaction_id
    ) -> bool:
        """The serve-time top-k reason codes riding the task payload must
        agree with this full-vector backfill: the serve indices'
        attributions re-derived here within tolerance, and the serve top-1
        within tolerance of the true max (strict index equality would
        false-alarm on near-ties); for a ledger- or wide-widened model only
        the base columns. A mismatch counts and warns."""
        if not isinstance(serve_topk, dict):
            return True
        try:
            idxs = [int(i) for i in serve_topk.get("indices") or []]
            vals = np.asarray(serve_topk.get("values") or [], np.float64)
        except (TypeError, ValueError):
            idxs, vals = [], np.zeros(0)
        phi = np.asarray(phi, np.float64).reshape(-1)
        if not idxs or len(idxs) != vals.shape[0] or max(idxs) >= phi.shape[0]:
            return True  # malformed/absent payload: nothing to check
        atol = self._explain_atol
        spec = getattr(self.model, "ledger_spec", None) or getattr(
            self.model, "wide_spec", None
        )
        if spec is not None:
            # a widened family: the serve-time attributions of the widened
            # columns used live device state (the ledger's table, the wide
            # family's entity crosses), which this backfill cannot see (it
            # explains through the null path), so compare the base columns
            # only, and skip the top-1 check when a widened column led the
            # serve ranking
            keep = [j for j, i in enumerate(idxs) if i < spec.n_base]
            if not keep:
                return True
            ok = bool(
                np.all(np.abs(phi[[idxs[j] for j in keep]] - vals[keep]) <= atol)
                and (idxs[0] >= spec.n_base
                     or abs(float(phi[: spec.n_base].max()) - float(vals[0])) <= atol)
            )
        else:
            ok = bool(
                np.all(np.abs(phi[idxs] - vals) <= atol)
                and abs(float(phi.max()) - float(vals[0])) <= atol
            )
        if not ok:
            metrics.xai_explain_consistency_failures.inc()
            log.warning(
                "[%s] serve-time reason codes disagree with the backfill "
                "for %s: serve %s=%s vs recomputed %s (fused explain leg "
                "and worker explainer out of sync?)",
                correlation_id, transaction_id, idxs,
                np.round(vals, 4).tolist(),
                np.round(phi[idxs], 4).tolist(),
            )
        return ok

    def compute_shap(
        self,
        transaction_id: str,
        input_data: dict,
        correlation_id: str | None,
        traceparent: str | None = None,
        serve_topk: dict | None = None,
    ) -> None:
        """One task's body. ``traceparent`` (the optional 4th argument, a W3C
        header captured inside the API's ``predict`` span) links this task's
        ``compute_shap`` span to the request; ``serve_topk`` (the optional
        5th) is the serve-time top-k, checked against this backfill."""
        with span("compute_shap", traceparent=traceparent,
                  correlation_id=correlation_id or ""):
            row = self.model.prepare_row(input_data)
            score = float(self.model.scorer.predict_proba(row[None, :])[0])
            phi, expected_value = self.model.explain_one(row)
            self._check_explain_consistency(
                phi, serve_topk, correlation_id, transaction_id
            )
            shap_values = dict(zip(self.model.feature_names, phi.astype(float)))
            self.db.complete(transaction_id, shap_values, expected_value, score)
        log.info(
            "[%s] explained %s (score %.4f)",
            correlation_id, transaction_id, score,
        )

    # -- the conductor (lifecycle/) -----------------------------------------
    def _get_conductor(self):
        """The conductor, built at the first lifecycle task: a worker whose
        lifecycle store cannot open keeps explaining, and its lifecycle
        tasks fail into the retry ladder with the real error."""
        if self._conductor is None:
            from fraud_detection_tpu_torch.lifecycle import (
                Conductor,
                open_lifecycle_store,
            )

            # lifecycle state lives beside THIS worker's queue
            # (LIFECYCLE_DB_URL overrides)
            self._conductor = Conductor(
                store=open_lifecycle_store(config.lifecycle_db_url(self.broker.url)),
                on_promote=self._on_promote,
                device=self.device,
            )
        return self._conductor

    def _on_promote(self, version: int) -> None:
        """A promotion this worker applied: hot-reload its OWN model, so
        the explanation path matches what serving scores with."""
        try:
            # built in full (the explainer cached) BEFORE it is published: if
            # any step raises, self.model is still the previous champion
            model, source = load_production_model(device=self.device)
            model.raw_explainer()
            self.model = model
            log.warning(
                "worker model hot-reloaded after promotion of v%s (%s)",
                version, source,
            )
        except Exception:
            log.warning(
                "worker model reload after promotion failed — explaining "
                "with the previous champion until restart", exc_info=True,
            )

    def trigger_retrain(self, reason: str = "") -> None:
        """A watchtower drift episode (one task an episode under
        ``WATCHTOWER_RETRAIN_TRIGGER=1``): run the conductor's retrain →
        gate → ``@shadow`` pipeline. The conductor's persisted CAS drops
        duplicates across API replicas."""
        metrics.retrain_requests.inc()
        log.warning(
            "RETRAIN REQUESTED by watchtower: %s — running the conductor "
            "pipeline", reason or "(no reason given)",
        )
        result = self._get_conductor().handle_retrain(reason)
        log.warning("conductor retrain finished: %s", result)

    def promote_challenger(self, reason: str = "") -> None:
        self._get_conductor().handle_promote(reason)

    def rollback_challenger(self, reason: str = "") -> None:
        self._get_conductor().handle_rollback(reason)

    def record_feedback(self, features, scores, labels) -> None:
        """Queue-delivered labeled feedback (a label joiner that publishes
        to the broker instead of POSTing /monitor/feedback)."""
        n = self._get_conductor().record_feedback(features, scores, labels)
        log.info("recorded %d feedback rows", n)

    def resume_lifecycle(self) -> None:
        """Finish any episode a dead worker left mid-step (run_forever
        calls this before its first claim)."""
        try:
            result = self._get_conductor().resume()
        except Exception:
            log.warning("lifecycle resume failed", exc_info=True)
            return
        if result is not None:
            log.warning("resumed lifecycle episode: %s", result)

    def _execute(self, task: Task) -> None:
        from fraud_detection_tpu_torch.lifecycle.conductor import (
            FEEDBACK_TASK,
            PROMOTE_TASK,
            ROLLBACK_TASK,
        )
        from fraud_detection_tpu_torch.monitor.watchtower import RETRAIN_TASK

        handlers = {
            TASK_NAME: self.compute_shap,
            RETRAIN_TASK: self.trigger_retrain,
            PROMOTE_TASK: self.promote_challenger,
            ROLLBACK_TASK: self.rollback_challenger,
            FEEDBACK_TASK: self.record_feedback,
        }
        fn = handlers.get(task.name)
        if fn is None:
            raise ValueError(f"unknown task {task.name}")
        fn(*task.args)

    def compute_shap_many(self, tasks: list[Task]) -> dict[str, Exception | None]:
        """Batched form of :meth:`compute_shap`: ONE stacked scoring call and
        ONE batched SHAP call for all claimed tasks. Returns each task's
        outcome (None = success), so delivery stays per task: bad input
        fails only its task, a device failure the whole batch, a DB failure
        only its task."""
        # lockcheck: hot-path — the claimed-batch explain loop allocates no batch array
        outcome: dict[str, Exception | None] = {}
        prepared: list[tuple[Task, np.ndarray]] = []
        prepared_rows: list[np.ndarray] = []
        for t in tasks:
            try:
                row = self.model.prepare_row(t.args[1])
                prepared.append((t, row))
                prepared_rows.append(row)
            except Exception as e:  # lockcheck: ignore[silent-except] — _settle logs it
                outcome[t.id] = e
        if not prepared:
            return outcome
        # Pad to the scorer's power-of-two bucket in a recycled staging
        # slot (pinned on a card), so the worker allocates no batch array.
        k = len(prepared)
        scorer = self.model.scorer
        slot = scorer.staging.acquire(_bucket(k, scorer.min_bucket))
        try:
            np.stack(prepared_rows, out=slot.f32[:k])
            slot.f32[k:] = 0.0
            scores = scorer.predict_proba(slot.f32)[:k]
            phis, expected_value = self.model.explain_batch(slot.f32)
            phis = phis[:k]
        except Exception as e:  # lockcheck: ignore[silent-except] — _settle logs it
            for t, _ in prepared:
                outcome[t.id] = e
            return outcome
        finally:
            # both calls fetched their results to the host (synchronous
            # d2h), so the staged rows are consumed and the slot recycles
            scorer.staging.release(slot)
        names = self.model.feature_names
        for (t, _), score, phi in zip(prepared, scores, phis):
            tx_id, _, corr_id, traceparent, serve_topk = (t.args + [None] * 5)[:5]
            try:
                with span("compute_shap", traceparent=traceparent,
                          correlation_id=corr_id or ""):
                    self._check_explain_consistency(phi, serve_topk, corr_id, tx_id)
                    self.db.complete(
                        tx_id,
                        dict(zip(names, phi.astype(float))),
                        expected_value,
                        float(score),
                    )
                outcome[t.id] = None
                log.info("[%s] explained %s (score %.4f)", corr_id, tx_id, score)
            except Exception as e:  # lockcheck: ignore[silent-except] — _settle logs it
                outcome[t.id] = e
        return outcome

    # -- delivery loop -----------------------------------------------------
    def _settle(self, task: Task, err: Exception | None) -> None:
        """The reference's per-task delivery semantics (acks_late, retry
        ladder, FAILED terminal state — xai_tasks.py:63,137-163)."""
        if err is None:
            self.broker.ack(task.id)  # acks_late: only after success
            metrics.xai_task_success.inc()
            return
        is_db = isinstance(err, (sqlite3.Error, DatabaseError))
        countdown = DB_RETRY_COUNTDOWN if is_db else OTHER_RETRY_COUNTDOWN
        # expected_attempts: the count seen at claim time (a duplicate nack
        # cannot double-increment toward FAILED); claimed_by: our id (a
        # timed-out claim redelivered to another worker is not requeued
        # out from under it)
        will_retry = self.broker.nack(
            task.id, countdown, str(err),
            expected_attempts=task.attempts, claimed_by=self.worker_id,
        )
        metrics.xai_task_failures.inc()
        if will_retry:
            log.warning(
                "task %s failed (%s); retry in %.0fs (attempt %d/%d)",
                task.id, err, countdown, task.attempts + 1, task.max_retries,
            )
        else:
            log.error("task %s FAILED permanently: %s", task.id, err)
            tx_id = task.args[0] if task.args else None
            if tx_id:
                try:
                    self.db.fail(tx_id, str(err))
                except Exception:
                    log.exception("could not mark %s FAILED", tx_id)

    def _run_one(self, task: Task) -> None:
        """Execute and settle one task, timed (run_once, and run_batch's
        tasks of other names)."""
        try:
            with metrics.timed(metrics.xai_task_duration):
                self._execute(task)
            err = None
        except Exception as e:  # lockcheck: ignore[silent-except] — settled and logged below
            err = e
        self._settle(task, err)

    def run_once(self) -> bool:
        """Claim and process one task; returns True when one was handled."""
        task = self.broker.claim(self.worker_id)
        if task is None:
            return False
        self._run_one(task)
        return True

    def run_batch(self, max_batch: int | None = None) -> int:
        """Claim up to ``max_batch`` tasks and process them with batched
        device calls; returns the number handled."""
        max_batch = max_batch or self.max_batch
        # the redelivery window grows with the batch, so a slow batch is not
        # handed to (and processed twice by) another worker
        tasks = self.broker.claim_many(
            self.worker_id, max_batch, visibility_timeout=60.0 + 2.0 * max_batch
        )
        if not tasks:
            return 0
        shap_tasks = [t for t in tasks if t.name == TASK_NAME]
        other = [t for t in tasks if t.name != TASK_NAME]
        if shap_tasks:
            t0 = time.perf_counter()
            outcome = self.compute_shap_many(shap_tasks)
            per_task = (time.perf_counter() - t0) / len(shap_tasks)
            for t in shap_tasks:
                # observed per task, so rate(count) stays tasks/s
                metrics.xai_task_duration.observe(per_task)
                self._settle(t, outcome.get(t.id))
        for t in other:  # lifecycle (and unknown) tasks: one by one
            self._run_one(t)
        return len(tasks)

    def warmup(self) -> None:
        """Score and explain one zero batch per bucket of the ladder up to
        ``max_batch``, so the first claimed batch finds the kernels built
        and the allocator's blocks cached (run_forever runs it; tests drive
        run_once/run_batch cold). Runs under the compile sentinel's expected
        mark: a deploy's warm-up is not a recompile storm."""
        d = self.model.scorer.staging_features  # the rows tasks carry
        b = self.model.scorer.min_bucket
        top = _bucket(self.max_batch, b)
        with compile_sentinel.expected_compiles():
            while b <= top:
                zeros = np.zeros((b, d), np.float32)
                self.model.scorer.predict_proba(zeros)
                self.model.explain_batch(zeros)
                b *= 2

    def run_forever(self, max_batch: int | None = None) -> None:
        if max_batch:
            self.max_batch = max_batch
        self.warmup()
        self.resume_lifecycle()  # crash recovery BEFORE consuming new work
        log.info("worker %s consuming (broker %s)", self.worker_id, self.broker.url)
        outage_backoff = max(5 * self.poll_interval, 1.0)
        while not self._stop.is_set():
            # A store outage must not crash the worker: acks_late redelivers
            # any claimed-but-unsettled task after its visibility timeout,
            # so the worker backs off and polls again.
            try:
                metrics.queue_depth.set(self.broker.depth())
                # the device-memory watermark of the worker's /metrics (the
                # API refreshes at scrape; the worker has no scrape hook)
                devicemem.maybe_refresh(device=self.device)
                handled = self.run_batch(max_batch)
            except StoreAuthError:
                raise  # misconfigured credentials: crash loudly, don't spin
            except (sqlite3.Error, StoreError) as e:
                log.warning(
                    "broker/store unavailable (%s); retrying in %.1fs",
                    e, outage_backoff,
                )
                self._stop.wait(outage_backoff)
                continue
            if not handled:
                self._stop.wait(self.poll_interval)

    def stop(self) -> None:
        """Graceful drain: the batch in hand settles, then run_forever
        returns (the preStop ``celery control shutdown`` analogue)."""
        self._stop.set()

    def close(self) -> None:
        self.broker.close()
        self.db.close()
        if self._conductor is not None:
            self._conductor.store.close()


def main(argv: list[str] | None = None) -> None:
    import argparse

    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser()
    ap.add_argument(
        "--metrics-port", type=int, default=config.worker_metrics_port(),
        help="port of the worker's /metrics (0: none)",
    )
    ap.add_argument("--poll-interval", type=float, default=0.2)
    ap.add_argument(
        "--max-batch", type=int, default=64,
        help="tasks claimed and explained per device dispatch",
    )
    args = ap.parse_args(argv)

    # force=True: a setup earlier in this process (before the environment
    # was ready) must not latch tracing off for the worker's lifetime
    setup_tracing(service_name="fraud-xai-worker", force=True)
    # the compile sentinel before the model loads: the kernel libraries the
    # worker's warm-up and batches load count too
    compile_sentinel.install()
    worker = XaiWorker(poll_interval=args.poll_interval, max_batch=args.max_batch)
    server = None
    try:
        if args.metrics_port:
            server = metrics.start_http_server(args.metrics_port, name="worker-metrics")
            log.info("worker metrics on :%d", args.metrics_port)
        signal.signal(signal.SIGTERM, lambda *_: worker.stop())
        signal.signal(signal.SIGINT, lambda *_: worker.stop())
        worker.run_forever()
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
        worker.close()


if __name__ == "__main__":
    main()
