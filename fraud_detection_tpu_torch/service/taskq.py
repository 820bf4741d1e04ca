"""Task queue with Celery's delivery semantics, SQLite-backed.

The port's own copy of the JAX package's ``service/taskq.py`` for the
``sqlite:///`` backend (WAL; safe across processes on one host). The
``tasks`` table and every statement are the JAX package's, so a JAX app and
a port worker — or the other way round — can share one broker file. The
semantics the reference's reliability story depends on
(docs/WorkerRecoveryTestPlan.md):

- **acks_late**: a task is acknowledged only after successful execution; a
  worker dying mid-task leaves the claim to expire (visibility timeout) and
  the task is redelivered — at-least-once, zero loss on pod kill;
- **bounded retries with backoff**: ``max_retries`` (default 5, matching
  xai_tasks.py:63) with per-retry countdown, FAILED terminal state after
  exhaustion (xai_tasks.py:143-163);
- **queue depth** observable for autoscaling (the KEDA listLength trigger).

The network schemes (``fraud://``, ``sentinel://``, ``postgresql://``) come
with the network store tier (ROADMAP item 8c); until then :func:`Broker`
raises for them.
"""

from __future__ import annotations

import json
import logging
import os
import sqlite3
import threading
import time
import uuid
from dataclasses import dataclass
from typing import Any

from fraud_detection_tpu_torch import config
from fraud_detection_tpu_torch.service import metrics
from fraud_detection_tpu_torch.service.db import NETWORK_SCHEMES

log = logging.getLogger("fraud_detection_tpu_torch.taskq")

QUEUED = "QUEUED"
CLAIMED = "CLAIMED"
DONE = "DONE"
FAILED = "FAILED"

TASK_NAME = "xai_tasks.compute_shap"  # reference task name (api/worker.py:65)
DEFAULT_MAX_RETRIES = 5  # xai_tasks.py:63
DEFAULT_VISIBILITY_TIMEOUT = 60.0


@dataclass
class Task:
    id: str
    name: str
    args: list[Any]
    correlation_id: str | None
    attempts: int
    max_retries: int


def _path(url: str) -> str:
    return url[len("sqlite:///") :] if url.startswith("sqlite:///") else url


class SqliteBroker:
    def __init__(self, url: str | None = None):
        self.url = url or config.broker_url()
        path = _path(self.url)
        if path != ":memory:" and os.path.dirname(path):
            os.makedirs(os.path.dirname(path), exist_ok=True)
        self._lock = threading.Lock()
        # per-instance delivery-anomaly counts, mirrored into the metrics
        # registry (tests read these without scraping)
        self.redeliveries = 0
        self.expired_claims = 0
        self._conn = sqlite3.connect(path, check_same_thread=False, timeout=30.0)
        self._conn.row_factory = sqlite3.Row
        with self._lock, self._conn:
            self._conn.execute("PRAGMA journal_mode=WAL")
            self._conn.execute(
                """
                CREATE TABLE IF NOT EXISTS tasks (
                    id TEXT PRIMARY KEY,
                    name TEXT NOT NULL,
                    args TEXT NOT NULL,
                    correlation_id TEXT,
                    status TEXT NOT NULL DEFAULT 'QUEUED',
                    attempts INTEGER NOT NULL DEFAULT 0,
                    max_retries INTEGER NOT NULL DEFAULT 5,
                    visible_at REAL NOT NULL,
                    claimed_by TEXT,
                    created_at REAL NOT NULL,
                    updated_at REAL NOT NULL,
                    error TEXT
                )
                """
            )
            self._conn.execute(
                "CREATE INDEX IF NOT EXISTS idx_tasks_claim "
                "ON tasks(status, visible_at)"
            )

    # -- producer ----------------------------------------------------------
    def send_task(
        self,
        name: str,
        args: list[Any],
        correlation_id: str | None = None,
        max_retries: int = DEFAULT_MAX_RETRIES,
        countdown: float = 0.0,
        task_id: str | None = None,
    ) -> str:
        """Celery ``send_task`` equivalent (api/app.py:244-245).

        ``task_id`` may be supplied by the caller, so an ambiguous retry
        lands on DO NOTHING instead of enqueuing a duplicate. ``args`` is an
        opaque JSON list; ``xai_tasks.compute_shap`` takes 3 to 5 of them
        (transaction id, features, correlation id, then the optional W3C
        ``traceparent`` and the optional serve-time top-k)."""
        task_id = task_id or uuid.uuid4().hex
        now = time.time()
        with self._lock, self._conn:
            self._conn.execute(
                "INSERT INTO tasks (id, name, args, correlation_id, status, "
                "max_retries, visible_at, created_at, updated_at) "
                "VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?) "
                "ON CONFLICT(id) DO NOTHING",
                (
                    task_id, name, json.dumps(args), correlation_id,
                    QUEUED, max_retries, now + countdown, now, now,
                ),
            )
        return task_id

    # -- consumer ----------------------------------------------------------
    def claim(
        self, worker_id: str, visibility_timeout: float = DEFAULT_VISIBILITY_TIMEOUT
    ) -> Task | None:
        """Atomically claim the oldest deliverable task.

        Deliverable = QUEUED and visible, or CLAIMED whose visibility window
        lapsed (the acks_late redelivery path after a worker death).
        """
        tasks = self.claim_many(worker_id, 1, visibility_timeout)
        return tasks[0] if tasks else None

    def claim_many(
        self,
        worker_id: str,
        limit: int,
        visibility_timeout: float = DEFAULT_VISIBILITY_TIMEOUT,
    ) -> list[Task]:
        """Atomically claim up to ``limit`` deliverable tasks (oldest first).

        Same visibility/acks-late semantics as :meth:`claim`; one UPDATE per
        row under one transaction. Lets a worker amortize one device
        dispatch over many tasks (the batched-SHAP hot path).
        """
        now = time.time()
        claimed: list[Task] = []
        with self._lock, self._conn:
            rows = self._conn.execute(
                "SELECT * FROM tasks WHERE status IN (?, ?) AND visible_at <= ? "
                "ORDER BY created_at LIMIT ?",
                (QUEUED, CLAIMED, now, limit),
            ).fetchall()
            for row in rows:
                cur = self._conn.execute(
                    "UPDATE tasks SET status = ?, claimed_by = ?, visible_at = ?, "
                    "updated_at = ? WHERE id = ? AND status = ? AND visible_at <= ?",
                    (
                        CLAIMED, worker_id, now + visibility_timeout, now,
                        row["id"], row["status"], now,
                    ),
                )
                if cur.rowcount == 1:  # else lost the race to another worker
                    # A CLAIMED row here means the previous claim's window
                    # lapsed without ack/nack (worker death or stall: the
                    # acks-late redelivery); a QUEUED row with attempts > 0
                    # is a nack-retry redelivery. Both are deliveries beyond
                    # the first.
                    if row["status"] == CLAIMED:
                        self.expired_claims += 1
                        self.redeliveries += 1
                        metrics.taskq_expired_claims.inc()
                        metrics.taskq_redeliveries.inc()
                    elif row["attempts"] > 0:
                        self.redeliveries += 1
                        metrics.taskq_redeliveries.inc()
                    claimed.append(
                        Task(
                            id=row["id"],
                            name=row["name"],
                            args=json.loads(row["args"]),
                            correlation_id=row["correlation_id"],
                            attempts=row["attempts"],
                            max_retries=row["max_retries"],
                        )
                    )
        return claimed

    def ack(self, task_id: str) -> None:
        """Acknowledge success — only called AFTER execution (acks_late)."""
        with self._lock, self._conn:
            self._conn.execute(
                "UPDATE tasks SET status = ?, updated_at = ? WHERE id = ?",
                (DONE, time.time(), task_id),
            )

    def nack(
        self,
        task_id: str,
        countdown: float,
        error: str = "",
        expected_attempts: int | None = None,
        claimed_by: str | None = None,
    ) -> bool:
        """Failed attempt: requeue with backoff, or FAILED past max_retries.

        Returns True when the task will be retried. Two idempotency guards:

        - ``claimed_by`` (the nacking worker's id): a worker whose claim
          timed out and was redelivered to another worker must not requeue
          a task that other worker currently holds (third delivery);
        - ``expected_attempts`` (the count observed at claim time): a
          duplicate of the SAME nack sees attempts already advanced.

        Rejected duplicates report the task's liveness (True unless FAILED)
        so callers don't mark the transaction FAILED over an in-flight or
        finished attempt.
        """
        now = time.time()
        with self._lock, self._conn:
            row = self._conn.execute(
                "SELECT attempts, max_retries, status, claimed_by FROM tasks "
                "WHERE id = ?",
                (task_id,),
            ).fetchone()
            if row is None:
                return False
            if claimed_by is not None and row["claimed_by"] != claimed_by:
                return row["status"] != FAILED
            if (
                expected_attempts is not None
                and row["attempts"] != expected_attempts
            ):
                return row["status"] != FAILED
            attempts = row["attempts"] + 1
            if attempts > row["max_retries"]:
                self._conn.execute(
                    "UPDATE tasks SET status = ?, attempts = ?, error = ?, "
                    "updated_at = ? WHERE id = ?",
                    (FAILED, attempts, error, now, task_id),
                )
                return False
            self._conn.execute(
                "UPDATE tasks SET status = ?, attempts = ?, error = ?, "
                "visible_at = ?, updated_at = ? WHERE id = ?",
                (QUEUED, attempts, error, now + countdown, now, task_id),
            )
            return True

    # -- observability -----------------------------------------------------
    def depth(self) -> int:
        """Deliverable backlog (the KEDA scaling signal)."""
        now = time.time()
        with self._lock:
            (n,) = self._conn.execute(
                "SELECT COUNT(*) FROM tasks WHERE status IN (?, ?) "
                "AND visible_at <= ?",
                (QUEUED, CLAIMED, now),
            ).fetchone()
        return n

    def get_status(self, task_id: str) -> str | None:
        with self._lock:
            row = self._conn.execute(
                "SELECT status FROM tasks WHERE id = ?", (task_id,)
            ).fetchone()
        return row["status"] if row else None

    def ping(self) -> bool:
        try:
            with self._lock:
                self._conn.execute("SELECT 1").fetchone()
            return True
        except Exception:
            log.debug("broker ping failed", exc_info=True)
            return False

    def close(self) -> None:
        with self._lock:
            self._conn.close()


def Broker(url: str | None = None):  # noqa: N802 — the JAX package's name
    """Open a broker for ``url`` (default ``CELERY_BROKER_URL``):
    ``sqlite:///path`` (stdlib SQLite WAL queue). The network schemes raise
    until ROADMAP item 8c ports the network store tier."""
    url = url or config.broker_url()
    if url.startswith("sqlite"):
        return SqliteBroker(url)
    if url.startswith(NETWORK_SCHEMES):
        raise NotImplementedError(
            f"{url.split(':', 1)[0]}:// broker: the network store tier is "
            "not ported yet (ROADMAP item 8c); use sqlite:///"
        )
    raise NotImplementedError(
        f"broker backend for {url.split(':', 1)[0]} not available; use "
        "sqlite:///"
    )
