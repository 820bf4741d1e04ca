"""Persistence layer: the results DB and its versioned migrations.

The port's own copy of the JAX package's ``service/db.py`` for the
``sqlite:///`` backend (stdlib, WAL; safe across threads and processes on
one host). The table, its columns, the migrations and every statement are
the JAX package's, byte for byte, so a JAX app and a port worker — or the
other way round — can share one file.

One table, ``transaction_results`` (db/models.py:16-24), written by the SHAP
worker and read back by ``GET /explain/{transaction_id}``. Migrations are
ordered SQL scripts applied under a ``schema_migrations`` version table.

``DATABASE_URL`` selects the backend (:func:`ResultsDB`): ``sqlite:///``,
``fraud://`` / ``sentinel://`` (the network store server with replication
and sentinel failover, ``netserver.py``/``netclient.py``), or
``postgresql://`` (a PostgreSQL server over the built-in wire client,
``pgwire.py``).
"""

from __future__ import annotations

import json
import logging
import sqlite3
import threading
import time
import uuid
from typing import Any

from fraud_detection_tpu_torch import config

log = logging.getLogger("fraud_detection_tpu_torch.db")

# Status enum (db/models.py:11-14)
PENDING = "PENDING"
COMPLETED = "COMPLETED"
FAILED = "FAILED"

MIGRATIONS: list[tuple[str, str]] = [
    (
        "0001_transaction_results",
        """
        CREATE TABLE IF NOT EXISTS transaction_results (
            transaction_id TEXT PRIMARY KEY,
            input_data TEXT NOT NULL,
            shap_values TEXT,
            expected_value REAL,
            prediction_score REAL,
            status TEXT NOT NULL DEFAULT 'PENDING',
            correlation_id TEXT,
            created_at REAL NOT NULL,
            updated_at REAL NOT NULL
        )
        """,
    ),
    (
        "0002_status_index",
        "CREATE INDEX IF NOT EXISTS idx_results_status ON transaction_results(status)",
    ),
]


def _sqlite_path(url: str) -> str:
    # sqlite:///relative.db | sqlite:////abs/path.db | sqlite:///:memory:
    path = url[len("sqlite:///") :] if url.startswith("sqlite:///") else url
    return path or ":memory:"


class ReplicatedRows:
    """The replication hooks a store server (``netserver.py``) calls on a
    sqlite engine: whole rows of one table, keyed by ``_PK``, as plain
    dicts (the JSON columns left encoded: they cross the wire verbatim)."""

    _TABLE: str
    _PK: str

    def fetch_rows(self, ids: list[str]) -> list[dict]:
        if not ids:
            return []
        qs = ",".join("?" * len(ids))
        with self._lock:
            rows = self._conn.execute(
                f"SELECT * FROM {self._TABLE} WHERE {self._PK} IN ({qs})", ids
            ).fetchall()
        return [dict(r) for r in rows]

    def dump_rows(self) -> list[dict]:
        with self._lock:
            rows = self._conn.execute(f"SELECT * FROM {self._TABLE}").fetchall()
        return [dict(r) for r in rows]

    def apply_rows(self, rows: list[dict]) -> None:
        """Replica-side upsert of replicated rows (last writer wins by pk)."""
        with self._lock, self._conn:
            self._upsert(rows)

    def replace_rows(self, rows: list[dict]) -> None:
        """Snapshot application: delete, then upsert, in one transaction, so
        rows a demoted ex-primary wrote while partitioned don't survive the
        resync (the split-brain recovery)."""
        with self._lock, self._conn:
            self._conn.execute(f"DELETE FROM {self._TABLE}")
            self._upsert(rows)

    def _upsert(self, rows: list[dict]) -> None:
        if rows:
            cols = list(rows[0])
            self._conn.executemany(
                f"INSERT OR REPLACE INTO {self._TABLE} ({','.join(cols)}) "
                f"VALUES ({','.join('?' * len(cols))})",
                [[r[c] for c in cols] for r in rows],
            )


class SqliteResultsDB(ReplicatedRows):
    """Thread-safe store for transaction scoring/explanation results."""

    _TABLE, _PK = "transaction_results", "transaction_id"

    def __init__(self, url: str | None = None):
        self.url = url or config.database_url()
        self._lock = threading.Lock()
        self._conn = sqlite3.connect(
            _sqlite_path(self.url), check_same_thread=False, timeout=30.0
        )
        self._conn.row_factory = sqlite3.Row
        # the worker writes while the API reads the same file: WAL lets
        # readers proceed during commits
        self._conn.execute("PRAGMA journal_mode=WAL")
        self.applied_at_init = self.migrate()

    # -- migrations --------------------------------------------------------
    def migrate(self) -> list[str]:
        """Apply pending migrations; returns the ids applied."""
        applied = []
        with self._lock, self._conn:
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS schema_migrations ("
                "id TEXT PRIMARY KEY, applied_at REAL NOT NULL)"
            )
            done = {
                r["id"]
                for r in self._conn.execute("SELECT id FROM schema_migrations")
            }
            for mig_id, sql in MIGRATIONS:
                if mig_id in done:
                    continue
                self._conn.executescript(sql)
                self._conn.execute(
                    "INSERT INTO schema_migrations (id, applied_at) VALUES (?, ?)",
                    (mig_id, time.time()),
                )
                applied.append(mig_id)
        return applied

    # -- writes ------------------------------------------------------------
    def create_pending(
        self,
        transaction_id: str | None,
        input_data: dict,
        correlation_id: str | None = None,
    ) -> str:
        tx_id = transaction_id or str(uuid.uuid4())
        now = time.time()
        with self._lock, self._conn:
            self._conn.execute(
                "INSERT INTO transaction_results "
                "(transaction_id, input_data, status, correlation_id, created_at, updated_at) "
                "VALUES (?, ?, ?, ?, ?, ?) "
                "ON CONFLICT(transaction_id) DO UPDATE SET "
                "input_data=excluded.input_data, updated_at=excluded.updated_at",
                (tx_id, json.dumps(input_data), PENDING, correlation_id, now, now),
            )
        return tx_id

    def complete(
        self,
        transaction_id: str,
        shap_values: dict[str, float],
        expected_value: float,
        prediction_score: float,
    ) -> None:
        """Idempotent upsert (the reference's ON CONFLICT DO UPDATE,
        api/worker.py:90-99) marking COMPLETED."""
        now = time.time()
        with self._lock, self._conn:
            self._conn.execute(
                "INSERT INTO transaction_results "
                "(transaction_id, input_data, shap_values, expected_value, "
                " prediction_score, status, created_at, updated_at) "
                "VALUES (?, '{}', ?, ?, ?, ?, ?, ?) "
                "ON CONFLICT(transaction_id) DO UPDATE SET "
                "shap_values=excluded.shap_values, "
                "expected_value=excluded.expected_value, "
                "prediction_score=excluded.prediction_score, "
                "status=excluded.status, updated_at=excluded.updated_at",
                (
                    transaction_id,
                    json.dumps(shap_values),
                    expected_value,
                    prediction_score,
                    COMPLETED,
                    now,
                    now,
                ),
            )

    def fail(self, transaction_id: str, error: str) -> None:
        now = time.time()
        with self._lock, self._conn:
            # The WHERE guard keeps a late/duplicate failure report (e.g. a
            # worker whose nack response was lost while another worker went
            # on to complete the task) from clobbering a COMPLETED result.
            self._conn.execute(
                "INSERT INTO transaction_results "
                "(transaction_id, input_data, shap_values, status, created_at, updated_at) "
                "VALUES (?, '{}', ?, ?, ?, ?) "
                "ON CONFLICT(transaction_id) DO UPDATE SET "
                "shap_values=excluded.shap_values, status=excluded.status, "
                "updated_at=excluded.updated_at "
                "WHERE transaction_results.status != 'COMPLETED'",
                (transaction_id, json.dumps({"error": error}), FAILED, now, now),
            )

    # -- reads -------------------------------------------------------------
    def get(self, transaction_id: str) -> dict[str, Any] | None:
        with self._lock:
            row = self._conn.execute(
                "SELECT * FROM transaction_results WHERE transaction_id = ?",
                (transaction_id,),
            ).fetchone()
        if row is None:
            return None
        out = dict(row)
        for k in ("input_data", "shap_values"):
            if out.get(k):
                out[k] = json.loads(out[k])
        return out

    def count(self, status: str | None = None) -> int:
        with self._lock:
            if status:
                (n,) = self._conn.execute(
                    "SELECT COUNT(*) FROM transaction_results WHERE status = ?",
                    (status,),
                ).fetchone()
            else:
                (n,) = self._conn.execute(
                    "SELECT COUNT(*) FROM transaction_results"
                ).fetchone()
        return n

    def ping(self) -> bool:
        try:
            with self._lock:
                self._conn.execute("SELECT 1").fetchone()
            return True
        except Exception:
            # the health probe's contract is a bool; leave a trace
            log.debug("results-db ping failed", exc_info=True)
            return False

    def close(self) -> None:
        with self._lock:
            self._conn.close()


def ResultsDB(url: str | None = None):  # noqa: N802 — the JAX package's name
    """Open a results DB for ``url`` (default ``DATABASE_URL``):

    - ``sqlite:///path`` — stdlib SQLite in WAL mode (one host);
    - ``fraud://host:port`` — a store server (``netserver.py``);
    - ``sentinel://h:p,.../name`` — the primary a sentinel names, with
      failover (``netclient.py``);
    - ``postgresql://...`` — a PostgreSQL server over the built-in wire
      client (``pgwire.py``).
    """
    url = url or config.database_url()
    if url.startswith("sqlite"):
        return SqliteResultsDB(url)
    if url.startswith(("fraud://", "sentinel://")):
        from fraud_detection_tpu_torch.service.netclient import NetResultsDB

        return NetResultsDB(url)
    if url.startswith(("postgresql://", "postgres://")):
        from fraud_detection_tpu_torch.service.pgclient import PgResultsDB

        return PgResultsDB(url)
    raise NotImplementedError(
        f"backend for {url.split(':', 1)[0]} not available; use sqlite:///, "
        "fraud://, sentinel://, or postgresql://"
    )
