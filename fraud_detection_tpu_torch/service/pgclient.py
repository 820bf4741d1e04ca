"""PostgreSQL backends for the results DB and broker.

The port's own copy of the JAX package's ``service/pgclient.py``: the same
statements reach the server, so either package's API and worker share one
database.

``PgResultsDB`` / ``PgBroker`` reuse the *exact SQL* of the SQLite engines
(service/db.py, service/taskq.py — deliberately written in the PG/SQLite
common dialect) over the pure-Python wire client (pgwire.py). This is the
reference's actual persistence topology: one Postgres server shared by API
pods and worker pods over the network (db/db.py:6-14,
docker-compose.yml:38-57).

The adapter translates the three real dialect differences:

- ``?`` placeholders → ``$n`` (done in pgwire);
- ``REAL`` columns → ``DOUBLE PRECISION`` in DDL (PG's REAL is float4 —
  too coarse for epoch-seconds timestamps like ``visible_at``);
- ``INSERT OR REPLACE INTO t`` (the replication row surfaces
  apply_rows/replace_rows) → ``INSERT ... ON CONFLICT (pk) DO UPDATE``,
  keyed by a per-table primary-key map. Unknown tables raise rather than
  ship sqlite-only SQL to a real server.

Claim-loop concurrency note: the broker's claim uses the same guarded
``UPDATE ... WHERE id = ? AND status = ? AND visible_at <= ?`` as SQLite —
under PG's READ COMMITTED the re-check after the row lock makes lost races
return rowcount 0, which claim_many already treats as "another worker won".
"""

from __future__ import annotations

import re
import threading

from fraud_detection_tpu_torch.service import db as _db
from fraud_detection_tpu_torch.service import taskq as _taskq
from fraud_detection_tpu_torch.service.pgwire import PgConnection, Result


# Primary keys of the replicated tables, for the INSERT OR REPLACE →
# ON CONFLICT upsert translation. sqlite accepts the translated form too,
# so the emulator and real PG execute identical statements.
_UPSERT_PK = {
    "transaction_results": "transaction_id",
    "tasks": "id",
    "schema_migrations": "id",
}
_INSERT_OR_REPLACE = re.compile(
    r"^\s*INSERT\s+OR\s+REPLACE\s+INTO\s+(\w+)\s*\(([^)]*)\)", re.IGNORECASE
)


class _PgAdapter:
    """Duck-types the slice of sqlite3.Connection the engines use:
    execute/executescript/executemany + transaction context manager."""

    def __init__(self, dsn: str):
        self._pg = PgConnection(dsn)
        self.row_factory = None  # sqlite compat attr; rows are always mapping

    @staticmethod
    def _ddl(sql: str) -> str:
        sql = sql.replace(" REAL", " DOUBLE PRECISION")
        m = _INSERT_OR_REPLACE.match(sql)
        if m:
            table = m.group(1)
            cols = [c.strip() for c in m.group(2).split(",")]
            pk = _UPSERT_PK.get(table)
            if pk is None:
                raise ValueError(
                    f"INSERT OR REPLACE into unmapped table {table!r}: add "
                    "its primary key to pgclient._UPSERT_PK"
                )
            sets = ", ".join(f"{c} = EXCLUDED.{c}" for c in cols if c != pk)
            sql = _INSERT_OR_REPLACE.sub(
                f"INSERT INTO {table} ({', '.join(cols)})", sql, count=1
            )
            clause = f"DO UPDATE SET {sets}" if sets else "DO NOTHING"
            sql += f" ON CONFLICT ({pk}) {clause}"
        if re.search(r"INSERT\s+OR\s+REPLACE", sql, re.IGNORECASE):
            # a shape the rewrite regex didn't match (no column list, quoted
            # table, …): the emulator's sqlite would accept it and hide the
            # bug until a real server rejects it — fail loudly instead
            raise ValueError(f"untranslatable sqlite-only SQL: {sql[:120]!r}")
        return sql

    def execute(self, sql: str, params: tuple | list = ()) -> Result:
        return self._pg.execute(self._ddl(sql), params)

    def executescript(self, sql: str) -> None:
        self._pg.execute_simple(self._ddl(sql))

    def executemany(self, sql: str, seq) -> None:
        sql = self._ddl(sql)  # translate once, not per row
        for params in seq:
            self._pg.execute(sql, params)

    def __enter__(self):
        self._pg.execute_simple("BEGIN")
        return self

    def __exit__(self, exc_type, *exc):
        self._pg.execute_simple("ROLLBACK" if exc_type else "COMMIT")

    def close(self) -> None:
        self._pg.close()


class PgResultsDB(_db.SqliteResultsDB):
    def __init__(self, url: str):
        self.url = url
        self._lock = threading.Lock()
        self._conn = _PgAdapter(url)
        self.applied_at_init = self.migrate()


class PgBroker(_taskq.SqliteBroker):
    def __init__(self, url: str):
        self.url = url
        self._lock = threading.Lock()
        self.redeliveries = 0
        self.expired_claims = 0
        self._conn = _PgAdapter(url)
        with self._lock, self._conn:
            self._conn.executescript(
                """
                CREATE TABLE IF NOT EXISTS tasks (
                    id TEXT PRIMARY KEY,
                    name TEXT NOT NULL,
                    args TEXT NOT NULL,
                    correlation_id TEXT,
                    status TEXT NOT NULL DEFAULT 'QUEUED',
                    attempts INTEGER NOT NULL DEFAULT 0,
                    max_retries INTEGER NOT NULL DEFAULT 5,
                    visible_at DOUBLE PRECISION NOT NULL,
                    claimed_by TEXT,
                    created_at DOUBLE PRECISION NOT NULL,
                    updated_at DOUBLE PRECISION NOT NULL,
                    error TEXT
                )
                """
            )
            self._conn.executescript(
                "CREATE INDEX IF NOT EXISTS idx_tasks_claim "
                "ON tasks(status, visible_at)"
            )
