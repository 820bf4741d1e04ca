"""Durable lifecycle state: labeled feedback and the conductor's state
machine.

The port's copy of the JAX package's ``lifecycle/store.py``, on the same
sqlite schema, so a JAX worker and a port app can share one database. Two
tables beside the task queue (``LIFECYCLE_DB_URL``, defaulting to the
broker database):

- ``feedback_rows`` — append-only labeled feedback in two pools:

  * **window**: the most recent ``CONDUCTOR_FEEDBACK_WINDOW`` rows (oldest
    pruned) — the slice the challenger gate evaluates on;
  * **reservoir**: a uniform-over-history sample of fixed size (reservoir
    sampling with slot-addressed replacement; ``seen`` persisted so the
    uniformity survives restarts) — the replay mix that keeps old regimes
    in the retraining set after the window has forgotten them.

  A row lands in the window always and in the reservoir with probability
  ``R/seen``; both pools are kept in one transaction a batch. Rows carry
  their entity and event time (``entity``, ``ts``) for the ledger's replay.

- ``lifecycle_state`` — one row a model name: the conductor's state
  (``idle → retraining → gated → shadowing → promoting → done/rolled_back``,
  with ``rolling_back`` as the persisted rollback intent), the challenger
  and champion versions, the gate's evidence and the episode's owner.
  Transitions go through :meth:`LifecycleStore.transition`, a *single*
  guarded ``UPDATE ... WHERE state IN (...)``: sqlite holds the write lock
  for the whole statement, so the compare-and-set is atomic across
  processes, and a crashed worker resumes mid-step without
  double-promoting.

:func:`open_lifecycle_store` opens ``sqlite:///`` URLs, and PostgreSQL ones
over the network store tier's wire client (:class:`PgLifecycleStore`).
"""

from __future__ import annotations

import json
import logging
import sqlite3
import time
import uuid
from typing import Any, Iterable

import numpy as np

from fraud_detection_tpu_torch import config
from fraud_detection_tpu_torch.range.faults import fire
from fraud_detection_tpu_torch.utils import lockdep

log = logging.getLogger("fraud_detection_tpu_torch.lifecycle")

WINDOW = "window"
RESERVOIR = "reservoir"

# State machine vocabulary: terminal states re-arm to a new
# episode via begin-retrain. ROLLING_BACK is the persisted promotion-rollback
# intent — recorded before any alias moves so a crash mid-rollback resumes.
IDLE = "idle"
RETRAINING = "retraining"
GATED = "gated"
SHADOWING = "shadowing"
PROMOTING = "promoting"
ROLLING_BACK = "rolling_back"
DONE = "done"
ROLLED_BACK = "rolled_back"
STATES = (
    IDLE, RETRAINING, GATED, SHADOWING, PROMOTING, ROLLING_BACK, DONE,
    ROLLED_BACK,
)

# Columns of lifecycle_state a transition may set (everything but the PK and
# updated_at, which the CAS always stamps).
_FIELD_COLS = (
    "challenger_version", "champion_version", "reason", "gate", "owner",
)

_SCHEMA = [
    """
    CREATE TABLE IF NOT EXISTS feedback_rows (
        id TEXT PRIMARY KEY,
        seq INTEGER NOT NULL,
        pool TEXT NOT NULL,
        slot INTEGER,
        features TEXT NOT NULL,
        score REAL NOT NULL,
        label INTEGER NOT NULL,
        created_at REAL NOT NULL,
        entity TEXT,
        ts REAL
    )
    """,
    "CREATE INDEX IF NOT EXISTS idx_feedback_pool_seq ON feedback_rows(pool, seq)",
    "CREATE INDEX IF NOT EXISTS idx_feedback_pool_slot ON feedback_rows(pool, slot)",
    """
    CREATE TABLE IF NOT EXISTS feedback_meta (
        key TEXT PRIMARY KEY,
        value TEXT NOT NULL
    )
    """,
    """
    CREATE TABLE IF NOT EXISTS lifecycle_state (
        name TEXT PRIMARY KEY,
        state TEXT NOT NULL,
        challenger_version INTEGER,
        champion_version INTEGER,
        reason TEXT,
        gate TEXT,
        owner TEXT,
        updated_at REAL NOT NULL
    )
    """,
]


def _sqlite_path(url: str) -> str:
    return url[len("sqlite:///") :] if url.startswith("sqlite:///") else url


class LifecycleStore:
    """The sqlite store. Every query is written in the PG/SQLite common
    dialect (no AUTOINCREMENT, no INSERT OR REPLACE), so
    :class:`PgLifecycleStore` inherits them."""

    def __init__(
        self,
        url: str | None = None,
        window_size: int | None = None,
        reservoir_size: int | None = None,
        seed: int = 0,
    ):
        self.url = url or config.lifecycle_db_url()
        self.window_size = int(
            window_size
            if window_size is not None
            else config.conductor_feedback_window()
        )
        self.reservoir_size = int(
            reservoir_size
            if reservoir_size is not None
            else config.conductor_reservoir_size()
        )
        self._rng = np.random.default_rng(seed)
        self._lock = lockdep.lock("lifecycle.store")
        self._connect()
        with self._lock, self._conn:
            for stmt in _SCHEMA:
                self._conn.executescript(stmt)
        # stores created before the owner column existed: best-effort add
        # (its own transaction — a PG error aborts the enclosing txn)
        with self._lock:
            try:
                with self._conn:
                    self._conn.execute(
                        "ALTER TABLE lifecycle_state ADD COLUMN owner TEXT"
                    )
            except Exception:
                # column already present (the common case: CREATE TABLE
                # above ships it; only pre-owner stores need the ALTER)
                log.debug("lifecycle owner column migration skipped",
                          exc_info=True)
        # ledger: pre-ledger stores lack the entity/ts feedback columns
        for col_ddl in ("entity TEXT", "ts REAL"):
            with self._lock:
                try:
                    with self._conn:
                        self._conn.execute(
                            f"ALTER TABLE feedback_rows ADD COLUMN {col_ddl}"
                        )
                except Exception:
                    log.debug(
                        "feedback %s column migration skipped", col_ddl,
                        exc_info=True,
                    )

    def _connect(self) -> None:
        import os

        path = _sqlite_path(self.url)
        if path != ":memory:" and os.path.dirname(path):
            os.makedirs(os.path.dirname(path), exist_ok=True)
        self._conn = sqlite3.connect(path, check_same_thread=False, timeout=30.0)
        self._conn.row_factory = sqlite3.Row
        self._conn.execute("PRAGMA journal_mode=WAL")

    # -- feedback ----------------------------------------------------------
    def _meta_get(self, key: str, default: int = 0) -> int:
        row = self._conn.execute(
            "SELECT value FROM feedback_meta WHERE key = ?", (key,)
        ).fetchone()
        return int(row["value"]) if row else default

    def _meta_set(self, key: str, value: int) -> None:
        cur = self._conn.execute(
            "UPDATE feedback_meta SET value = ? WHERE key = ?",
            (str(int(value)), key),
        )
        if cur.rowcount == 0:
            self._conn.execute(
                "INSERT INTO feedback_meta (key, value) VALUES (?, ?)",
                (key, str(int(value))),
            )

    def add_feedback(
        self, features: Iterable, scores: Iterable, labels: Iterable,
        entity_ids=None, timestamps=None,
    ) -> int:
        """Append one labeled batch; returns rows ingested. One transaction
        per batch: a crash mid-batch loses the batch, never corrupts the
        reservoir's uniformity invariants (``seen`` commits with the rows).

        ``entity_ids``/``timestamps`` (ledger): per-row entity + event time
        so the conductor's retrain can replay feedback through the velocity
        aggregator in timestamp order. Optional — rows without them replay
        through the null slot."""
        feats = np.asarray(features, np.float32)
        if feats.ndim == 1:
            feats = feats[None, :]
        scores = np.asarray(scores, np.float64).reshape(-1)
        labels = np.asarray(labels).reshape(-1)
        # fraud-range injection point: the poisoned-feedback drill corrupts
        # the batch in flight here; the guards below are the blast door
        fire(
            "lifecycle.store.add_feedback",
            features=feats, scores=scores, labels=labels,
        )
        n = feats.shape[0]
        if not (scores.shape[0] == n and labels.shape[0] == n):
            raise ValueError("features/scores/labels must have equal length")
        # Poison guard: this store feeds the conductor's retrain replay and
        # the challenger gate — a NaN/Inf row or out-of-range score would
        # silently corrupt the training mix and NaN the gate statistics
        # (which fail closed, bricking promotion). /monitor/feedback
        # validates at the API edge; queue-delivered feedback
        # (lifecycle.record_feedback) and embedded callers land here, so
        # the store is the boundary that must hold.
        if not np.all(np.isfinite(feats)):
            raise ValueError("feedback features must be finite")
        if not (
            np.all(np.isfinite(scores))
            and np.all((scores >= 0.0) & (scores <= 1.0))
        ):
            raise ValueError("feedback scores must be probabilities in [0, 1]")
        if not np.all((labels == 0) | (labels == 1)):
            raise ValueError("feedback labels must be 0 or 1")
        ents: list = list(entity_ids) if entity_ids is not None else [None] * n
        tss: list = list(timestamps) if timestamps is not None else [None] * n
        if len(ents) != n or len(tss) != n:
            raise ValueError("entity_ids/timestamps must align with features")
        ents = [None if e is None else str(e) for e in ents]
        for t in tss:
            if t is not None and not (float(t) > 0 and np.isfinite(float(t))):
                raise ValueError("timestamps must be positive finite numbers")
        tss = [None if t is None else float(t) for t in tss]
        now = time.time()
        with self._lock, self._conn:
            seq = self._meta_get("seq")
            seen = self._meta_get("reservoir_seen")
            res_count = self._count(RESERVOIR)
            for i in range(n):
                seq += 1
                payload = json.dumps([float(v) for v in feats[i]])
                self._conn.execute(
                    "INSERT INTO feedback_rows (id, seq, pool, slot, features,"
                    " score, label, created_at, entity, ts)"
                    " VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
                    (
                        uuid.uuid4().hex, seq, WINDOW, None, payload,
                        float(scores[i]), int(labels[i]), now,
                        ents[i], tss[i],
                    ),
                )
                # reservoir sampling (Vitter's R): row i of history occupies
                # each slot with probability R/seen at every point in time
                seen += 1
                if res_count < self.reservoir_size:
                    slot = res_count
                    res_count += 1
                else:
                    j = int(self._rng.integers(seen))
                    slot = j if j < self.reservoir_size else None
                if slot is not None:
                    self._conn.execute(
                        "DELETE FROM feedback_rows WHERE pool = ? AND slot = ?",
                        (RESERVOIR, slot),
                    )
                    self._conn.execute(
                        "INSERT INTO feedback_rows (id, seq, pool, slot,"
                        " features, score, label, created_at, entity, ts)"
                        " VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
                        (
                            uuid.uuid4().hex, seq, RESERVOIR, slot, payload,
                            float(scores[i]), int(labels[i]), now,
                            ents[i], tss[i],
                        ),
                    )
            self._meta_set("seq", seq)
            self._meta_set("reservoir_seen", seen)
            # prune the window to its bound (oldest first)
            excess = self._count(WINDOW) - self.window_size
            if excess > 0:
                self._conn.execute(
                    "DELETE FROM feedback_rows WHERE pool = ? AND seq <= ("
                    "SELECT seq FROM feedback_rows WHERE pool = ? "
                    "ORDER BY seq LIMIT 1 OFFSET ?)",
                    (WINDOW, WINDOW, excess - 1),
                )
        return n

    def _count(self, pool: str) -> int:
        row = self._conn.execute(
            "SELECT COUNT(*) AS n FROM feedback_rows WHERE pool = ?", (pool,)
        ).fetchone()
        return int(row["n"])

    def _rows(self, pool: str, limit: int | None = None):
        sql = (
            "SELECT features, score, label, entity, ts FROM feedback_rows "
            "WHERE pool = ? ORDER BY seq DESC"
        )
        params: list[Any] = [pool]
        if limit is not None:
            sql += " LIMIT ?"
            params.append(int(limit))
        return self._conn.execute(sql, params).fetchall()

    @staticmethod
    def _unpack(rows) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        if not rows:
            return (
                np.zeros((0, 0), np.float32),
                np.zeros((0,), np.float32),
                np.zeros((0,), np.int32),
            )
        x = np.asarray([json.loads(r["features"]) for r in rows], np.float32)
        s = np.asarray([r["score"] for r in rows], np.float32)
        y = np.asarray([r["label"] for r in rows], np.int32)
        return x, s, y

    @staticmethod
    def _unpack_meta(rows) -> tuple[list, np.ndarray]:
        """Ledger columns for a fetched row set: (entities, timestamps) —
        entity None / ts 0.0 for rows persisted before the columns existed
        (they replay through the null slot)."""
        if not rows:
            return [], np.zeros((0,), np.float32)
        ents = [r["entity"] for r in rows]
        ts = np.asarray(
            [r["ts"] if r["ts"] is not None else 0.0 for r in rows],
            np.float32,
        )
        return ents, ts

    def window_rows(
        self, limit: int | None = None
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Most-recent-first labeled window → (features, scores, labels)."""
        with self._lock:
            return self._unpack(self._rows(WINDOW, limit))

    def window_rows_meta(self, limit: int | None = None):
        """Window rows WITH the ledger columns →
        ``(features, scores, labels, entities, timestamps)`` — one fetch,
        so rows and their replay metadata can never misalign."""
        with self._lock:
            rows = self._rows(WINDOW, limit)
            return (*self._unpack(rows), *self._unpack_meta(rows))

    def reservoir_rows(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The uniform-over-history replay sample."""
        with self._lock:
            return self._unpack(self._rows(RESERVOIR))

    def reservoir_rows_meta(self):
        """Reservoir rows WITH the ledger columns (see window_rows_meta)."""
        with self._lock:
            rows = self._rows(RESERVOIR)
            return (*self._unpack(rows), *self._unpack_meta(rows))

    def feedback_counts(self) -> dict:
        with self._lock:
            return {
                "window": self._count(WINDOW),
                "reservoir": self._count(RESERVOIR),
                "seen": self._meta_get("reservoir_seen"),
            }

    # -- conductor state machine -------------------------------------------
    def get_state(self, name: str) -> dict:
        # fraud-range injection point: a chaos plan stalls/errors the
        # lifecycle store read here — the /lifecycle/status degradation
        # drill (503 + Retry-After instead of a hung 500)
        fire("lifecycle.store.get_state", name=name)
        with self._lock:
            row = self._conn.execute(
                "SELECT * FROM lifecycle_state WHERE name = ?", (name,)
            ).fetchone()
        if row is None:
            return {
                "name": name, "state": IDLE, "challenger_version": None,
                "champion_version": None, "reason": None, "gate": None,
                "owner": None, "updated_at": None,
            }
        d = dict(row)
        d["gate"] = json.loads(d["gate"]) if d.get("gate") else None
        return d

    def _write_state(self, name: str, state: str, fields: dict) -> None:
        gate = fields.get("gate")
        vals = (
            state,
            fields.get("challenger_version"),
            fields.get("champion_version"),
            fields.get("reason"),
            json.dumps(gate) if gate is not None else None,
            fields.get("owner"),
            time.time(),
        )
        cur = self._conn.execute(
            "UPDATE lifecycle_state SET state = ?, challenger_version = ?, "
            "champion_version = ?, reason = ?, gate = ?, owner = ?, "
            "updated_at = ? WHERE name = ?",
            vals + (name,),
        )
        if cur.rowcount == 0:
            self._conn.execute(
                "INSERT INTO lifecycle_state (state, challenger_version, "
                "champion_version, reason, gate, owner, updated_at, name) "
                "VALUES (?, ?, ?, ?, ?, ?, ?, ?)",
                vals + (name,),
            )

    def set_state(self, name: str, state: str, **fields) -> None:
        """Unconditional write (operator override path; the conductor itself
        uses :meth:`transition`)."""
        if state not in STATES:
            raise ValueError(f"unknown lifecycle state {state!r}")
        with self._lock, self._conn:
            self._write_state(name, state, fields)

    def transition(
        self,
        name: str,
        from_states: Iterable[str],
        to_state: str,
        *,
        owner_guard: str | None = None,
        **fields,
    ) -> bool:
        """Compare-and-set: move to ``to_state`` only if the current state is
        in ``from_states``; fields not named keep their value. Returns False
        on a lost race / wrong precondition — the caller's idempotency
        signal.

        The CAS is ONE guarded UPDATE (state — and owner, when
        ``owner_guard`` is given — checked in the WHERE clause), so it is
        atomic across processes and replicas, not merely under the
        per-process lock: concurrent callers serialize on the row and the
        loser's re-checked predicate yields rowcount 0 in both dialects
        (sqlite holds the write lock for the whole statement; PG READ
        COMMITTED re-evaluates the predicate after the row lock). A name
        never written before is implicitly IDLE; it is materialized with a
        PK-guarded insert (``ON CONFLICT DO NOTHING`` — a lost race
        collapses to a no-op) so the UPDATE stays the single decision
        point."""
        if to_state not in STATES:
            raise ValueError(f"unknown lifecycle state {to_state!r}")
        unknown = set(fields) - set(_FIELD_COLS)
        if unknown:
            raise ValueError(
                f"unknown lifecycle_state fields {sorted(unknown)}"
            )
        froms = tuple(from_states)
        # database clock, same as heartbeat/reclaim: the stamp a transition
        # into RETRAINING writes is the first value the staleness predicate
        # reads, so it must not come from a (possibly skewed) host clock
        now = self._db_now()
        sets, vals = ["state = ?", "updated_at = ?"], [to_state, now]
        for col in _FIELD_COLS:
            if col in fields:
                v = fields[col]
                if col == "gate" and v is not None:
                    v = json.dumps(v)
                sets.append(f"{col} = ?")
                vals.append(v)
        where = f"name = ? AND state IN ({', '.join('?' * len(froms))})"
        vals += [name, *froms]
        if owner_guard is not None:
            where += " AND owner = ?"
            vals.append(owner_guard)
        with self._lock, self._conn:
            if IDLE in froms and owner_guard is None:
                self._conn.execute(
                    "INSERT INTO lifecycle_state (name, state, updated_at) "
                    "VALUES (?, ?, ?) ON CONFLICT (name) DO NOTHING",
                    (name, IDLE, now),
                )
            cur = self._conn.execute(
                f"UPDATE lifecycle_state SET {', '.join(sets)} WHERE {where}",
                vals,
            )
            return cur.rowcount == 1

    def _db_now(self) -> float:
        """Epoch seconds on the DATABASE's clock. Heartbeat stamps and the
        staleness predicate must read one clock — comparing two hosts'
        ``time.time()`` lets clock skew eat into (or inflate) the stale
        threshold. A sqlite file is host-local, so the host clock IS the
        database clock (a PostgreSQL store asks its server)."""
        return time.time()

    def heartbeat(self, name: str, owner: str) -> bool:
        """Refresh the liveness stamp of an owned RETRAINING episode. The
        retrain executor beats immediately and then every ``stale_after /
        3`` seconds; resume() treats a row whose stamp is older than
        ``stale_after`` as a dead owner's."""
        now = self._db_now()
        with self._lock, self._conn:
            cur = self._conn.execute(
                "UPDATE lifecycle_state SET updated_at = ? "
                "WHERE name = ? AND state = ? AND owner = ?",
                (now, name, RETRAINING, owner),
            )
            return cur.rowcount == 1

    def reclaim_stale_retrain(self, name: str, stale_after: float) -> bool:
        """Atomically reset a RETRAINING row to IDLE iff its heartbeat is at
        least ``stale_after`` seconds old — the guarded steal resume() uses
        so only a provably dead owner's episode gets re-run. The staleness
        predicate lives inside the UPDATE: a live owner's concurrent
        heartbeat makes the steal lose (rowcount 0) instead of hijacking a
        running fit. Both sides of the comparison come from the database's
        clock (:meth:`_db_now`), so cross-replica host skew cannot fake or
        mask staleness."""
        now = self._db_now()
        with self._lock, self._conn:
            cur = self._conn.execute(
                "UPDATE lifecycle_state SET state = ?, owner = NULL, "
                "updated_at = ?, reason = ? WHERE name = ? AND state = ? "
                "AND updated_at <= ?",
                (
                    IDLE, now, "reclaimed stale retrain episode", name,
                    RETRAINING, now - float(stale_after),
                ),
            )
            return cur.rowcount == 1

    # -- plumbing ----------------------------------------------------------
    def ping(self) -> bool:
        try:
            with self._lock:
                self._conn.execute("SELECT 1").fetchone()
            return True
        except Exception:
            log.debug("lifecycle store ping failed", exc_info=True)
            return False

    def close(self) -> None:
        with self._lock:
            self._conn.close()


class PgLifecycleStore(LifecycleStore):
    """The same queries over PostgreSQL through the pgwire adapter."""

    def _connect(self) -> None:
        from fraud_detection_tpu_torch.service.pgclient import _PgAdapter

        self._conn = _PgAdapter(self.url)

    def _db_now(self) -> float:
        try:
            with self._lock:
                row = self._conn.execute(
                    "SELECT EXTRACT(EPOCH FROM now()) AS t"
                ).fetchone()
            return float(row["t"])
        except Exception:
            # a peer without EXTRACT (the protocol emulator): the host clock,
            # as the sqlite store reads it
            log.debug("db clock unavailable; using host clock", exc_info=True)
            return time.time()


def open_lifecycle_store(url: str | None = None, **kw) -> LifecycleStore:
    """Scheme dispatch mirroring the broker's: ``sqlite:///path`` or
    ``postgresql://``."""
    url = url or config.lifecycle_db_url()
    if url.startswith("sqlite"):
        return LifecycleStore(url, **kw)
    if url.startswith(("postgresql://", "postgres://")):
        return PgLifecycleStore(url, **kw)
    raise NotImplementedError(
        f"lifecycle store backend for {url.split(':', 1)[0]} not available; "
        "use sqlite:/// or postgresql:// (set LIFECYCLE_DB_URL)"
    )
