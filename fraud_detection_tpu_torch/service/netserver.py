"""Network store server: results DB + task broker over one TCP endpoint.

The port's own copy of the JAX package's ``service/netserver.py``: the same
ops, frames, replication stream and ``state.json``, so a replica of either
package follows a primary of the other, and a data directory one package's
server wrote is served by the other's. It imports no ``torch``: a store pod
needs no card.

This is the multi-node tier the reference gets from Postgres + Redis
(docker-compose.yml:4-57): one stateful server process that API pods,
worker pods, and KEDA's scaling signal all talk to over the network, so
worker replicas on *different nodes* share one queue and one results table
(a ``sqlite:///`` file is single-host only).

Design:

- The server *hosts* the existing SQLite-WAL engines (`SqliteResultsDB`,
  `SqliteBroker`) on its local disk and exposes their exact method surface
  over the framed-JSON protocol (wire.py). Clients (netclient.py) mirror
  the surface, so ``ResultsDB("fraud://host:port")`` is a drop-in.
- **Replication**: a replica connects with ``subscribe`` and receives a
  full snapshot followed by row-level upserts (primary-computed rows, so
  replay is deterministic — no re-execution of time-dependent logic).
  Semi-synchronous, where the JAX package's server is asynchronous: a
  write is answered only once its row frame has been handed to every live
  replica's connection, so a primary process that dies after answering
  (SIGKILL, OOM) loses no acknowledged write — the kernel still delivers
  what it was handed. A replica that takes longer than ``SHIP_WAIT`` is
  marked lagging and not waited for until it catches up, so a stalled
  replica costs one write ``SHIP_WAIT`` and no more; while a replica lags,
  or when none is connected, an acked write can be lost if the primary
  dies before the row ships, as in the JAX server (or if the primary's
  host dies with the frame unsent). Failover preserves at-least-once task
  delivery (the queue's visibility-timeout redelivery covers the gap).
- **Failover**: a replica accepts ``promote`` (from sentinel.py) and
  becomes a writable primary; writes to a replica fail fast with
  ``kind="readonly"`` so clients re-resolve the primary. A rejoining stale
  primary is sent ``demote`` by the sentinels (split-brain recovery): it
  becomes a replica of the elected primary and *replaces* its local state
  with the primary's snapshot, discarding partitioned writes.
- **Durable role/epoch** (``state.json`` in the data dir): role, upstream,
  and a failover epoch (bumped on every promote) survive restarts and are
  honored OVER the ordinal/argv bootstrap — the Redis-Sentinel
  config-rewrite analogue. Without it, a full tier restart after a
  failover would resurrect stale pod-0 as primary and the snapshot resync
  would permanently delete every post-failover write. Snapshots carry the
  primary's epoch; a replica REFUSES snapshot-replace from a lower-epoch
  upstream (a stale pre-failover primary) and keeps retrying until the
  sentinels demote it.
- **Auth**: when ``FRAUD_STORE_TOKEN`` is set, every frame must carry the
  shared secret (constant-time compare) — the credential-equivalent of the
  reference's Postgres password. The listener binds loopback by default;
  container topologies pass ``--host 0.0.0.0`` explicitly.

Run: ``python -m fraud_detection_tpu_torch.service.netserver --port 7600
--data-dir /var/lib/fraudstore [--replicate-from host:port]
[--metrics-port 9600]``.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import queue
import socket
import threading
import time
from typing import Any

from fraud_detection_tpu_torch import config
from fraud_detection_tpu_torch.service import metrics
from fraud_detection_tpu_torch.service.db import SqliteResultsDB
from fraud_detection_tpu_torch.service.taskq import DEFAULT_MAX_RETRIES, SqliteBroker
from fraud_detection_tpu_torch.utils import lockdep
from fraud_detection_tpu_torch.service.wire import (
    AUTH_REJECTION,
    CONN_STALL_TIMEOUT,
    attach_auth,
    check_auth,
    parse_hostport,
    recv_frame,
    send_frame,
)

log = logging.getLogger("fraud_detection_tpu_torch.netserver")

HEARTBEAT_INTERVAL = 1.0
RESYNC_INTERVAL = 0.5
# Per-subscriber replication buffer: a replica that stops draining (hung
# process, dead TCP peer) would otherwise grow its queue without bound on
# the primary. On overflow the subscriber is dropped; it reconnects and
# resyncs from a fresh snapshot — same recovery as any disconnect.
REPL_QUEUE_MAX = 1024
# The longest a write's answer waits for its row frame to reach a replica's
# connection before that replica is marked lagging (module docstring).
SHIP_WAIT = 1.0

PRIMARY = "primary"
REPLICA = "replica"


class StoreServer:
    def __init__(
        self,
        data_dir: str,
        host: str = "127.0.0.1",
        port: int = 0,
        replicate_from: str | None = None,
        auth_token: str | None = None,
    ):
        os.makedirs(data_dir, exist_ok=True)
        self.data_dir = data_dir
        self.db = SqliteResultsDB(f"sqlite:///{os.path.join(data_dir, 'results.db')}")
        self.broker = SqliteBroker(f"sqlite:///{os.path.join(data_dir, 'queue.db')}")
        self.host, self.port = host, port
        self.role = REPLICA if replicate_from else PRIMARY
        self.replicate_from = replicate_from
        self.auth_token = config.store_token() if auth_token is None else auth_token
        self.seq = 0
        self.epoch = 0  # failover counter; bumped on every promote
        st = self._load_state()
        if st is not None:
            # Durable role beats ordinal/argv bootstrap: after a failover,
            # a restarted stale pod-0 must come back as a REPLICA of the
            # promoted node, not as the primary its StatefulSet args say.
            self.role = st.get("role", self.role)
            self.epoch = int(st.get("epoch", 0))
            self.seq = int(st.get("seq", 0))
            if self.role == REPLICA:
                self.replicate_from = st.get("replicate_from", self.replicate_from)
            else:
                self.replicate_from = None
            log.info(
                "restored durable state: role=%s upstream=%s epoch=%d seq=%d",
                self.role, self.replicate_from, self.epoch, self.seq,
            )
        self._save_state()
        # Bumped on every role/upstream change (promote, demote/re-point):
        # a replica loop only applies frames while its spawn generation is
        # current, so a re-point or promote↔demote flap can't leave an old
        # loop applying stale frames alongside (or instead of) the new one.
        self.repl_gen = 0
        # RLock: writes capture their row image and publish under the same
        # critical section (_dispatch → _publish), so a slower writer can't
        # publish an older row image with a newer seq (replica staleness).
        self._pub_lock = lockdep.rlock("netstore.pub")
        self._subs: list[queue.Queue] = []
        # the semi-synchronous hand-off: the newest seq each subscriber has
        # sent, the subscribers not waited for, and the (seq, subscribers)
        # a handler thread's write must see shipped before it answers
        self._shipped = threading.Condition()
        self._sent: dict[queue.Queue, int] = {}
        self._lagging: set[queue.Queue] = set()
        self._pending = threading.local()
        self._last_state_save = 0.0
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._listener: socket.socket | None = None
        self._conns: set[socket.socket] = set()
        self._conns_lock = lockdep.lock("netstore.conns")

    # -- durable state -----------------------------------------------------
    def _state_path(self) -> str:
        return os.path.join(self.data_dir, "state.json")

    def _load_state(self) -> dict | None:
        try:
            with open(self._state_path()) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def _save_state(self, fsync: bool = True) -> None:
        """Atomically persist role/upstream/epoch/seq. Called on every role
        transition (and epoch adoption), mirroring Redis Sentinel's config
        rewrite — the restart bootstrap honors this file over argv.
        ``fsync=False`` for the throttled seq refresh on the write path."""
        tmp = self._state_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(
                {
                    "role": self.role,
                    "replicate_from": self.replicate_from,
                    "epoch": self.epoch,
                    "seq": self.seq,
                },
                f,
            )
            f.flush()
            if fsync:
                os.fsync(f.fileno())
        os.replace(tmp, self._state_path())

    def _maybe_save_seq(self) -> None:
        """Keep the durable seq within ~0.5 s of reality (call with
        _pub_lock held). Without this, a crash-restarted node restores the
        seq last written at its previous role transition — possibly 0 —
        and the sentinel's (epoch, seq) election can crown a LESS caught-up
        replica over it, snapshot-replacing away rows only the stale-seq
        node had. Sub-second staleness is on par with async replication
        lag; total staleness was the bug."""
        now = time.monotonic()
        if now - self._last_state_save >= 0.5:
            self._last_state_save = now
            self._save_state(fsync=False)

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        # the listener blocks in accept by design; stop()'s shutdown() wakes it
        # lockcheck: ignore[socket-no-timeout] (the reason above)
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((self.host, self.port))
        self.port = self._listener.getsockname()[1]
        self._listener.listen(64)
        t = threading.Thread(target=self._accept_loop, daemon=True)
        t.start()
        self._threads.append(t)
        if self.role == REPLICA:
            t = threading.Thread(
                target=self._replica_loop, args=(self.repl_gen,), daemon=True
            )
            t.start()
            self._threads.append(t)
        log.info("store server %s on %s:%d", self.role, self.host, self.port)

    def stop(self) -> None:
        self._stop.set()
        try:
            self._save_state()  # carry seq across clean restarts
        except OSError:
            pass
        if self._listener is not None:
            # shutdown() wakes the thread blocked in accept(); close() alone
            # leaves the open file description (and the LISTEN port) alive
            # until that accept returns.
            try:
                self._listener.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._listener.close()
            except OSError:
                pass
        with self._pub_lock:
            for q in self._subs:
                try:
                    # never block while holding _pub_lock: a stalled
                    # subscriber's queue may be full (it is bounded) and
                    # its consumer wedged — the conn close below (and the
                    # serve loop's heartbeat-timeout _stop check) unblocks it
                    q.put_nowait(None)
                except queue.Full:
                    pass
        with self._conns_lock:
            for c in list(self._conns):
                try:
                    c.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    c.close()
                except OSError:
                    pass
            self._conns.clear()

    def serve_forever(self) -> None:
        self.start()
        try:
            while not self._stop.is_set():
                time.sleep(0.2)
        finally:
            self.stop()

    # -- accept / dispatch -------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, addr = self._listener.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn.settimeout(CONN_STALL_TIMEOUT)
            with self._conns_lock:
                self._conns.add(conn)
            t = threading.Thread(target=self._handle, args=(conn,), daemon=True)
            t.start()

    def _handle(self, conn: socket.socket) -> None:
        try:
            while not self._stop.is_set():
                try:
                    req = recv_frame(conn)
                except TimeoutError:
                    # idle at a frame boundary; re-check _stop. (A mid-frame
                    # stall raises StalledPeerError — an OSError, not a
                    # TimeoutError — and drops the conn via the outer except.)
                    continue
                if req is None:
                    return
                if not check_auth(req, self.auth_token):
                    send_frame(conn, AUTH_REJECTION)
                    continue
                op = req.pop("op", None)
                if op == "subscribe":
                    self._serve_subscriber(conn)
                    return
                try:
                    self._pending.ship = None
                    result = self._dispatch(op, req)
                    self._await_shipped()
                    send_frame(conn, {"ok": True, "result": result})
                except _ReadOnly:
                    send_frame(
                        conn,
                        {"ok": False, "kind": "readonly",
                         "error": f"{op} rejected: server is a replica"},
                    )
                except Exception as e:  # surface server faults to the client
                    log.debug("op %r failed", op, exc_info=True)
                    send_frame(conn, {"ok": False, "kind": "error", "error": str(e)})
        except Exception:
            # client went away (or stalled); per-connection thread exits
            log.debug("connection handler exiting", exc_info=True)
        finally:
            with self._conns_lock:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _dispatch(self, op: str, a: dict[str, Any]) -> Any:
        # reads — allowed on any role (replicas serve monitoring/readbacks)
        if op == "ping":
            return {
                "role": self.role, "seq": self.seq, "epoch": self.epoch,
                "replicate_from": self.replicate_from,
            }
        if op == "info":
            return {
                "role": self.role,
                "seq": self.seq,
                "epoch": self.epoch,
                "replicate_from": self.replicate_from,
                "replicas": len(self._subs),
                "depth": self.broker.depth(),
                "results": self.db.count(),
            }
        if op == "db.get":
            return self.db.get(a["transaction_id"])
        if op == "db.count":
            return self.db.count(a.get("status"))
        if op == "q.depth":
            return self.broker.depth()
        if op == "q.get_status":
            return self.broker.get_status(a["task_id"])
        # role transitions
        if op == "promote":
            # Under _pub_lock: the replica apply loop holds the same lock
            # and re-checks role/generation, so no stale frame from the old
            # primary can land after promotion (it would overwrite acked
            # writes).
            with self._pub_lock:
                self.role = PRIMARY
                self.replicate_from = None
                self.repl_gen += 1
                # New reign: replicas use this to refuse snapshot-replace
                # from any still-running lower-epoch (pre-failover) primary,
                # and the durable write makes the promotion survive a full
                # tier restart.
                self.epoch += 1
                # promotion must be durable before any write observes PRIMARY
                # lockcheck: ignore[blocking-under-lock] (the reason above)
                self._save_state()
            log.warning("PROMOTED to primary (seq %d, epoch %d)", self.seq, self.epoch)
            return {"role": self.role}
        if op == "demote":
            # Sentinel found us running as a stale primary after a failover,
            # or is re-pointing a replica at the new primary. The role flip
            # happens under _pub_lock so no in-flight write can pass the
            # primary check and then commit after the snapshot-replace
            # resync discards partitioned state. The generation bump retires
            # any existing replica loop (still chained to the old upstream)
            # and a fresh loop is ALWAYS spawned — re-pointing must take
            # effect even when the old subscription is healthy.
            with self._pub_lock:
                self.replicate_from = a["replicate_from"]
                was = self.role
                self.role = REPLICA
                self.repl_gen += 1
                gen = self.repl_gen
                # demotion durable before releasing writers, or a crash resurrects a stale primary
                # lockcheck: ignore[blocking-under-lock] (the reason above)
                self._save_state()
            log.warning(
                "DEMOTED/re-pointed to replica of %s (was %s, seq %d)",
                self.replicate_from, was, self.seq,
            )
            t = threading.Thread(
                target=self._replica_loop, args=(gen,), daemon=True
            )
            t.start()
            self._threads.append(t)
            return {"role": self.role}
        # Writes — primary only. Role check, write, row-image capture, and
        # publish share one _pub_lock critical section: seq order == row-
        # image order, and a concurrent demote can't interleave.
        with self._pub_lock:
            if self.role != PRIMARY:
                raise _ReadOnly()
            if op == "db.create_pending":
                tx_id = self.db.create_pending(
                    a.get("transaction_id"), a["input_data"], a.get("correlation_id")
                )
                self._publish("transaction_results", self.db.fetch_rows([tx_id]))
                return tx_id
            if op == "db.complete":
                self.db.complete(
                    a["transaction_id"], a["shap_values"], a["expected_value"],
                    a["prediction_score"],
                )
                self._publish(
                    "transaction_results", self.db.fetch_rows([a["transaction_id"]])
                )
                return None
            if op == "db.fail":
                self.db.fail(a["transaction_id"], a["error"])
                self._publish(
                    "transaction_results", self.db.fetch_rows([a["transaction_id"]])
                )
                return None
            if op == "q.send_task":
                task_id = self.broker.send_task(
                    a["name"], a["args"], a.get("correlation_id"),
                    a.get("max_retries", DEFAULT_MAX_RETRIES),
                    a.get("countdown", 0.0),
                    task_id=a.get("task_id"),
                )
                self._publish("tasks", self.broker.fetch_rows([task_id]))
                return task_id
            if op == "q.claim_many":
                tasks = self.broker.claim_many(
                    a["worker_id"], a["limit"], a["visibility_timeout"]
                )
                self._publish("tasks", self.broker.fetch_rows([t.id for t in tasks]))
                return [t.__dict__ for t in tasks]
            if op == "q.ack":
                self.broker.ack(a["task_id"])
                self._publish("tasks", self.broker.fetch_rows([a["task_id"]]))
                return None
            if op == "q.nack":
                will_retry = self.broker.nack(
                    a["task_id"], a["countdown"], a.get("error", ""),
                    expected_attempts=a.get("expected_attempts"),
                    claimed_by=a.get("claimed_by"),
                )
                self._publish("tasks", self.broker.fetch_rows([a["task_id"]]))
                return will_retry
        raise ValueError(f"unknown op {op!r}")

    # -- replication (primary side) ----------------------------------------
    def _publish(self, table: str, rows: list[dict]) -> None:
        if not rows:
            return
        with self._pub_lock:
            self.seq += 1
            self._maybe_save_seq()
            msg = {"t": "rows", "table": table, "rows": rows, "seq": self.seq}
            stalled = []
            for q in self._subs:
                try:
                    q.put_nowait(msg)
                except queue.Full:
                    stalled.append(q)
            self._pending.ship = (self.seq, [q for q in self._subs if q not in stalled])
            for q in stalled:
                # Drop the laggard: make room for the poison pill. Its
                # serve thread picks it up at the next sub.get() — or, if
                # wedged mid-send to a dead peer, times out on the socket
                # (settimeout in _serve_subscriber) — closes the conn, and
                # the replica resyncs via snapshot on reconnect.
                self._subs.remove(q)
                try:
                    q.get_nowait()
                except queue.Empty:
                    pass
                q.put_nowait(None)
                log.warning(
                    "replication subscriber overflowed %d-message buffer; "
                    "dropped (will resync on reconnect)", REPL_QUEUE_MAX,
                )

    def _await_shipped(self) -> None:
        """Hold a write's answer until its row frame has been sent to every
        subscriber that was live at its publish and is neither gone nor
        lagging; mark those still behind after ``SHIP_WAIT`` lagging."""
        ship = self._pending.ship
        if ship is None:
            return
        seq, subs = ship

        def behind() -> list:
            return [q for q in subs if self._sent.get(q, -1) < seq
                    and q not in self._lagging and q in self._subs]

        with self._shipped:
            if not self._shipped.wait_for(lambda: not behind(), SHIP_WAIT):
                slow = behind()
                self._lagging.update(slow)
                log.warning("%d replica(s) did not take seq %d within %.1f s: "
                            "not waited for until they catch up", len(slow), seq, SHIP_WAIT)

    def _serve_subscriber(self, conn: socket.socket) -> None:
        """Snapshot + live row stream + heartbeats, until disconnect."""
        # A silently-dead peer (power loss, partition — no RST) wedges
        # send_frame once the TCP buffer fills; without a timeout this
        # thread would never consume its poison pill after an overflow
        # drop, leaking the thread+socket until TCP retransmission gives
        # up (~15 min). sendall() applies the timeout as a deadline on the
        # whole call, so a replica must drain each frame (snapshot
        # included) within the window or be dropped-and-resynced.
        conn.settimeout(10 * HEARTBEAT_INTERVAL)
        sub: queue.Queue = queue.Queue(maxsize=REPL_QUEUE_MAX)
        with self._pub_lock:
            # snapshot under the publish lock so no row-batch is lost between
            # the dump and the subscription becoming live
            snapshot = {
                "t": "snapshot",
                "seq": self.seq,
                "epoch": self.epoch,
                "results": self.db.dump_rows(),
                "tasks": self.broker.dump_rows(),
            }
            self._subs.append(sub)
        try:
            send_frame(conn, snapshot)
            while not self._stop.is_set():
                try:
                    msg = sub.get(timeout=HEARTBEAT_INTERVAL)
                except queue.Empty:
                    msg = {"t": "hb", "seq": self.seq}
                if msg is None:
                    return
                send_frame(conn, msg)
                if msg["t"] == "rows":
                    with self._shipped:
                        self._sent[sub] = msg["seq"]
                        if msg["seq"] >= self.seq:
                            self._lagging.discard(sub)  # caught up
                        self._shipped.notify_all()
        except OSError:
            pass
        finally:
            with self._pub_lock:
                if sub in self._subs:
                    self._subs.remove(sub)
            with self._shipped:
                self._sent.pop(sub, None)
                self._lagging.discard(sub)
                self._shipped.notify_all()

    # -- replication (replica side) ----------------------------------------
    def _gen_ok(self, gen: int) -> bool:
        return self.role == REPLICA and self.repl_gen == gen

    def _replica_loop(self, gen: int) -> None:
        """Subscribe to the upstream and apply its stream, for as long as
        this loop's spawn generation is current. Checked per frame (the
        upstream heartbeats every second), so a re-point or promotion
        retires this loop within ~1s even while its connection is healthy."""
        while not self._stop.is_set() and self._gen_ok(gen):
            host, port = parse_hostport(self.replicate_from, 7600)
            try:
                with socket.create_connection((host, port), timeout=5.0) as s:
                    s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                    s.settimeout(3 * HEARTBEAT_INTERVAL)
                    send_frame(s, attach_auth({"op": "subscribe"}, self.auth_token))
                    while not self._stop.is_set() and self._gen_ok(gen):
                        msg = recv_frame(s)
                        if msg is None:
                            break
                        if msg.get("kind") == "auth":
                            log.error("primary rejected replica auth")
                            self._stop.wait(5 * RESYNC_INTERVAL)
                            break
                        if msg["t"] == "snapshot":
                            up_epoch = int(msg.get("epoch", 0))
                            if up_epoch < self.epoch:
                                # Stale pre-failover primary (e.g. the whole
                                # tier restarted and pod-0's argv resurrected
                                # it before the sentinels demote it):
                                # replacing our state with its snapshot would
                                # permanently delete every post-failover
                                # write. Refuse, drop the link, retry — the
                                # sentinels will demote/re-point one of us.
                                log.error(
                                    "REFUSING snapshot from lower-epoch "
                                    "upstream %s (epoch %d < ours %d)",
                                    self.replicate_from, up_epoch, self.epoch,
                                )
                                # back off: every resubscribe makes the
                                # stale upstream serialize a full DB dump
                                # under its publish lock — don't hammer it
                                # at RESYNC_INTERVAL while the sentinels
                                # converge
                                self._stop.wait(5 * RESYNC_INTERVAL)
                                break
                            # Apply under _pub_lock with a generation
                            # re-check: a promote/re-point racing this recv
                            # must not let a stale frame from the old
                            # upstream overwrite newer state.
                            with self._pub_lock:
                                if not self._gen_ok(gen):
                                    break
                                self.db.replace_rows(msg["results"])
                                self.broker.replace_rows(msg["tasks"])
                                self.seq = msg["seq"]
                                if up_epoch != self.epoch:
                                    self.epoch = up_epoch
                                # resync state durable with the replaced rows
                                # lockcheck: ignore[blocking-under-lock] (the reason above)
                                self._save_state()
                            log.info(
                                "replica synced: %d results, %d tasks "
                                "(seq %d, epoch %d)",
                                len(msg["results"]), len(msg["tasks"]),
                                msg["seq"], self.epoch,
                            )
                        elif msg["t"] == "rows":
                            with self._pub_lock:
                                if not self._gen_ok(gen):
                                    break
                                if msg["table"] == "transaction_results":
                                    self.db.apply_rows(msg["rows"])
                                else:
                                    self.broker.apply_rows(msg["rows"])
                                self.seq = msg["seq"]
                                self._maybe_save_seq()
                        # "hb": keepalive only
            except OSError:
                pass
            if self._gen_ok(gen):
                self._stop.wait(RESYNC_INTERVAL)


class _ReadOnly(Exception):
    pass


def store_metrics(srv: StoreServer) -> list:
    """The store server's six series, read from ``srv`` at scrape time, in a
    registry of their own (apart from the API's series): the queue depth is
    the KEDA scaling signal, which must come from the store, not from
    workers that scale to zero."""
    registry: list = []
    # each series by its literal name, so the alert rule reads it here
    metrics.Gauge(
        "fraud_store_queue_depth",
        "Deliverable task backlog on this store server (KEDA signal)",
        registry=registry,
    ).set_function(srv.broker.depth)
    metrics.Gauge(
        "fraud_store_is_primary",
        "1 when this server is the writable primary",
        registry=registry,
    ).set_function(lambda: float(srv.role == PRIMARY))
    metrics.Gauge(
        "fraud_store_replication_seq",
        "Replication sequence number (replica lag = primary - replica)",
        registry=registry,
    ).set_function(lambda: float(srv.seq))
    metrics.Gauge(
        "fraud_store_failover_epoch",
        "Failover epoch (bumps on every promote; divergence across the "
        "tier means a stale reign is still serving)",
        registry=registry,
    ).set_function(lambda: float(srv.epoch))
    # at-least-once delivery for claims served by THIS store: monotonic
    # totals mirrored from the hosted broker engine
    metrics.Gauge(
        "fraud_store_taskq_redeliveries_total",
        "Task deliveries beyond the first served by this store "
        "(visibility-timeout expiry or nack retry)",
        registry=registry,
    ).set_function(lambda: float(srv.broker.redeliveries))
    metrics.Gauge(
        "fraud_store_taskq_expired_claims_total",
        "Claims whose visibility window lapsed before ack/nack on this "
        "store (worker death or stall mid-task)",
        registry=registry,
    ).set_function(lambda: float(srv.broker.expired_claims))
    return registry


def main() -> None:
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "--host", default="127.0.0.1",
        help="bind address; container topologies pass 0.0.0.0 explicitly",
    )
    ap.add_argument("--port", type=int, default=7600)
    ap.add_argument("--data-dir", default="./fraudstore")
    ap.add_argument(
        "--replicate-from", default=None,
        help="host:port of the primary; starts this server as a replica",
    )
    ap.add_argument(
        "--auth-token", default=None,
        help="shared secret (default: FRAUD_STORE_TOKEN env)",
    )
    ap.add_argument(
        "--metrics-port", type=int, default=0,
        help="Prometheus exposition port (0 = off): queue depth, role, "
        "replication seq, failover epoch, redeliveries, expired claims",
    )
    args = ap.parse_args()
    srv = StoreServer(
        args.data_dir, args.host, args.port,
        replicate_from=args.replicate_from, auth_token=args.auth_token,
    )
    if args.metrics_port:
        metrics.start_http_server(args.metrics_port, registry=store_metrics(srv),
                                  name="store-metrics")
        log.info("store metrics on :%d", args.metrics_port)
    srv.serve_forever()


if __name__ == "__main__":
    main()
