"""Clients for the network store tier (netserver.py) with HA failover.

The port's own copy of the JAX package's ``service/netclient.py``: the same
frames, ops, retry budget and failover path, so these clients drive either
package's store servers and sentinels.

``NetResultsDB`` / ``NetBroker`` mirror the method surface of the SQLite
engines, so the ``ResultsDB(url)`` / ``Broker(url)`` factories make them
drop-in across the API (service/app.py), the worker (service/worker.py), and
the tests.

URL forms (the Redis/Sentinel URL contract of the reference,
xai_tasks.py:59-60):

- ``fraud://host:port`` — direct connection to one store server;
- ``sentinel://h1:p1,h2:p2/mastername`` — ask each sentinel (sentinel.py)
  for the current primary of ``mastername``, then connect to it. On
  connection loss or a ``readonly`` rejection (we were talking to a
  demoted/stale server), the client re-resolves the primary and retries —
  this is the failover path that keeps ``/predict`` enqueuing and workers
  consuming across a primary death.

All calls are synchronous request/response over one pooled connection per
client instance (thread-safe via a lock; the service tier's call rates are
hundreds a second). ``chip_smoke.py`` phase 15 measures the round trips a
second on loopback.
"""

from __future__ import annotations

import random
import socket
import threading
import time
import uuid
from typing import Any

from fraud_detection_tpu_torch import config
from fraud_detection_tpu_torch.range.faults import fire
from fraud_detection_tpu_torch.service.errors import (
    BrokerError,
    DatabaseError,
    StoreAuthError,
    StoreError,
)
from fraud_detection_tpu_torch.service.taskq import (
    DEFAULT_MAX_RETRIES,
    DEFAULT_VISIBILITY_TIMEOUT,
    Task,
)
from fraud_detection_tpu_torch.service.wire import (
    attach_auth,
    parse_hostport,
    recv_frame,
    send_frame,
)

CONNECT_TIMEOUT = 3.0
CALL_TIMEOUT = 15.0
# Total attempts per call across reconnect/re-resolve. The backoff sum
# (7 sleeps of 0.05·2^k capped at 2 s ≈ 5.2 s) must exceed the sentinel's
# down_after (3 s default) plus promotion time, so a call issued the instant
# the primary dies survives into the post-failover world instead of
# crashing its caller.
RETRIES = 8
BACKOFF_BASE = 0.05  # seconds; doubles per attempt, capped at 2s
BACKOFF_CAP = 2.0


def _parse(url: str) -> tuple[str, list[tuple[str, int]], str]:
    """→ (mode, endpoints, master_name); mode ∈ {direct, sentinel}."""
    if url.startswith("fraud://"):
        rest = url[len("fraud://") :].rstrip("/")
        return "direct", [parse_hostport(rest, 7600)], ""
    if url.startswith("sentinel://"):
        rest = url[len("sentinel://") :]
        hosts, _, name = rest.partition("/")
        eps = [parse_hostport(h, 26379) for h in hosts.split(",") if h]
        return "sentinel", eps, name or "mymaster"
    raise ValueError(f"unsupported store URL {url!r}")


class _StoreClient:
    """One connection + resolve/retry machinery, shared by DB and broker."""

    error_cls: type[StoreError] = StoreError

    def __init__(self, url: str):
        self.url = url
        self.mode, self.endpoints, self.master_name = _parse(url)
        self.auth_token = config.store_token()
        self._lock = threading.Lock()
        self._sock: socket.socket | None = None

    def _frame(self, op: str, **kwargs: Any) -> dict[str, Any]:
        return attach_auth({"op": op, **kwargs}, self.auth_token)

    # -- connection management --------------------------------------------
    def _resolve_primary(self) -> tuple[str, int]:
        if self.mode == "direct":
            return self.endpoints[0]
        last_err: Exception | None = None
        for ep in self.endpoints:
            try:
                with socket.create_connection(ep, timeout=CONNECT_TIMEOUT) as s:
                    send_frame(
                        s, self._frame("s.get-master", name=self.master_name)
                    )
                    resp = recv_frame(s)
                if resp and resp.get("kind") == "auth":
                    # misconfiguration, not transience: skip the retry budget
                    raise StoreAuthError(
                        f"sentinel {ep} rejected credentials: "
                        + resp.get("error", "authentication failed")
                    )
                if resp and resp.get("ok") and resp["result"]:
                    m = resp["result"]
                    return m["host"], int(m["port"])
            except OSError as e:
                last_err = e
        raise self.error_cls(
            f"no sentinel could name a primary for {self.master_name!r}"
            + (f" (last error: {last_err})" if last_err else "")
        )

    def _connect(self) -> socket.socket:
        host, port = self._resolve_primary()
        s = socket.create_connection((host, port), timeout=CONNECT_TIMEOUT)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        s.settimeout(CALL_TIMEOUT)
        return s

    def _drop(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    # -- calls -------------------------------------------------------------
    def call(self, op: str, **kwargs: Any) -> Any:
        # fraud-range injection point: a chaos plan stalls or errors the
        # store/registry client here — the "registry stalled mid-promotion"
        # and retry-budget-exhaustion drills (zero-cost disarmed)
        fire("netclient.call", op=op)
        last_err: Exception | None = None
        with self._lock:
            for attempt in range(RETRIES):
                if attempt:
                    # Bounded exponential backoff with jitter: the jitter
                    # multiplier only stretches the delay (×1.0–1.25), so
                    # the budget still provably exceeds the sentinel's
                    # down_after + promotion window while desynchronizing a
                    # client herd that all saw the primary die at once.
                    delay = min(BACKOFF_BASE * 2 ** (attempt - 1), BACKOFF_CAP)
                    time.sleep(delay * (1.0 + 0.25 * random.random()))
                try:
                    if self._sock is None:
                        self._sock = self._connect()
                    send_frame(self._sock, self._frame(op, **kwargs))
                    resp = recv_frame(self._sock)
                    if resp is None:
                        raise OSError("server closed connection")
                except StoreAuthError:
                    raise  # misconfiguration, not transience: never retry
                except (OSError, StoreError) as e:
                    last_err = e
                    self._drop()
                    continue
                if resp.get("ok"):
                    return resp["result"]
                if resp.get("kind") == "readonly":
                    # stale primary (we're mid-failover): re-resolve + retry
                    last_err = self.error_cls(resp.get("error", "readonly"))
                    self._drop()
                    continue
                if resp.get("kind") == "auth":
                    raise StoreAuthError(resp.get("error", "authentication failed"))
                raise self.error_cls(resp.get("error", "server error"))
        raise self.error_cls(
            f"{op} failed after {RETRIES} attempts: {last_err}"
        )

    def ping(self) -> bool:
        """Single-attempt liveness probe on its own short-lived connection:
        no retry budget and no shared client lock, so a health check answers
        within one connect timeout even while request traffic is riding out
        a failover on the pooled connection."""
        try:
            host, port = self._resolve_primary()
            with socket.create_connection(
                (host, port), timeout=CONNECT_TIMEOUT
            ) as s:
                s.settimeout(CONNECT_TIMEOUT)
                send_frame(s, self._frame("ping"))
                resp = recv_frame(s)
            return bool(resp and resp.get("ok"))
        except (OSError, StoreError):
            return False

    def info(self) -> dict:
        return self.call("info")

    def close(self) -> None:
        with self._lock:
            self._drop()


class NetResultsDB(_StoreClient):
    error_cls = DatabaseError

    def __init__(self, url: str):
        super().__init__(url)
        self.applied_at_init: list[str] = []  # server migrates its own store

    def migrate(self) -> list[str]:
        return []

    def create_pending(
        self,
        transaction_id: str | None,
        input_data: dict,
        correlation_id: str | None = None,
    ) -> str:
        # Generate the id client-side: a retry after an ambiguous failure
        # (connection lost between send and response) then upserts the SAME
        # row instead of inserting a second one under a server-minted id.
        return self.call(
            "db.create_pending",
            transaction_id=transaction_id or str(uuid.uuid4()),
            input_data=input_data,
            correlation_id=correlation_id,
        )

    def complete(
        self,
        transaction_id: str,
        shap_values: dict[str, float],
        expected_value: float,
        prediction_score: float,
    ) -> None:
        self.call(
            "db.complete",
            transaction_id=transaction_id,
            shap_values=shap_values,
            expected_value=expected_value,
            prediction_score=prediction_score,
        )

    def fail(self, transaction_id: str, error: str) -> None:
        self.call("db.fail", transaction_id=transaction_id, error=error)

    def get(self, transaction_id: str) -> dict[str, Any] | None:
        return self.call("db.get", transaction_id=transaction_id)

    def count(self, status: str | None = None) -> int:
        return self.call("db.count", status=status)


class NetBroker(_StoreClient):
    error_cls = BrokerError

    def send_task(
        self,
        name: str,
        args: list[Any],
        correlation_id: str | None = None,
        max_retries: int = DEFAULT_MAX_RETRIES,
        countdown: float = 0.0,
        task_id: str | None = None,
    ) -> str:
        # Client-side id + server-side ON CONFLICT DO NOTHING = an ambiguous
        # retry cannot enqueue the task twice.
        return self.call(
            "q.send_task",
            name=name,
            args=args,
            correlation_id=correlation_id,
            max_retries=max_retries,
            countdown=countdown,
            task_id=task_id or uuid.uuid4().hex,
        )

    def claim(
        self, worker_id: str, visibility_timeout: float = DEFAULT_VISIBILITY_TIMEOUT
    ) -> Task | None:
        tasks = self.claim_many(worker_id, 1, visibility_timeout)
        return tasks[0] if tasks else None

    def claim_many(
        self,
        worker_id: str,
        limit: int,
        visibility_timeout: float = DEFAULT_VISIBILITY_TIMEOUT,
    ) -> list[Task]:
        rows = self.call(
            "q.claim_many",
            worker_id=worker_id,
            limit=limit,
            visibility_timeout=visibility_timeout,
        )
        return [Task(**r) for r in rows]

    def ack(self, task_id: str) -> None:
        self.call("q.ack", task_id=task_id)

    def nack(
        self,
        task_id: str,
        countdown: float,
        error: str = "",
        expected_attempts: int | None = None,
        claimed_by: str | None = None,
    ) -> bool:
        return self.call(
            "q.nack", task_id=task_id, countdown=countdown, error=error,
            expected_attempts=expected_attempts, claimed_by=claimed_by,
        )

    def depth(self) -> int:
        return self.call("q.depth")

    def get_status(self, task_id: str) -> str | None:
        return self.call("q.get_status", task_id=task_id)
