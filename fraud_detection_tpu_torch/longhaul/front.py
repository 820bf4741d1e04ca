"""The longhaul front: multi-format ingress, per-host routing, the
degradation contracts at fleet scope.

The port's copy of the JAX package's ``longhaul/front.py``. Routing is the
two-moduli placement applied to each row: the entity's ledger slot names
a segment (``slot mod N_hosts``), the membership view names the segment's
live owner (ring inheritance), and the front ships each owner ONE framed
sub-batch — one flush on the owning host. Rows of
the same slot always share a segment, so they always travel together,
which is the invariant that keeps routed scores bitwise equal to a
single-host serve (the ledger fold is per-slot; see
:mod:`fraud_detection_tpu_torch.longhaul.placement`).

The health machine is the shard front's, lifted per-host:

- transport/handler failures strike; ``death_threshold`` consecutive
  strikes flip a handle HEALTHY → DEAD — **unless it is the last live
  host** (last-healthy-host protection: a front that can talk to nobody
  must keep trying somebody);
- a DEAD handle sits out ``probation_s``, then HALF_OPEN admits exactly
  ONE probe; success revives, failure re-arms probation;
- an owner that answers the explicit 503 (``{"unavailable": true}`` —
  inheriting, or its lifeboat mid-recovery) is **backpressure, not
  failure**: no strike, the caller gets 503 + Retry-After in its own
  format. The data plane never answers worse than that.

Stale views self-heal: a routing failure forces a view refresh; if the
segment's owner changed under us (failover completed), the front retries
the new owner once before surfacing the 503.
"""

from __future__ import annotations

import logging
import socket
import threading
import time

import numpy as np

from fraud_detection_tpu_torch import config
from fraud_detection_tpu_torch.longhaul import codec, placement
from fraud_detection_tpu_torch.longhaul.codec import Unavailable
from fraud_detection_tpu_torch.longhaul.membership import (
    DirectoryClient,
    MembershipView,
)
from fraud_detection_tpu_torch.service import metrics
from fraud_detection_tpu_torch.service.wire import (
    attach_auth,
    parse_hostport,
    recv_frame,
    send_frame,
)

log = logging.getLogger("fraud_detection_tpu_torch.longhaul")

HEALTHY = "healthy"
DEAD = "dead"
HALF_OPEN = "half_open"

#: minimum seconds between implicit view refreshes on the hot path
_VIEW_TTL_S = 0.25


class HostHandle:
    """One member's data-plane connection + health state."""

    def __init__(self, host_id: str, rank: int, addr: str, token: str):
        self.host_id = host_id
        self.rank = rank
        self.addr = addr
        self.token = token
        self.state = HEALTHY
        self.consecutive_errors = 0
        self.dead_since = 0.0
        self._probe_inflight = False
        self._sock: socket.socket | None = None
        self._lock = threading.Lock()

    def _connect(self, timeout: float) -> socket.socket:
        if self._sock is None:
            host, port = parse_hostport(self.addr, 7400)
            self._sock = socket.create_connection(
                (host, port), timeout=timeout
            )
            self._sock.settimeout(timeout)
        return self._sock

    def call(self, op: str, args: dict, timeout: float = 30.0):
        """One request/response over the persistent connection. Raises
        OSError/RuntimeError on transport or handler failure (a strike);
        the caller interprets the result dict."""
        with self._lock:
            try:
                sock = self._connect(timeout)
                req = {"op": op, "args": args}
                if self.token:
                    req = attach_auth(req, self.token)
                send_frame(sock, req)
                resp = recv_frame(sock)
            except OSError:
                self._drop_conn()
                raise
            if resp is None:
                self._drop_conn()
                raise ConnectionError(f"{self.host_id} closed connection")
            if not resp.get("ok"):
                raise RuntimeError(
                    f"{self.host_id} {op}: {resp.get('error')}"
                )
            return resp["result"]

    def _drop_conn(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def close(self) -> None:
        with self._lock:
            self._drop_conn()


class LonghaulFront:
    """Routes scoring traffic to segment owners under the current
    membership view; the fleet-scope twin of ``mesh/front.ShardFront``
    (the port's ``mesh/front.py``)."""

    def __init__(
        self,
        spec,
        n_hosts: int,
        directory_addr: str | None = None,
        view: MembershipView | None = None,
        token: str | None = None,
        death_threshold: int = 3,
        probation_s: float | None = None,
        retry_after_s: float | None = None,
        call_timeout: float = 30.0,
    ):
        self.spec = spec
        self.n_hosts = int(n_hosts)
        self.directory_addr = directory_addr
        self.token = token if token is not None else config.store_token()
        self.death_threshold = int(death_threshold)
        self.probation_s = (
            probation_s
            if probation_s is not None
            else config.longhaul_probation_s()
        )
        self.retry_after_s = (
            retry_after_s
            if retry_after_s is not None
            else config.longhaul_retry_after_s()
        )
        self.call_timeout = call_timeout
        self.view: MembershipView | None = view
        self.handles: dict[int, HostHandle] = {}
        self._view_lock = threading.Lock()
        self._last_refresh = 0.0
        if view is not None:
            self._bind_view(view)
        elif directory_addr is not None:
            self.refresh_view(force=True)
        else:
            raise ValueError("need directory_addr or a static view")

    # -- membership view ---------------------------------------------------
    def refresh_view(self, force: bool = False) -> MembershipView:
        with self._view_lock:
            now = time.monotonic()
            if (
                not force
                and self.view is not None
                and now - self._last_refresh < _VIEW_TTL_S
            ):
                return self.view
            if self.directory_addr is not None:
                try:
                    view = DirectoryClient(
                        self.directory_addr, token=self.token
                    ).view()
                except (OSError, RuntimeError):
                    if self.view is None:
                        raise
                    return self.view  # serve on the last-known view
                if self.view is None or view.epoch != self.view.epoch:
                    self._bind_view(view)
            self._last_refresh = now
            return self.view

    def _bind_view(self, view: MembershipView) -> None:
        old = self.handles
        new: dict[int, HostHandle] = {}
        for m in view.members:
            if not m.alive:
                continue
            prev = old.get(m.rank)
            if prev is not None and prev.addr == m.addr:
                new[m.rank] = prev  # keep connection + health state
            else:
                new[m.rank] = HostHandle(
                    m.host_id, m.rank, m.addr, self.token
                )
        for rank, h in old.items():
            if new.get(rank) is not h:
                h.close()
        self.handles = new
        self.view = view
        log.info(
            "longhaul front: view epoch %d, live ranks %s",
            view.epoch, sorted(new),
        )

    # -- health machine ----------------------------------------------------
    def _pick(self, segment: int) -> HostHandle:
        view = self.view
        live = sorted(self.handles)
        if not live:
            metrics.longhaul_unavailable.inc()
            raise Unavailable("no live hosts", self.retry_after_s)
        rank = placement.segment_owner(segment, live, view.n_hosts)
        h = self.handles[rank]
        if h.state == DEAD:
            if time.monotonic() - h.dead_since >= self.probation_s:
                if not h._probe_inflight:
                    h._probe_inflight = True
                    h.state = HALF_OPEN  # this caller is the one probe
                    return h
            metrics.longhaul_unavailable.inc()
            raise Unavailable(
                f"owner {h.host_id} dead (probation)", self.retry_after_s
            )
        if h.state == HALF_OPEN:
            # someone else's probe is in flight: shed, don't pile on
            metrics.longhaul_unavailable.inc()
            raise Unavailable(
                f"owner {h.host_id} half-open", self.retry_after_s
            )
        return h

    def _record_failure(self, h: HostHandle) -> None:
        metrics.longhaul_route_errors.labels(h.host_id).inc()
        h.consecutive_errors += 1
        live = [x for x in self.handles.values() if x.state == HEALTHY]
        if h.state == HALF_OPEN:
            h.state = DEAD
            h.dead_since = time.monotonic()
            h._probe_inflight = False
            return
        if h.consecutive_errors >= self.death_threshold:
            # last-healthy-host protection: never give up on the only
            # host we can still name — keep striking, keep trying
            if not (len(live) == 1 and live[0] is h):
                h.state = DEAD
                h.dead_since = time.monotonic()
                log.warning(
                    "longhaul front: %s DEAD after %d strikes",
                    h.host_id, h.consecutive_errors,
                )

    def _record_success(self, h: HostHandle) -> None:
        if h.state != HEALTHY:
            log.info("longhaul front: %s revived", h.host_id)
        h.state = HEALTHY
        h.consecutive_errors = 0
        h._probe_inflight = False

    # -- routing -----------------------------------------------------------
    def score(
        self, rows, ents, fmt: str = "json"
    ) -> np.ndarray:
        """Route one batch: group rows by owning host (same-slot rows
        always share a group), one flush per owner, reassemble in request
        order. ``ents[i]`` is ``(slot, fp, ts)`` or None (null rows ride
        segment 0 deterministically)."""
        self.refresh_view()
        rows = np.asarray(rows, np.float32)
        n = rows.shape[0]
        groups: dict[int, list[int]] = {}
        for i in range(n):
            ent = ents[i]
            seg = (
                placement.host_of(int(ent[0]), self.n_hosts)
                if ent is not None
                else 0
            )
            groups.setdefault(seg, []).append(i)
        out = np.empty(n, np.float32)
        for seg in sorted(groups):
            idx = groups[seg]
            sub_rows = rows[idx]
            sub_ents = [
                list(ents[i]) if ents[i] is not None else None
                for i in idx
            ]
            scores = self._route_segment(seg, sub_rows, sub_ents, fmt)
            out[idx] = scores
        return out

    def _route_segment(
        self, segment: int, rows: np.ndarray, ents: list, fmt: str
    ) -> np.ndarray:
        h = self._pick(segment)
        try:
            result = h.call(
                "score",
                {"rows": codec.pack_array(rows), "ents": ents},
                timeout=self.call_timeout,
            )
        except (OSError, RuntimeError):
            self._record_failure(h)
            # the owner may have changed under us (failover completed):
            # force a view refresh and retry the NEW owner exactly once
            self.refresh_view(force=True)
            h2 = self._pick(segment)
            if h2 is h:
                metrics.longhaul_unavailable.inc()
                raise Unavailable(
                    f"segment {segment} owner unreachable",
                    self.retry_after_s,
                ) from None
            try:
                result = h2.call(
                    "score",
                    {"rows": codec.pack_array(rows), "ents": ents},
                    timeout=self.call_timeout,
                )
            except (OSError, RuntimeError):
                self._record_failure(h2)
                metrics.longhaul_unavailable.inc()
                raise Unavailable(
                    f"segment {segment} owner unreachable",
                    self.retry_after_s,
                ) from None
            h = h2
        if result.get("unavailable"):
            # explicit backpressure (inheriting/recovering): NOT a strike
            metrics.longhaul_unavailable.inc()
            raise Unavailable(
                f"{h.host_id}: {result.get('reason', 'unavailable')}",
                float(result.get("retry_after_s", self.retry_after_s)),
            )
        self._record_success(h)
        metrics.longhaul_routed_rows.labels(h.host_id, fmt).inc(
            rows.shape[0]
        )
        return codec.unpack_array(result["scores"]).astype(np.float32)

    # -- the multi-format edge --------------------------------------------
    def handle_request(self, payload: bytes, fmt: str) -> bytes:
        """Decode (json/msgpack/binary) → route → encode in kind. The 503
        floor is honored per format (JSON/msgpack bodies carry
        ``status: 503`` + ``retry_after_s``; binary answers the hyperloop
        UNAVAILABLE status frame with a retry hint)."""
        rows, ents = codec.decode_request(payload, fmt, self.spec)
        try:
            scores = self.score(rows, ents, fmt=fmt)
        except Unavailable as e:
            return codec.encode_unavailable(
                str(e), e.retry_after_s, fmt
            )
        return codec.encode_response(scores, fmt)

    # -- control plane helpers --------------------------------------------
    def drive_failover(self, dead_rank: int, peer_dir: str) -> dict | None:
        """Instruct the ring inheritor of ``dead_rank``'s segments to
        replay the dead peer's generation. Idempotent per view: returns
        the inheritor's summary, or None when nothing is inheritable
        (rank unknown or still alive in the current view)."""
        view = self.refresh_view(force=True)
        dead = view.member_by_rank(dead_rank)
        if dead is None or dead.alive:
            return None
        live = view.live_ranks
        if not live:
            return None
        # the dead rank's home segment (segment r lives on rank r)
        segs = [dead_rank]
        inheritor_rank = placement.segment_owner(
            dead_rank, live, view.n_hosts
        )
        h = self.handles.get(inheritor_rank)
        if h is None:
            return None
        summary = h.call(
            "inherit",
            {"peer_dir": peer_dir, "segments": segs, "epoch": view.epoch},
            timeout=max(self.call_timeout, 120.0),
        )
        return summary

    def status(self) -> dict:
        view = self.view
        return {
            "epoch": view.epoch if view else None,
            "n_hosts": self.n_hosts,
            "hosts": {
                h.host_id: {
                    "rank": rank,
                    "state": h.state,
                    "consecutive_errors": h.consecutive_errors,
                }
                for rank, h in sorted(self.handles.items())
            },
        }

    def close(self) -> None:
        for h in self.handles.values():
            h.close()
