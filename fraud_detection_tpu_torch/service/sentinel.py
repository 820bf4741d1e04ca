"""Sentinel: failure detection + quorum failover for the store tier.

The port's own copy of the JAX package's ``service/sentinel.py``: the same
ops and election, so a sentinel of either package watches and fails over
the store servers of either. It imports no ``torch``.

Plays the role of the reference's Redis Sentinel (docker-compose.yml:20-36,
quorum 2 in charts/fraud-detection/values.yaml): monitors the store servers
(netserver.py), answers "who is the primary?" for clients
(``sentinel://h1:p1,h2:p2/mastername`` URLs, netclient.py), and — when the
primary stays unreachable past ``down_after`` and a quorum of sentinels
agrees — promotes the best replica (highest replication seq) to primary.

Semantics (matching Redis Sentinel's, and documented with the same
honesty): replication is asynchronous, so a failover can lose writes the
dead primary acked but never shipped; the task queue's visibility-timeout
redelivery turns that loss into at-least-once re-execution, and the results
table's idempotent upserts make re-execution safe. Split-brain recovery is
active, like Redis Sentinel reconfiguring a rejoining master as replica:
when a store that is not the elected primary reports ``role=primary``
(a healed partition), the sentinel sends it ``demote`` pointing at the
elected primary; the demoted server resyncs by snapshot-*replace*,
discarding writes it accepted while partitioned, and its open clients get
``kind=readonly`` on their next write and re-resolve.

Run: ``python -m fraud_detection_tpu_torch.service.sentinel --port 26379
--master-name mymaster --stores h1:7600,h2:7600 [--peers h3:26379,...]
[--quorum 2]``.
"""

from __future__ import annotations

import argparse
import logging
import socket
import threading
import time
from typing import Any

from fraud_detection_tpu_torch import config
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

log = logging.getLogger("fraud_detection_tpu_torch.sentinel")

Endpoint = tuple[str, int]


def _election_key(info: dict) -> tuple[int, int]:
    """Rank candidates by (epoch, seq). A higher epoch is a LATER REIGN —
    its writes supersede any lower-epoch node's regardless of seq — and seq
    breaks ties within a reign. Electing by seq alone can crown a stale
    pre-failover primary whose snapshot every higher-epoch replica then
    (rightly) refuses (netserver epoch guard), wedging replication with no
    resolution path."""
    return int(info.get("epoch", 0)), int(info.get("seq", 0))


def _call(ep: Endpoint, op: str, timeout: float = 1.0, **kwargs: Any) -> Any:
    """One-shot request/response to a store or peer sentinel."""
    req = attach_auth({"op": op, **kwargs}, config.store_token())
    with socket.create_connection(ep, timeout=timeout) as s:
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        s.settimeout(timeout)
        send_frame(s, req)
        resp = recv_frame(s)
    if resp is None or not resp.get("ok"):
        raise OSError(f"{op} to {ep} failed: {resp and resp.get('error')}")
    return resp["result"]


class Sentinel:
    def __init__(
        self,
        master_name: str,
        stores: list[Endpoint],
        peers: list[Endpoint] | None = None,
        quorum: int = 1,
        down_after: float = 3.0,
        poll_interval: float = 0.5,
        host: str = "127.0.0.1",
        port: int = 0,
    ):
        self.master_name = master_name
        self.stores = stores
        self.peers = peers or []
        self.quorum = quorum
        self.down_after = down_after
        self.poll_interval = poll_interval
        self.host, self.port = host, port
        self.master: Endpoint | None = None
        self._started = time.time()
        self._last_ok: dict[Endpoint, float] = {}
        self._last_info: dict[Endpoint, dict] = {}
        self._lock = lockdep.lock("sentinel.conns")
        self._stop = threading.Event()
        self._listener: socket.socket | None = None

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        # the listener blocks in accept by design; stop()'s shutdown() wakes it
        # lockcheck: ignore[socket-no-timeout] (the reason above)
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((self.host, self.port))
        self.port = self._listener.getsockname()[1]
        self._listener.listen(16)
        threading.Thread(target=self._accept_loop, daemon=True).start()
        threading.Thread(target=self._monitor_loop, daemon=True).start()
        log.info(
            "sentinel for %r on %s:%d (stores %s, quorum %d)",
            self.master_name, self.host, self.port, self.stores, self.quorum,
        )

    def stop(self) -> None:
        self._stop.set()
        if self._listener is not None:
            try:
                self._listener.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._listener.close()
            except OSError:
                pass

    def serve_forever(self) -> None:
        self.start()
        try:
            while not self._stop.is_set():
                time.sleep(0.2)
        finally:
            self.stop()

    # -- monitoring / failover ---------------------------------------------
    def _probe_all(self) -> None:
        now = time.time()
        for ep in self.stores:
            try:
                info = _call(ep, "info", timeout=min(1.0, self.down_after / 2))
            except OSError:
                continue
            with self._lock:
                self._last_ok[ep] = now
                self._last_info[ep] = info

    def _is_down(self, ep: Endpoint) -> bool:
        # A never-probed store counts as down only after down_after has
        # elapsed since THIS sentinel started — one lost first probe must
        # not count as "down since epoch" (a fresh sentinel could otherwise
        # promote a replica next to a healthy primary it simply hadn't
        # reached yet, and then demote-and-wipe the real primary).
        with self._lock:
            last = self._last_ok.get(ep, self._started)
        return time.time() - last > self.down_after

    def _elect_initial(self) -> Endpoint | None:
        """Discovery: the healthy store reporting role=primary, highest seq."""
        with self._lock:
            infos = dict(self._last_info)
        primaries = [
            ep for ep in self.stores
            if not self._is_down(ep) and infos.get(ep, {}).get("role") == "primary"
        ]
        if not primaries:
            return None
        best = max(primaries, key=lambda ep: _election_key(infos[ep]))
        top_epoch = max(
            (
                int(infos.get(ep, {}).get("epoch", 0))
                for ep in self.stores
                if not self._is_down(ep)
            ),
            default=0,
        )
        if int(infos[best].get("epoch", 0)) < top_epoch:
            # A healthy store carries a LATER REIGN than every visible
            # primary (stale-primary cold start): discovering the stale
            # primary would wedge the higher-epoch node's resync (netserver
            # epoch guard). Return None → the monitor loop falls through to
            # quorum promotion of the highest-(epoch, seq) store instead.
            log.warning(
                "visible primary %s has epoch %s < top epoch %d among "
                "healthy stores; refusing discovery, awaiting promotion",
                best, infos[best].get("epoch", 0), top_epoch,
            )
            return None
        return best

    def _failover(self) -> None:
        """Master is down for us; with quorum agreement, promote a replica."""
        votes = 1
        for peer in self.peers:
            try:
                if _call(
                    peer, "s.is-down",
                    name=self.master_name,
                    host=self.master[0], port=self.master[1],
                ):
                    votes += 1
            except OSError:
                pass
        if votes < self.quorum:
            log.warning(
                "master %s down for me but quorum not met (%d/%d)",
                self.master, votes, self.quorum,
            )
            return
        with self._lock:
            infos = dict(self._last_info)
        candidates = [
            ep for ep in self.stores
            if ep != self.master and not self._is_down(ep)
        ]
        if not candidates:
            log.error("master %s down and no live replica to promote", self.master)
            return
        best = max(candidates, key=lambda ep: _election_key(infos.get(ep, {})))
        try:
            _call(best, "promote")
        except OSError as e:
            log.error("promote of %s failed: %s", best, e)
            return
        log.warning(
            "FAILOVER %r: %s → %s (quorum %d/%d)",
            self.master_name, self.master, best, votes, self.quorum,
        )
        self.master = best

    def _master_quorum(self) -> int:
        """Votes (self + peers) naming OUR master as the current primary.
        Guards demotion: a sentinel whose view diverged after a failover
        must not unilaterally demote the primary its peers elected."""
        votes = 1
        for peer in self.peers:
            try:
                m = _call(peer, "s.get-master", name=self.master_name)
            except OSError:
                continue
            if m and (m["host"], int(m["port"])) == self.master:
                votes += 1
        return votes

    def _demote_stale(self) -> None:
        """Active split-brain recovery: any healthy store that is NOT the
        elected primary but still reports role=primary (a healed partition,
        or a double-start) is told to become a replica of the elected one.
        Mirrors Redis Sentinel reconfiguring a rejoining master as slave.

        Two guards against demoting the wrong server from a divergent view:
        the elected master must itself still report role=primary, and a
        quorum of sentinels must agree that OUR master is the master."""
        with self._lock:
            infos = dict(self._last_info)
        if infos.get(self.master, {}).get("role") != "primary":
            return  # our view is stale; let the re-validation path handle it
        stale: list[Endpoint] = []      # healthy non-masters claiming primary
        mispointed: list[Endpoint] = []  # healthy replicas tracking ≠ master
        for ep in self.stores:
            if ep == self.master or self._is_down(ep):
                continue
            info = infos.get(ep, {})
            if info.get("role") == "primary":
                stale.append(ep)
            elif info.get("role") == "replica":
                # A replica still chained to the dead/old primary receives
                # no writes but looks healthy — a later failover could
                # promote it and lose everything since the last one. Re-
                # point it at the elected master. (Endpoints must be named
                # consistently across sentinel/store configs, as with Redis.)
                upstream = info.get("replicate_from")
                if upstream and parse_hostport(upstream, 7600) != self.master:
                    mispointed.append(ep)
        if not stale and not mispointed:
            return
        votes = self._master_quorum()
        if votes < self.quorum:
            log.warning(
                "topology drift (stale=%s mispointed=%s) but peers don't "
                "agree %s is master (%d/%d votes); not reconfiguring",
                stale, mispointed, self.master, votes, self.quorum,
            )
            return
        target = f"{self.master[0]}:{self.master[1]}"
        for ep in stale:
            try:
                _call(ep, "demote", replicate_from=target)
                log.warning(
                    "demoted stale primary %s → replica of %s", ep, target
                )
            except OSError as e:
                log.warning("demote of stale primary %s failed: %s", ep, e)
        for ep in mispointed:
            try:
                _call(ep, "demote", replicate_from=target)
                log.warning("re-pointed replica %s → %s", ep, target)
            except OSError as e:
                log.warning("re-point of replica %s failed: %s", ep, e)

    def _revalidate_master(self) -> None:
        """If the store we call master now reports role=replica (a peer
        demoted it, or an operator re-pointed it), forget it and re-discover
        — otherwise the loop would serve a read-only 'primary' forever."""
        with self._lock:
            info = self._last_info.get(self.master, {})
        if info.get("role") == "replica":
            log.warning(
                "elected master %s now reports role=replica; re-discovering",
                self.master,
            )
            self.master = None

    def _promote_if_none(self) -> None:
        """All healthy stores are replicas (e.g. every primary was demoted
        from divergent views, or a cold start from replicated data dirs):
        with quorum agreement that there is NO master, promote the highest-
        seq healthy store so the cluster can't wedge read-only."""
        healthy = [ep for ep in self.stores if not self._is_down(ep)]
        if not healthy:
            return
        votes = 1
        for peer in self.peers:
            try:
                if _call(peer, "s.get-master", name=self.master_name) is None:
                    votes += 1
            except OSError:
                pass
        if votes < self.quorum:
            return
        with self._lock:
            infos = dict(self._last_info)
        best = max(healthy, key=lambda ep: _election_key(infos.get(ep, {})))
        try:
            _call(best, "promote")
        except OSError as e:
            log.error("promote of %s failed: %s", best, e)
            return
        log.warning(
            "no primary among healthy stores; PROMOTED %s (quorum %d/%d)",
            best, votes, self.quorum,
        )
        self.master = best

    def _monitor_loop(self) -> None:
        while not self._stop.is_set():
            self._probe_all()
            if self.master is not None and not self._is_down(self.master):
                self._revalidate_master()
            if self.master is None:
                self.master = self._elect_initial()
                if self.master:
                    log.info("discovered primary %s", self.master)
                else:
                    self._promote_if_none()
            elif self._is_down(self.master):
                self._failover()
            else:
                self._demote_stale()
            self._stop.wait(self.poll_interval)

    # -- server ------------------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            # accept-time stall timeout shared with the store servers
            # (semantics documented at the definition in wire.py)
            conn.settimeout(CONN_STALL_TIMEOUT)
            threading.Thread(target=self._handle, args=(conn,), daemon=True).start()

    def _handle(self, conn: socket.socket) -> None:
        token = config.store_token()
        try:
            while not self._stop.is_set():
                try:
                    req = recv_frame(conn)
                except TimeoutError:
                    # idle at a frame boundary; a mid-frame stall raises
                    # StalledPeerError (an OSError) and drops the conn below
                    continue
                if req is None:
                    return
                if not check_auth(req, token):
                    send_frame(conn, AUTH_REJECTION)
                    continue
                op = req.get("op")
                if op == "ping":
                    send_frame(conn, {"ok": True, "result": {"role": "sentinel"}})
                elif op == "s.get-master":
                    m = self.master if req.get("name", self.master_name) == self.master_name else None
                    result = {"host": m[0], "port": m[1]} if m else None
                    send_frame(conn, {"ok": True, "result": result})
                elif op == "s.is-down":
                    ep = (req["host"], int(req["port"]))
                    send_frame(conn, {"ok": True, "result": self._is_down(ep)})
                else:
                    send_frame(
                        conn, {"ok": False, "kind": "error", "error": f"unknown op {op!r}"}
                    )
        except Exception:
            log.debug("sentinel command connection failed", exc_info=True)
        finally:
            try:
                conn.close()
            except OSError:
                pass


def main() -> None:
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "--host", default="127.0.0.1",
        help="bind address; container topologies pass 0.0.0.0 explicitly",
    )
    ap.add_argument("--port", type=int, default=26379)
    ap.add_argument("--master-name", default="mymaster")
    ap.add_argument("--stores", required=True, help="h1:p1,h2:p2 store servers")
    ap.add_argument("--peers", default="", help="other sentinels, h:p,...")
    ap.add_argument("--quorum", type=int, default=1)
    ap.add_argument("--down-after", type=float, default=3.0)
    ap.add_argument("--poll-interval", type=float, default=0.5)
    args = ap.parse_args()
    Sentinel(
        args.master_name,
        stores=[parse_hostport(s, 7600) for s in args.stores.split(",") if s],
        peers=[parse_hostport(s, 26379) for s in args.peers.split(",") if s],
        quorum=args.quorum,
        down_after=args.down_after,
        poll_interval=args.poll_interval,
        host=args.host,
        port=args.port,
    ).serve_forever()


if __name__ == "__main__":
    main()
