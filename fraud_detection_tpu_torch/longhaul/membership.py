"""Cluster membership: the netstore-disciplined host directory.

The port's copy of the JAX package's ``longhaul/membership.py``, on the
same wire. One small control-plane server (``service/wire.py``'s framed
JSON with its auth, and ``service/netserver.py``'s durable-state
discipline) owns the fleet's source of truth: which host ranks exist,
which are live, and the **membership epoch** — a monotone integer bumped
on every membership change (join, death, leave, rejoin). The epoch is the fleet's fence token:

- routing views are stamped with the epoch they were computed under;
- promotion finalization is refused when the finalizing host's epoch is
  stale (:meth:`~fraud_detection_tpu_torch.longhaul.host.HostServer.finalize_promotion`);
- fleet scrapes merge only contributions reported under ONE epoch, so a
  split-brained host can never be double-counted
  (:mod:`fraud_detection_tpu_torch.longhaul.scrape`).

State durability follows netserver exactly: ``members.json`` is written
tmp → fsync → ``os.replace`` under the ``longhaul.members`` lock on every
mutation, so a restarted directory resumes with the same ranks and a
STRICTLY higher epoch (restart bumps once — any view issued by the old
incarnation is thereby fenced). Heartbeat times are deliberately
volatile: after a restart every member must prove liveness afresh.

The liveness rule is crash-detector standard: a member that has not
heartbeated within ``dead_after_s`` is marked dead by the sweeper and the
epoch bumps. Death here means *membership* death — the host's segment is
up for inheritance — not process death; a partitioned-but-running host
discovers its own death on its next heartbeat (``{"stale": true}``) and
must stop finalizing anything fenced by its old epoch.
"""

from __future__ import annotations

import json
import logging
import os
import socket
import threading
import time
from dataclasses import dataclass

from fraud_detection_tpu_torch import config
from fraud_detection_tpu_torch.service import metrics
from fraud_detection_tpu_torch.service.wire import (
    CONN_STALL_TIMEOUT,
    attach_auth,
    check_auth,
    recv_frame,
    send_frame,
)
from fraud_detection_tpu_torch.utils import lockdep

log = logging.getLogger("fraud_detection_tpu_torch.longhaul")

_STATE_FILE = "members.json"
#: sweeper tick — liveness resolution, far below any sane dead_after_s
_TICK_S = 0.05


@dataclass(frozen=True)
class MemberInfo:
    host_id: str
    rank: int
    addr: str  # "host:port" of the member's data plane
    alive: bool


@dataclass(frozen=True)
class MembershipView:
    """An epoch-stamped snapshot of the fleet. ``n_hosts`` is the segment
    count (fixed fleet geometry), ``members`` the known ranks."""

    epoch: int
    n_hosts: int
    members: tuple[MemberInfo, ...]

    @property
    def live_ranks(self) -> tuple[int, ...]:
        return tuple(m.rank for m in self.members if m.alive)

    def member_by_rank(self, rank: int) -> MemberInfo | None:
        for m in self.members:
            if m.rank == rank:
                return m
        return None

    def to_dict(self) -> dict:
        return {
            "epoch": self.epoch,
            "n_hosts": self.n_hosts,
            "members": [
                {
                    "host_id": m.host_id,
                    "rank": m.rank,
                    "addr": m.addr,
                    "alive": m.alive,
                }
                for m in self.members
            ],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "MembershipView":
        return cls(
            epoch=int(d["epoch"]),
            n_hosts=int(d["n_hosts"]),
            members=tuple(
                MemberInfo(
                    host_id=m["host_id"],
                    rank=int(m["rank"]),
                    addr=m["addr"],
                    alive=bool(m["alive"]),
                )
                for m in d["members"]
            ),
        )


class DirectoryServer:
    """The membership directory. Start with :meth:`start`; every mutation
    holds :attr:`_members_lock` (lockdep ``longhaul.members``) across
    {mutate → persist → epoch bump} so a concurrent ``view`` can never
    observe a membership change without its epoch."""

    def __init__(
        self,
        directory: str,
        n_hosts: int,
        port: int = 0,
        host: str = "127.0.0.1",
        dead_after_s: float | None = None,
        token: str | None = None,
    ):
        self.directory = directory
        self.n_hosts = int(n_hosts)
        self.dead_after_s = (
            dead_after_s
            if dead_after_s is not None
            else config.longhaul_dead_after_s()
        )
        self.token = token if token is not None else config.store_token()
        self._members_lock = lockdep.lock("longhaul.members")
        self.epoch = 0
        #: host_id -> {rank, addr, alive}
        self.members: dict[str, dict] = {}
        #: volatile: host_id -> last heartbeat monotonic time
        self._last_hb: dict[str, float] = {}
        self._load_state()
        # a restarted directory fences every view the old incarnation
        # issued: bump once, durably, before serving anything
        with self._members_lock:
            self.epoch += 1
            # the restart fence must be durable before any view is served
            # lockcheck: ignore[blocking-under-lock] (the reason above)
            self._save_state()
        # the listener blocks in accept by design; close() unblocks it
        # lockcheck: ignore[socket-no-timeout] (the reason above)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(32)
        self.addr = "%s:%d" % self._sock.getsockname()[:2]
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []

    # -- durable state (netserver discipline) -----------------------------
    def _state_path(self) -> str:
        return os.path.join(self.directory, _STATE_FILE)

    def _load_state(self) -> None:
        try:
            with open(self._state_path()) as f:
                st = json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return
        self.epoch = int(st.get("epoch", 0))
        self.members = {
            hid: dict(m) for hid, m in st.get("members", {}).items()
        }
        # liveness is volatile: every member re-proves itself after a
        # directory restart (they are "alive" only once they heartbeat)
        for m in self.members.values():
            m["alive"] = False

    def _save_state(self) -> None:
        """tmp → fsync → replace, under the members lock."""
        os.makedirs(self.directory, exist_ok=True)
        path = self._state_path()
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"epoch": self.epoch, "members": self.members}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        metrics.longhaul_membership_epoch.set(self.epoch)
        metrics.longhaul_hosts_live.set(
            sum(1 for m in self.members.values() if m["alive"])
        )

    # -- view --------------------------------------------------------------
    def view(self) -> MembershipView:
        with self._members_lock:
            return self._view_locked()

    def _view_locked(self) -> MembershipView:
        return MembershipView(
            epoch=self.epoch,
            n_hosts=self.n_hosts,
            members=tuple(
                MemberInfo(
                    host_id=hid,
                    rank=int(m["rank"]),
                    addr=m["addr"],
                    alive=bool(m["alive"]),
                )
                for hid, m in sorted(
                    self.members.items(), key=lambda kv: kv[1]["rank"]
                )
            ),
        )

    # -- mutations ---------------------------------------------------------
    def join(self, host_id: str, addr: str) -> MembershipView:
        """Admit (or revive) a member. Rank assignment is sticky: a known
        host_id keeps its rank across rejoins (its segment follows it);
        a new host takes the lowest free rank. Epoch bumps."""
        with self._members_lock:
            known = self.members.get(host_id)
            if known is None:
                used = {int(m["rank"]) for m in self.members.values()}
                free = [r for r in range(self.n_hosts) if r not in used]
                if not free:
                    raise ValueError(
                        f"fleet full: {self.n_hosts} ranks, "
                        f"{len(self.members)} members"
                    )
                self.members[host_id] = {
                    "rank": free[0], "addr": addr, "alive": True,
                }
            else:
                known["addr"] = addr
                known["alive"] = True
            self._last_hb[host_id] = time.monotonic()
            self.epoch += 1
            # a join is durable with its epoch bump, or a directory crash forgets the member but not
            # the fence
            # lockcheck: ignore[blocking-under-lock] (the reason above)
            self._save_state()
            metrics.longhaul_host_up.labels(host_id).set(1)
            log.info(
                "longhaul: %s joined as rank %d (epoch %d)",
                host_id, self.members[host_id]["rank"], self.epoch,
            )
            return self._view_locked()

    def heartbeat(self, host_id: str) -> dict:
        """Record liveness. A member the directory considers dead gets
        ``{"stale": true}`` — its cue to rejoin and re-fence."""
        with self._members_lock:
            m = self.members.get(host_id)
            if m is None or not m["alive"]:
                return {"epoch": self.epoch, "stale": True}
            self._last_hb[host_id] = time.monotonic()
            metrics.longhaul_host_heartbeat_age.labels(host_id).set(0.0)
            return {"epoch": self.epoch, "stale": False}

    def leave(self, host_id: str) -> MembershipView:
        with self._members_lock:
            m = self.members.get(host_id)
            if m is not None and m["alive"]:
                m["alive"] = False
                self.epoch += 1
                # a leave must be durable with its epoch bump
                # lockcheck: ignore[blocking-under-lock] (the reason above)
                self._save_state()
                self._drop_member_series(host_id)
                log.info(
                    "longhaul: %s left (epoch %d)", host_id, self.epoch
                )
            return self._view_locked()

    def mark_dead(self, host_id: str) -> MembershipView:
        """Administrative/failure-detector death — same epoch semantics as
        a missed-heartbeat death."""
        with self._members_lock:
            self._mark_dead_locked(host_id)
            return self._view_locked()

    def _mark_dead_locked(self, host_id: str) -> None:
        m = self.members.get(host_id)
        if m is None or not m["alive"]:
            return
        m["alive"] = False
        self.epoch += 1
        self._save_state()
        self._drop_member_series(host_id)
        log.warning(
            "longhaul: %s marked dead (epoch %d) — segment up for "
            "inheritance", host_id, self.epoch,
        )

    def _drop_member_series(self, host_id: str) -> None:
        # stale-series discipline: a dead member's gauges must not read
        # as live on dashboards (counters stay; their rate goes quiet)
        metrics.longhaul_host_up.labels(host_id).set(0)
        metrics.drop_host_gauges(host_id)

    # -- sweeper + accept loop --------------------------------------------
    def _sweep(self) -> None:
        now = time.monotonic()
        with self._members_lock:
            for hid, m in self.members.items():
                if not m["alive"]:
                    continue
                last = self._last_hb.get(hid)
                if last is None:
                    # joined before a directory restart and silent since:
                    # start its clock at first observation
                    self._last_hb[hid] = now
                    continue
                age = now - last
                metrics.longhaul_host_heartbeat_age.labels(hid).set(age)
                if age > self.dead_after_s:
                    self._mark_dead_locked(hid)

    def start(self) -> None:
        t = threading.Thread(
            target=self._accept_loop, name="longhaul-dir", daemon=True
        )
        t.start()
        self._threads.append(t)
        s = threading.Thread(
            target=self._sweep_loop, name="longhaul-sweep", daemon=True
        )
        s.start()
        self._threads.append(s)

    def _sweep_loop(self) -> None:
        while not self._stop.wait(_TICK_S):
            try:
                self._sweep()
            except Exception:
                log.exception("longhaul sweeper tick failed")

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return  # socket closed on stop
            conn.settimeout(CONN_STALL_TIMEOUT)
            t = threading.Thread(
                target=self._handle, args=(conn,), daemon=True
            )
            t.start()

    def _handle(self, conn: socket.socket) -> None:
        with conn:
            while not self._stop.is_set():
                try:
                    req = recv_frame(conn)
                except TimeoutError:
                    continue  # idle at a frame boundary: re-arm
                except OSError:
                    return  # stalled mid-frame or reset: drop
                if req is None:
                    return
                try:
                    if self.token and not check_auth(req, self.token):
                        send_frame(
                            conn,
                            {"ok": False, "error": "unauthorized",
                             "kind": "auth"},
                        )
                        continue
                    result = self._dispatch(
                        req.get("op", ""), req.get("args", {})
                    )
                    send_frame(conn, {"ok": True, "result": result})
                except OSError:
                    return
                except Exception as e:  # surfaced to the client in-band
                    log.debug("directory op failed", exc_info=True)
                    try:
                        send_frame(
                            conn,
                            {"ok": False, "error": str(e),
                             "kind": type(e).__name__},
                        )
                    except OSError:
                        return

    def _dispatch(self, op: str, args: dict):
        if op == "join":
            return self.join(args["host_id"], args["addr"]).to_dict()
        if op == "heartbeat":
            return self.heartbeat(args["host_id"])
        if op == "leave":
            return self.leave(args["host_id"]).to_dict()
        if op == "mark_dead":
            return self.mark_dead(args["host_id"]).to_dict()
        if op == "view":
            return self.view().to_dict()
        if op == "ping":
            return {"pong": True, "epoch": self.epoch}
        raise ValueError(f"unknown op: {op}")

    def close(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        for t in self._threads:
            t.join(timeout=2.0)


class DirectoryClient:
    """Thin control-plane client: one short-lived connection per call
    (membership traffic is rare; simplicity beats pooling here)."""

    def __init__(
        self,
        addr: str,
        token: str | None = None,
        timeout: float = 5.0,
    ):
        from fraud_detection_tpu_torch.service.wire import parse_hostport

        self.host, self.port = parse_hostport(addr, 7300)
        self.token = token if token is not None else config.store_token()
        self.timeout = timeout

    def _call(self, op: str, **args):
        with socket.create_connection(
            (self.host, self.port), timeout=self.timeout
        ) as sock:
            sock.settimeout(self.timeout)
            req = {"op": op, "args": args}
            if self.token:
                req = attach_auth(req, self.token)
            send_frame(sock, req)
            resp = recv_frame(sock)
        if resp is None:
            raise ConnectionError("directory closed the connection")
        if not resp.get("ok"):
            raise RuntimeError(
                f"directory {op} failed: {resp.get('error')}"
            )
        return resp["result"]

    def join(self, host_id: str, addr: str) -> MembershipView:
        return MembershipView.from_dict(
            self._call("join", host_id=host_id, addr=addr)
        )

    def heartbeat(self, host_id: str) -> dict:
        return self._call("heartbeat", host_id=host_id)

    def leave(self, host_id: str) -> MembershipView:
        return MembershipView.from_dict(self._call("leave", host_id=host_id))

    def mark_dead(self, host_id: str) -> MembershipView:
        return MembershipView.from_dict(
            self._call("mark_dead", host_id=host_id)
        )

    def view(self) -> MembershipView:
        return MembershipView.from_dict(self._call("view"))
