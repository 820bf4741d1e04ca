"""One longhaul serving host: the data-plane process behind the front.

The port's counterpart of the JAX package's ``longhaul/host.py``. Wraps
the single-process serving stack (micro-batcher + watchtower + lifeboat)
behind a framed-socket data plane and adds the three things a FLEET member
needs that a lone process does not:

- **Membership**: join the directory at start, heartbeat every
  ``LONGHAUL_HEARTBEAT_S``, track the epoch the directory last told us.
  A ``{"stale": true}`` heartbeat answer means the failure detector
  declared us dead while we were partitioned — rejoin (epoch bumps) and
  treat everything fenced by the old epoch as void.
- **Segment inheritance** (:meth:`inherit`): replay a dead peer's
  journal+snapshot generation via ``lifeboat/recovery.py`` — the SAME
  bitwise replay path warm restart uses, pointed at the PEER's directory
  — then merge the peer's segment rows into the live table between
  flushes (under the lifeboat flush lock; same shapes/dtypes on the
  serving device, so the kernels already loaded keep serving and no
  kernel library is built or loaded). The
  host answers 503 + Retry-After while inheriting — readiness gating,
  never silent misroutes into a half-merged table.
- **Epoch-fenced promotion** (:meth:`finalize_promotion`): an alias flip
  decided under epoch ``e`` is refused unless the directory — consulted
  LIVE at finalize time — still reports epoch ``e`` with this host
  alive. A partitioned host cannot reach the directory, so it cannot
  finalize: fail-safe, the stale flip dies instead of moving traffic.

Lock order (enforced by lockdep): ``longhaul.inherit`` →
``lifeboat.flush`` — inheritance takes its own lock first, then briefly
couples to the flush path for the merge+rebind cut.

Runnable: ``python -m fraud_detection_tpu_torch.longhaul.host --host-id h0
--port 7401 --directory 127.0.0.1:7300 --n-hosts 2 --seed 7 --data-dir
/var/lib/fraud/longhaul`` builds the seeded ledger-widened stack on
``cuda`` (``DEVICE=cpu`` for the CPU; without a card and without it, it
raises), logs its device, prints ``LONGHAUL_READY <addr>`` and serves
until killed — the subprocess fleet the drills spawn. Each flag left out
takes its setting: ``--host-id`` ``LONGHAUL_HOST_ID``, ``--directory``
``LONGHAUL_DIRECTORY``, ``--n-hosts`` ``LONGHAUL_HOSTS``, ``--data-dir``
``LONGHAUL_DATA_DIR``; ``--directory ''`` serves alone, owning every
segment.
"""

from __future__ import annotations

import logging
import os
import socket
import threading
import time

import numpy as np

from fraud_detection_tpu_torch import config
from fraud_detection_tpu_torch.longhaul import codec, placement
from fraud_detection_tpu_torch.longhaul.membership import DirectoryClient
from fraud_detection_tpu_torch.range.faults import fire
from fraud_detection_tpu_torch.service import metrics
from fraud_detection_tpu_torch.service.wire import (
    CONN_STALL_TIMEOUT,
    check_auth,
    recv_frame,
    send_frame,
)
from fraud_detection_tpu_torch.utils import lockdep

log = logging.getLogger("fraud_detection_tpu_torch.longhaul")

READY = "ready"
INHERITING = "inheriting"


class LedgerBackend:
    """The serving stack one host owns: scorer + watchtower (drift/ledger
    bind) + micro-batcher + optional lifeboat. ``score_items`` drives the
    REAL flush body — staging, the journal hook, the fused stateful
    dispatch (``fused_score`` on the card) — so a routed sub-batch is one
    flush, exactly like a local one."""

    def __init__(
        self, scorer, watchtower, spec, microbatcher, boat=None,
        baseline_counters: tuple[float, float] = (0.0, 0.0),
    ):
        self.scorer = scorer
        self.watchtower = watchtower
        self.spec = spec
        self.mb = microbatcher
        self.boat = boat
        #: (collisions, evictions) of the SEEDED table every fleet member
        #: starts from — subtracted once when merging a peer's counters
        self.baseline_counters = baseline_counters
        self._tgt = microbatcher._fused_target(scorer)

    @property
    def drift(self):
        return self.watchtower.drift

    @property
    def device(self):
        """The device the stack serves on (the drift monitor's)."""
        return self.drift.device

    def score_items(self, items) -> np.ndarray:
        """One flush of ``items``; the scores copied out of the flush's
        pooled staging slot, and the slot released."""
        out = self.mb._flush_device(self.scorer, self._tgt, items, False)
        try:
            return np.array(out[0], np.float32)
        finally:
            self.scorer.staging.release(out[-1])

    def table(self):
        """A copy of the live table on the serving device (int64
        fingerprint; ``ledger.state.host_state`` gives the file's dtypes)."""
        return self.drift.ledger_snapshot()

    def close(self) -> None:
        """Stop the watchtower's thread and close the lifeboat's journal
        (no snapshot: what a kill leaves on disk stays as it is)."""
        self.watchtower.close()
        if self.boat is not None:
            self.boat.close()


class HostServer:
    """The framed-socket data plane + membership agent for one host."""

    def __init__(
        self,
        host_id: str,
        backend: LedgerBackend,
        n_hosts: int,
        port: int = 0,
        bind: str = "127.0.0.1",
        directory_addr: str | None = None,
        heartbeat_s: float | None = None,
        token: str | None = None,
        served_version: str | None = None,
    ):
        self.host_id = host_id
        self.backend = backend
        self.n_hosts = int(n_hosts)
        self.directory_addr = directory_addr
        self.heartbeat_s = (
            heartbeat_s
            if heartbeat_s is not None
            else config.longhaul_heartbeat_s()
        )
        self.token = token if token is not None else config.store_token()
        self.state = READY
        self.rank: int | None = None
        self.owned_segments: set[int] = set()
        #: segments this host has DATA for beyond its home segment —
        #: grown only by :meth:`inherit` (an explicit, replayed take-over)
        self._inherited: set[int] = set()
        self.known_epoch = 0
        self.served_version = served_version
        self.last_inherit: dict | None = None
        self._inherit_lock = lockdep.lock("longhaul.inherit")
        #: scenario hook: True simulates a network partition (heartbeats
        #: stop reaching the directory; data plane stays up — split brain)
        self.partitioned = False
        # the listener blocks in accept by design; kill() unblocks it
        # lockcheck: ignore[socket-no-timeout] (the reason above)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((bind, port))
        self._sock.listen(64)
        self.addr = "%s:%d" % self._sock.getsockname()[:2]
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []

    # -- membership --------------------------------------------------------
    def _directory(self) -> DirectoryClient | None:
        if self.directory_addr is None:
            return None
        if self.partitioned:
            # the partition: control-plane packets don't route. Pointing
            # the client at a dead port makes EVERY control call fail the
            # same way a real partition would — heartbeats never arrive
            # and finalize_promotion cannot consult the directory, so the
            # fence fails safe (unreachable = un-finalizable).
            return DirectoryClient("127.0.0.1:9", token=self.token, timeout=0.2)
        return DirectoryClient(self.directory_addr, token=self.token)

    def join(self) -> None:
        d = self._directory()
        if d is None:
            # directory-less single host: owns every segment
            self.rank = 0
            self.owned_segments = set(range(self.n_hosts))
            return
        view = d.join(self.host_id, self.addr)
        self.known_epoch = view.epoch
        me = next(m for m in view.members if m.host_id == self.host_id)
        self.rank = me.rank
        self._recompute_claim(view)
        log.info(
            "longhaul host %s: rank %d, segments %s, epoch %d",
            self.host_id, self.rank, sorted(self.owned_segments),
            self.known_epoch,
        )

    def _recompute_claim(self, view) -> None:
        """A host serves the intersection of what the ring ASSIGNS it and
        what it has DATA for (home segment + explicitly inherited). Ring
        assignment without data is never served silently — those rows get
        the 503 until :meth:`inherit` lands; data without assignment (a
        peer rejoined and took its segment back) is dropped from the
        claim so two hosts never serve one segment."""
        if self.rank is None:
            return
        ring = set(
            placement.owned_segments(
                self.rank, view.live_ranks, self.n_hosts
            )
        )
        have = {self.rank} | self._inherited
        self.owned_segments = ring & have
        self._inherited &= ring

    def _hb_loop(self) -> None:
        while not self._stop.wait(self.heartbeat_s):
            if self.partitioned:
                continue  # the partition: beats never leave the host
            d = self._directory()
            if d is None:
                continue
            try:
                ans = d.heartbeat(self.host_id)
                if ans.get("stale"):
                    # the failure detector declared us dead while we were
                    # away: rejoin (epoch bumps, old fences void)
                    log.warning(
                        "longhaul host %s: heartbeat says stale — "
                        "rejoining", self.host_id,
                    )
                    self.join()
                elif int(ans["epoch"]) != self.known_epoch:
                    # membership changed: re-derive what we may serve
                    self.known_epoch = int(ans["epoch"])
                    try:
                        self._recompute_claim(d.view())
                    except (OSError, RuntimeError):
                        pass
            except (OSError, RuntimeError):
                log.warning(
                    "longhaul host %s: directory unreachable", self.host_id
                )

    # -- failover ----------------------------------------------------------
    def inherit(
        self, peer_dir: str, segments: set[int] | list[int], epoch: int,
    ) -> dict:
        """Warm-restart a dead peer's segment from its journal+snapshot
        generation and merge it into the live table. Returns a summary
        (replayed rows, duration, rows/s) the caller can publish."""
        from fraud_detection_tpu_torch.lifeboat import recovery as recovery_mod

        segments = set(int(s) for s in segments)
        with self._inherit_lock:
            self.state = INHERITING
            metrics.longhaul_failover_in_progress.set(1)
            t0 = time.perf_counter()
            try:
                fire(
                    "longhaul.inherit",
                    host=self.host_id, segments=sorted(segments),
                )
                rep = recovery_mod.recover(
                    peer_dir, self.backend.spec, device=self.backend.device
                )
                boat = self.backend.boat
                flush_lock = (
                    boat.flush_lock if boat is not None
                    else threading.Lock()
                )
                with flush_lock:
                    # between flushes: nothing is mid-dispatch, the live
                    # table is quiescent for the segment splice
                    live = self.backend.table()
                    if (
                        rep.restored
                        and rep.state is not None
                        and live is not None
                    ):
                        merged = placement.merge_segment(
                            live, rep.state, segments, self.n_hosts,
                            baseline=self.backend.baseline_counters,
                        )
                        # a host table of the live one's shapes, copied
                        # to the serving device: no kernel library is
                        # built or loaded
                        self.backend.drift.bind_ledger(
                            self.backend.spec, merged
                        )
                self._inherited |= segments
                self.owned_segments |= segments
                self.known_epoch = max(self.known_epoch, int(epoch))
                dt = time.perf_counter() - t0
                rows_per_sec = (
                    rep.replayed_rows / dt if dt > 0 else 0.0
                )
                summary = {
                    "segments": sorted(segments),
                    "restored": bool(rep.restored),
                    "replayed_rows": int(rep.replayed_rows),
                    "torn_rows": int(rep.torn_rows),
                    "duration_s": dt,
                    "replay_rows_per_sec": rows_per_sec,
                    "epoch": self.known_epoch,
                }
                self.last_inherit = summary
                metrics.longhaul_failovers.labels(self.host_id).inc()
                metrics.longhaul_failover_duration.set(dt)
                metrics.longhaul_inherited_rows.labels(self.host_id).inc(
                    rep.replayed_rows
                )
                metrics.longhaul_replay_rows_per_sec.set(rows_per_sec)
                log.info(
                    "longhaul host %s: inherited segments %s — %d rows "
                    "replayed in %.3fs", self.host_id, sorted(segments),
                    rep.replayed_rows, dt,
                )
                return summary
            finally:
                self.state = READY
                metrics.longhaul_failover_in_progress.set(0)

    # -- epoch-fenced promotion -------------------------------------------
    def finalize_promotion(self, version: str, epoch: int) -> dict:
        """Apply an alias flip decided under membership epoch ``epoch``.

        The fence consults the directory LIVE: the flip lands only if the
        current epoch still equals the deciding epoch AND this host is
        alive in the current view. A partitioned host cannot reach the
        directory → cannot finalize (fail-safe); a host the detector
        declared dead sees the epoch moved on → refuses. Either way the
        stale flip dies instead of moving traffic."""
        d = self._directory()
        if d is None:
            self.served_version = version
            return {"applied": True, "version": version, "epoch": epoch}
        try:
            view = d.view()
        except (OSError, RuntimeError) as e:
            metrics.longhaul_promotion_fenced.labels(self.host_id).inc()
            return {
                "applied": False, "fenced": True,
                "reason": f"directory unreachable: {e}",
            }
        me = next(
            (m for m in view.members if m.host_id == self.host_id), None
        )
        if view.epoch != int(epoch) or me is None or not me.alive:
            metrics.longhaul_promotion_fenced.labels(self.host_id).inc()
            return {
                "applied": False, "fenced": True,
                "reason": (
                    f"stale epoch: decided at {epoch}, directory at "
                    f"{view.epoch}, alive={bool(me and me.alive)}"
                ),
            }
        self.served_version = version
        self.known_epoch = view.epoch
        return {"applied": True, "version": version, "epoch": view.epoch}

    # -- data plane --------------------------------------------------------
    def start(self) -> None:
        self.join()
        t = threading.Thread(
            target=self._accept_loop,
            name=f"longhaul-{self.host_id}", daemon=True,
        )
        t.start()
        self._threads.append(t)
        if self.directory_addr is not None:
            hb = threading.Thread(
                target=self._hb_loop,
                name=f"longhaul-hb-{self.host_id}", daemon=True,
            )
            hb.start()
            self._threads.append(hb)

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
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
                    continue
                except OSError:
                    return
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
                except Exception as e:  # surfaced to the caller in-band
                    log.debug("host op failed", exc_info=True)
                    try:
                        send_frame(
                            conn,
                            {"ok": False, "error": str(e),
                             "kind": type(e).__name__},
                        )
                    except OSError:
                        return

    def _dispatch(self, op: str, args: dict):
        if op == "score":
            return self._op_score(args)
        if op == "status":
            return self.status()
        if op == "table":
            table = self.backend.table()
            return codec.pack_table(table) if table is not None else None
        if op == "inherit":
            return self.inherit(
                args["peer_dir"], args["segments"], args.get("epoch", 0)
            )
        if op == "promote":
            return self.finalize_promotion(
                args["version"], args["epoch"]
            )
        if op == "scrape":
            return self._op_scrape()
        if op == "ping":
            return {"pong": True, "host_id": self.host_id}
        raise ValueError(f"unknown op: {op}")

    def _op_score(self, args: dict) -> dict:
        if self.state != READY:
            # readiness gate: 503 + Retry-After while inheriting — the
            # front surfaces this verbatim, never a silent misroute
            return {
                "unavailable": True,
                "retry_after_s": config.longhaul_retry_after_s(),
                "reason": self.state,
            }
        boat = self.backend.boat
        if boat is not None and boat.state == "recovering":
            return {
                "unavailable": True,
                "retry_after_s": config.longhaul_retry_after_s(),
                "reason": "recovering",
            }
        rows = codec.unpack_array(args["rows"]).astype(np.float32)
        ents_wire = args.get("ents") or [None] * rows.shape[0]
        # possession gate: the ring may assign us a dead peer's segment
        # before we've replayed its data — those rows get the 503, never
        # a silent serve from a table that hasn't inherited them
        need = {
            placement.host_of(int(e[0]), self.n_hosts)
            if e is not None else 0
            for e in ents_wire
        }
        missing = need - self.owned_segments
        if missing:
            return {
                "unavailable": True,
                "retry_after_s": config.longhaul_retry_after_s(),
                "reason": (
                    f"not owner of segment(s) {sorted(missing)} "
                    "(inheritance pending)"
                ),
            }
        items = []
        for i in range(rows.shape[0]):
            ent = ents_wire[i]
            if ent is not None:
                ent = (int(ent[0]), int(ent[1]), float(ent[2]))
            items.append((rows[i], None, None, ent))
        scores = self.backend.score_items(items)
        return {"scores": codec.pack_array(scores)}

    def _op_scrape(self) -> dict:
        """One host's contribution to a fleet scrape, stamped with the
        epoch this host currently believes — the merge side drops
        contributions whose epoch doesn't match the coordinator's
        (scrape.py: two epochs never double-count a window)."""
        from fraud_detection_tpu_torch.monitor.drift import _window_leaves
        from fraud_detection_tpu_torch.telemetry import slo as slo_mod

        drift = self.backend.drift
        window = None
        if hasattr(drift, "window_snapshot"):
            w = drift.window_snapshot()
            if w is not None:
                # the six leaves in WINDOW_FIELDS order, copied to the host
                window = [codec.pack_array(leaf) for leaf in _window_leaves(w)]
        eng = slo_mod.engine()
        return {
            "host_id": self.host_id,
            "epoch": self.known_epoch,
            "rows_seen": int(getattr(drift, "rows_seen", 0)),
            "window": window,
            "slo": eng.snapshot() if eng is not None else {},
        }

    def status(self) -> dict:
        boat = self.backend.boat
        return {
            "host_id": self.host_id,
            "rank": self.rank,
            "state": self.state,
            "owned_segments": sorted(self.owned_segments),
            "epoch": self.known_epoch,
            "served_version": self.served_version,
            "addr": self.addr,
            "last_inherit": self.last_inherit,
            "lifeboat": boat.status() if boat is not None else None,
        }

    def kill(self) -> None:
        """Abrupt death (scenario hook): close the listener and stop all
        loops without leaving, flushing, or snapshotting — the directory
        finds out the hard way, via missed heartbeats."""
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass

    def close(self) -> None:
        """Clean shutdown: leave the directory first so the epoch bumps
        from an explicit leave, not a detector timeout."""
        d = self._directory()
        if d is not None:
            try:
                d.leave(self.host_id)
            except (OSError, RuntimeError):
                pass
        self.kill()
        for t in self._threads:
            t.join(timeout=2.0)


def build_seeded_backend(seed: int, data_dir: str, host_id: str, device=None):
    """Build the deterministic ledger-widened serving stack every fleet
    member (and the single-host parity reference) shares, on ``device``
    (default ``cuda`` unless ``DEVICE=cpu``): same seed → same weights,
    same baseline profile, same spec — which is what makes routed scores
    comparable bitwise across processes. Returns ``(backend, t0)``."""
    from fraud_detection_tpu_torch.device import resolve_device
    from fraud_detection_tpu_torch.ledger.state import host_state
    from fraud_detection_tpu_torch.lifeboat import Lifeboat
    from fraud_detection_tpu_torch.range.scenarios import (
        _watchtower,
        build_ledger_model,
    )
    from fraud_detection_tpu_torch.service.microbatch import MicroBatcher

    dev = resolve_device(device)
    rm, spec, state0, t0 = build_ledger_model(seed=seed, device=dev)
    wt = _watchtower(rm.profile, halflife=50_000.0, device=dev)
    wt.drift.bind_ledger(spec, state0)
    boat = None
    if data_dir:
        lbdir = os.path.join(data_dir, host_id)
        boat = Lifeboat(
            lbdir, spec, drift=wt.drift, snapshot_s=1e9, fsync_s=0.0,
        )
        boat.recover()
        # seed generation: without this, a peer recovering OUR directory
        # would replay the journal onto a fresh table and lose the seeded
        # warmup state — the inherited segment must start where we did
        boat.take_snapshot()
    mb = MicroBatcher(
        scorer=rm.model.scorer, watchtower=wt, telemetry=False,
        max_batch=512, lifeboat=boat,
    )
    stamp = host_state(state0)
    backend = LedgerBackend(
        rm.model.scorer, wt, spec, mb, boat=boat,
        baseline_counters=(
            float(np.float32(stamp.collisions)),
            float(np.float32(stamp.evictions)),
        ),
    )
    return backend, t0


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description="longhaul serving host")
    p.add_argument("--host-id", default=None,
                   help="member identity (default: LONGHAUL_HOST_ID)")
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--directory", default=None,
                   help="the directory's host:port (default: LONGHAUL_DIRECTORY); "
                        "'' serves alone, owning every segment")
    p.add_argument("--n-hosts", type=int, default=None)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--data-dir", default=None)
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    n_hosts = (
        args.n_hosts if args.n_hosts is not None else config.longhaul_hosts()
    )
    data_dir = (
        args.data_dir
        if args.data_dir is not None
        else config.longhaul_data_dir()
    )
    host_id = (
        args.host_id if args.host_id is not None else config.longhaul_host_id()
    )
    directory = (
        args.directory
        if args.directory is not None
        else config.longhaul_directory()
    )
    backend, _t0 = build_seeded_backend(args.seed, data_dir, host_id)
    log.info("longhaul host %s: serving on %s", host_id, backend.device)
    srv = HostServer(
        host_id,
        backend,
        n_hosts=n_hosts,
        port=args.port,
        directory_addr=directory or None,
    )
    srv.start()
    print(f"LONGHAUL_READY {srv.addr}", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        srv.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
