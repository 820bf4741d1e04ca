"""The lifeboat: crash-consistent durability for the state on the device.

The port of the JAX package's ``lifeboat/boat.py``. One :class:`Lifeboat`
a serving process has three jobs:

1. **Journal** (write-ahead, on the flush path): the micro-batcher calls
   :meth:`journal_staged` under :attr:`flush_lock` just before the ledger
   flush's launches, appending the flush's entity triples (fingerprint,
   time, the amount the flush consumes) as one CRC-framed record. The lock
   couples the journal's sequence numbers to the flushes' order on the
   device stream, so a snapshot cut is consistent: every flush with ``seq ≤
   snapshot_seq`` was enqueued into the table the snapshot copies.
2. **Snapshots** (the maintenance thread, off the hot path): every
   ``LIFEBOAT_SNAPSHOT_S`` seconds (or ``LIFEBOAT_SNAPSHOT_FLUSHES``
   flushes) clone the table and the drift window on the device under
   :attr:`flush_lock` — the flushes update them in place, so a numpy view
   would not be a snapshot — capture the journal's seq and rotate the
   journal in the same critical section; the device-to-host copy, the
   serialization and the atomic write run outside the lock.
   ``LIFEBOAT_KEEP`` generations are kept. The same thread drives the
   journal's fsync cadence (``LIFEBOAT_FSYNC_S``) and the snapshot-age
   gauge.
3. **Warm restart** (:meth:`recover`): load the newest valid generation,
   replay the journal tail through the ledger's read-update on the drift
   monitor's device — one call per journaled flush, the serving
   segmentation (see :func:`~.recovery.replay_records`) — bind the
   recovered table and window into the monitor, and flip :attr:`state`
   ``recovering → ready``. The app answers 503 with ``Retry-After`` on
   every scoring edge while ``recovering``.
"""

from __future__ import annotations

import logging
import threading
import time

import numpy as np
import torch

from fraud_detection_tpu_torch import config
from fraud_detection_tpu_torch.ledger.state import LedgerSpec, host_state
from fraud_detection_tpu_torch.lifeboat import journal as journal_mod
from fraud_detection_tpu_torch.lifeboat import recovery as recovery_mod
from fraud_detection_tpu_torch.lifeboat import snapshot as snapshot_mod
from fraud_detection_tpu_torch.range.faults import fire
from fraud_detection_tpu_torch.service import metrics
from fraud_detection_tpu_torch.utils import lockdep

log = logging.getLogger("fraud_detection_tpu_torch.lifeboat")

IDLE = "idle"
RECOVERING = "recovering"
READY = "ready"

#: the maintenance thread's tick: the resolution of the fsync cadence and
#: of the snapshot-age gauge
_TICK_S = 0.2


class Lifeboat:
    def __init__(
        self,
        directory: str,
        spec: LedgerSpec,
        drift=None,
        slot=None,
        snapshot_s: float | None = None,
        snapshot_flushes: int | None = None,
        keep: int | None = None,
        fsync_s: float | None = None,
        device=None,
    ):
        self.directory = directory
        self.spec = spec
        self.drift = drift
        # the device a recovery without a drift monitor replays on
        self.device = device
        self.slot = slot  # the lifecycle ModelSlot (a snapshot's version stamp)
        self.snapshot_s = (
            snapshot_s if snapshot_s is not None else config.lifeboat_snapshot_s()
        )
        self.snapshot_flushes = (
            snapshot_flushes if snapshot_flushes is not None
            else config.lifeboat_snapshot_flushes()
        )
        self.keep = keep if keep is not None else config.lifeboat_keep()
        self.fsync_s = fsync_s if fsync_s is not None else config.lifeboat_fsync_s()
        self.spec_hash = snapshot_mod.spec_hash(spec)
        self.state = IDLE
        #: couples {journal append → ledger flush launches} on the flush
        #: path and {table + window clone → seq capture → rotate} on the
        #: snapshot path: both hold it, so a cut never splits a flush from
        #: its journal record
        self.flush_lock = lockdep.lock("lifeboat.flush")
        self.journal: journal_mod.Journal | None = None
        self.last_report: recovery_mod.RecoveryReport | None = None
        #: host seconds of the last snapshot's phases: the clone under the
        #: lock, the device-to-host copy, the serialization and write
        self.last_snapshot_times: dict[str, float] = {}
        self._flushes_since_snapshot = 0
        self._last_snapshot_t = time.time()
        self._snapshot_requested = threading.Event()
        self._last_fsync_t = time.time()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        #: set by :meth:`close`, under :attr:`_life_lock` with the journal's
        #: bind and the thread's start: a recovery or a ``start()`` that
        #: comes after a shutdown opens no journal and starts no thread
        self._closed = False
        self._life_lock = threading.Lock()
        # the int8 wire's dequant scale on the host, keyed on the device
        # tensor it was copied from (it changes only with a hot swap)
        self._scale_host: tuple | None = None
        metrics.lifeboat_journal_lag_rows.set(0)

    # -- warm restart ------------------------------------------------------
    def _device(self):
        """The device the recovery replays on: the drift monitor's, else
        ``device``, else the process default (``cuda`` unless
        ``DEVICE=cpu``)."""
        return getattr(self.drift, "device", None) or self.device

    def recover(self) -> recovery_mod.RecoveryReport:
        """Run the warm restart and bind the result. Flips ``state``
        recovering → ready (ready on a refused or empty recovery too: the
        process then serves the train-time stamp, and journaling starts
        either way)."""
        self.state = RECOVERING
        t0 = time.perf_counter()
        try:
            rep = recovery_mod.recover(self.directory, self.spec, device=self._device())
            self.last_report = rep
            if rep.restored and rep.state is not None and self.drift is not None:
                # the same shapes as the table bound at start-up
                self.drift.bind_ledger(self.spec, rep.state)
                if rep.window is not None:
                    self.drift.restore_window(
                        rep.window, shard_window=rep.shard_window,
                        rows_seen=rep.rows_seen or None,
                    )
            metrics.lifeboat_replayed_rows.inc(rep.replayed_rows)
            if rep.torn_rows:
                metrics.lifeboat_torn_tail_rows.inc(rep.torn_rows)
            metrics.lifeboat_recovery_duration.set(rep.duration_s)
            # the snapshot age continues from the restored generation: a
            # process restarting every few minutes without snapshotting
            # still trips SnapshotStale
            if rep.snapshot_created_at:
                self._last_snapshot_t = rep.snapshot_created_at
            journal = journal_mod.Journal(
                self.directory, self.spec_hash, base_seq=rep.resume_seq,
                fsync_s=self.fsync_s,
            )
            with self._life_lock:
                if self._closed:  # shut down during the replay
                    journal.close()
                else:
                    self.journal = journal
            return rep
        finally:
            self.state = READY
            metrics.lifeboat_recovery_duration.set(time.perf_counter() - t0)
            metrics.lifeboat_snapshot_age.set(
                max(0.0, time.time() - self._last_snapshot_t)
            )

    # -- the flush-path hook -----------------------------------------------
    def _host_scale(self, dequant_scale) -> np.ndarray:
        if not isinstance(dequant_scale, torch.Tensor):
            return np.asarray(dequant_scale, np.float32).reshape(-1)
        cached = self._scale_host
        if cached is None or cached[0] is not dequant_scale:
            cached = self._scale_host = (
                dequant_scale, dequant_scale.cpu().numpy().astype(np.float32).reshape(-1))
        return cached[1]

    def journal_staged(self, slot, hx, dequant_scale, n_rows: int) -> None:
        """Append one staged flush's entity triples. The micro-batcher calls
        it UNDER :attr:`flush_lock`, just before the ledger flush. ``hx`` is
        the wire-encoded batch the flush consumes (an f32 or int8 ndarray,
        or a ``torch.bfloat16`` tensor on the bf16 wire); the journaled
        amount is computed from it as ``monitor/drift._fused_flush_ledger``
        computes it — the upcast to f32, times the dequant scale on the
        int8 wire, the amount column — so the replay folds the floats
        serving folded."""
        journal = self.journal
        if journal is None or self.state != READY:
            return
        self._flushes_since_snapshot += 1
        lh = slot.lh
        mask = lh != 0
        n = int(mask.sum())
        if not n:
            return
        fp = slot.lf[mask]
        ts = slot.lt[mask]
        # mask BEFORE the upcast: n rows, not the bucket (the flush path)
        col = hx[: lh.shape[0], self.spec.amount_col]
        if isinstance(col, torch.Tensor):
            # bf16 → f32 is exact; numpy has no bf16
            amt = col.float().numpy()[mask]
        else:
            amt = col[mask].astype(np.float32)
        if dequant_scale is not None:
            amt = amt * self._host_scale(dequant_scale)[self.spec.amount_col]
        seq = journal.append(fp, ts, amt)
        metrics.lifeboat_journal_lag_rows.set(journal.pending_rows)
        # the injection point a drill kills at: after the record is written
        # (durable with fsync-per-append), before the flush launches
        fire("lifeboat.journal", seq=seq, rows=n)

    # -- snapshots ---------------------------------------------------------
    def take_snapshot(self) -> str | None:
        """Cut a consistent {table, window, seq} and land one generation.
        The lock is held for the device clones (enqueued on the stream the
        flushes use, after the last journaled flush) and the journal's
        rotation; the device-to-host copy, the serialization and the atomic
        write run outside it."""
        drift = self.drift
        journal = self.journal
        if drift is None or journal is None:
            return None
        t0 = time.perf_counter()
        with self.flush_lock:
            table = drift.ledger_snapshot()
            if table is None:
                return None
            window = drift.window_snapshot()
            shard_window = drift.shard_window_snapshot()
            rows_seen = drift.rows_seen
            seq = journal.seq
            # everything ≤ seq is in the clones; make it durable and start
            # the next inter-snapshot journal interval
            journal.rotate(seq)
            self._flushes_since_snapshot = 0
        t1 = time.perf_counter()
        table = host_state(table)
        window = type(window)(*(t.cpu().numpy() for t in window.tensors()))
        t2 = time.perf_counter()
        # the injection point a drill kills at: the generation has NOT
        # landed, so a kill leaves the previous generation and a rotated
        # journal, exactly what the fallback replays
        fire("lifeboat.snapshot", seq=seq)
        path = snapshot_mod.write_snapshot(
            self.directory, seq, self.spec, table, window=window,
            shard_window=shard_window,
            slot_version=getattr(self.slot, "version", None),
            rows_seen=rows_seen,
        )
        self.last_snapshot_times = {
            "clone_s": t1 - t0, "d2h_s": t2 - t1, "write_s": time.perf_counter() - t2,
        }
        self._last_snapshot_t = time.time()
        metrics.lifeboat_snapshot_age.set(0.0)
        metrics.lifeboat_journal_lag_rows.set(journal.pending_rows)
        snapshot_mod.prune_snapshots(self.directory, self.keep)
        kept = snapshot_mod.list_snapshots(self.directory)
        if kept:
            journal_mod.prune_journals(self.directory, kept[0][0])
        log.info("lifeboat: snapshot generation %d landed (%s)", seq, path)
        return path

    def request_snapshot(self) -> None:
        """Ask the maintenance thread for a snapshot now."""
        self._snapshot_requested.set()

    # -- the maintenance thread --------------------------------------------
    def start(self) -> None:
        """Start the maintenance thread; a no-op once :meth:`close` ran."""
        with self._life_lock:
            if self._closed or (self._thread is not None and self._thread.is_alive()):
                return
            self._stop.clear()
            self._thread = threading.Thread(target=self._loop, name="lifeboat", daemon=True)
            self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(_TICK_S):
            try:
                now = time.time()
                metrics.lifeboat_snapshot_age.set(max(0.0, now - self._last_snapshot_t))
                journal = self.journal
                if (
                    journal is not None
                    and self.fsync_s > 0
                    and journal.pending_rows
                    and now - self._last_fsync_t >= self.fsync_s
                ):
                    journal.sync()
                    self._last_fsync_t = now
                    metrics.lifeboat_journal_lag_rows.set(0)
                due = (
                    self._snapshot_requested.is_set()
                    or (now - self._last_snapshot_t) >= self.snapshot_s
                    or (
                        self.snapshot_flushes > 0
                        and self._flushes_since_snapshot >= self.snapshot_flushes
                    )
                )
                if due and self.state == READY:
                    self._snapshot_requested.clear()
                    self.take_snapshot()
            except Exception:
                log.exception("lifeboat maintenance tick failed")

    def close(self, final_snapshot: bool = False) -> None:
        """Stop the maintenance thread; sync (and optionally snapshot), so
        a clean shutdown loses nothing. A later :meth:`start` or the end of
        a recovery still running opens nothing again."""
        with self._life_lock:
            self._closed = True
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if final_snapshot and self.state == READY:
            try:
                self.take_snapshot()
            except Exception:
                log.exception("lifeboat final snapshot failed")
        if self.journal is not None:
            self.journal.close()

    # -- status ------------------------------------------------------------
    def status(self) -> dict:
        journal = self.journal
        return {
            "state": self.state,
            "directory": self.directory,
            "snapshot_age_s": max(0.0, time.time() - self._last_snapshot_t),
            "journal_seq": journal.seq if journal else 0,
            "journal_lag_rows": journal.pending_rows if journal else 0,
            "generations": [s for s, _ in snapshot_mod.list_snapshots(self.directory)],
            "last_recovery": self.last_report.to_dict() if self.last_report else None,
        }
