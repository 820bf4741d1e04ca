"""Warm restart: snapshot + journal tail → the recovered entity table.

The port of the JAX package's ``lifeboat/recovery.py``. The replay is the
serving discipline exactly: journal records fold in sequence (= flush)
order, **one call per record**, through the same
``ledger/features._ledger_read_update`` the ledger flush runs, on the
device the caller names (the drift monitor's when the lifeboat recovers a
serving process). The segmentation matters as much as the body: the body
decays each call's slots to a per-call anchor, so it is order-insensitive
*within* a call but segmentation-sensitive *across* calls — replaying a
flattened tail in other chunks lands ulps off the table serving computed.
A record holds only the flush's entity rows, in staging order; the padding
and entity-less rows serving interleaved add exact zeros, so the replay
(the record padded to its bucket with has-entity 0) lands on the served
bits.

Refusal is loud: a snapshot whose spec hash is not the served model's
:class:`~fraud_detection_tpu_torch.ledger.state.LedgerSpec` is refused (the
caller serves the train-time stamp), never replayed through mismatched
hash geometry.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass

import numpy as np
import torch

from fraud_detection_tpu_torch.device import resolve_device
from fraud_detection_tpu_torch.ledger.features import _ledger_read_update
from fraud_detection_tpu_torch.ledger.replay import REPLAY_BATCH
from fraud_detection_tpu_torch.ledger.state import (
    _MULT,
    LedgerSpec,
    LedgerState,
    device_state,
    host_state,
)
from fraud_detection_tpu_torch.lifeboat import journal as journal_mod
from fraud_detection_tpu_torch.lifeboat import snapshot as snapshot_mod
from fraud_detection_tpu_torch.monitor.drift import DriftWindow
from fraud_detection_tpu_torch.range.faults import fire

log = logging.getLogger("fraud_detection_tpu_torch.lifeboat")


def slots_for(fp: np.ndarray, log2_slots: int) -> np.ndarray:
    """The vectorized multiply-shift slot hash: the array twin of
    ``ledger.state.entity_slot``, bitwise per element."""
    prod = (fp.astype(np.uint64) * np.uint64(_MULT)) & np.uint64(0xFFFFFFFF)
    return (prod >> np.uint64(32 - log2_slots)).astype(np.int32)


class _Replayer:
    """One table on ``device`` and the spec's constants there; :meth:`fold`
    runs the read-update once over a bucket-padded batch of triples."""

    def __init__(self, spec: LedgerSpec, state: LedgerState | None, device):
        self.spec = spec
        self.device = resolve_device(device)
        self.table = device_state(state, spec.slots, self.device)
        self.null = torch.tensor(spec.null_features, dtype=torch.float32,
                                 device=self.device)
        self.halflife = torch.tensor(spec.halflife_s, dtype=torch.float32,
                                     device=self.device)

    def fold(self, fp: np.ndarray, ts: np.ndarray, amount: np.ndarray,
             bucket: int) -> None:
        """Fold ``n ≤ bucket`` rows: padded to ``bucket`` with fingerprint
        0 and has-entity 0, which leave every slot bitwise unchanged."""
        fp = np.ascontiguousarray(fp).astype(np.uint32, copy=False)
        pad = bucket - fp.shape[0]

        def dev(a: np.ndarray, dtype) -> torch.Tensor:
            return torch.from_numpy(np.pad(a.astype(dtype, copy=False), (0, pad))).to(
                self.device)

        _ledger_read_update(
            self.table,
            dev(slots_for(fp, self.spec.log2_slots), np.int64),
            dev(fp, np.int64),
            dev(np.asarray(ts), np.float32),
            dev(np.asarray(amount), np.float32),
            dev((fp != 0), np.float32),
            self.null,
            self.halflife,
        )

    def host(self) -> LedgerState:
        return host_state(self.table)


def replay_rows(
    spec: LedgerSpec,
    state: LedgerState | None,
    fp: np.ndarray,
    ts: np.ndarray,
    amount: np.ndarray,
    batch: int = REPLAY_BATCH,
    device=None,
) -> LedgerState:
    """Fold loose journal triples onto ``state`` through the read-update,
    in timestamp order (a stable sort: rows of one timestamp keep their
    input order), in fixed-size batches. Deterministic, but NOT the
    recovery's discipline: a warm restart uses :func:`replay_records`,
    whose one call per record is what makes it bitwise serving. This form
    serves tooling holding rows without flush framing. Returns the host
    table."""
    rep = _Replayer(spec, state, device)
    order = np.argsort(np.asarray(ts, np.float32), kind="stable")
    fp_o = np.asarray(fp, np.uint32)[order]
    ts_o = np.asarray(ts, np.float32)[order]
    amt_o = np.asarray(amount, np.float32)[order]
    for lo in range(0, int(fp_o.shape[0]), batch):
        hi = lo + batch
        rep.fold(fp_o[lo:hi], ts_o[lo:hi], amt_o[lo:hi], batch)
    return rep.host()


def _bucket(n: int, floor: int = REPLAY_BATCH) -> int:
    """The replay call's shape for an ``n``-row record: the smallest power
    of two ≥ max(n, floor). Padding rows carry has-entity 0 and leave every
    slot bitwise unchanged."""
    b = max(int(floor), 1)
    while b < n:
        b <<= 1
    return b


def replay_records(
    spec: LedgerSpec,
    state: LedgerState | None,
    records,
    batch_floor: int = REPLAY_BATCH,
    device=None,
) -> LedgerState:
    """Fold journal records onto ``state`` with the serving segmentation:
    one read-update call per record, records in sequence order, rows in
    journal (= staging) order, on ``device`` (default: ``cuda`` unless
    ``DEVICE=cpu``). This is THE recovery replay: bitwise the table an
    uninterrupted serve of the same flushes holds. Returns the host
    table."""
    rep = _Replayer(spec, state, device)
    for _seq, fp, ts, amt in records:
        n = int(fp.shape[0])
        if n:
            rep.fold(fp, ts, amt, _bucket(n, batch_floor))
    return rep.host()


@dataclass
class RecoveryReport:
    """What a warm restart did: ``/lifeboat/status``'s, the metrics' and the
    runbook's evidence."""

    ok: bool = True
    restored: bool = False  # a snapshot (or a journal tail) bound
    refused_reason: str | None = None
    snapshot_seq: int = 0
    snapshot_path: str | None = None
    snapshot_created_at: float = 0.0
    slot_version: int | None = None
    generations_skipped: int = 0
    replayed_rows: int = 0
    torn_rows: int = 0
    corrupt_mid_file: int = 0
    resume_seq: int = 0  # the journal continues from here
    duration_s: float = 0.0
    rows_seen: int = 0
    state: LedgerState | None = None
    window: DriftWindow | None = None
    shard_window: DriftWindow | None = None

    def to_dict(self) -> dict:
        return {
            "ok": self.ok,
            "restored": self.restored,
            "refused_reason": self.refused_reason,
            "snapshot_seq": self.snapshot_seq,
            "generations_skipped": self.generations_skipped,
            "replayed_rows": self.replayed_rows,
            "torn_rows": self.torn_rows,
            "corrupt_mid_file": self.corrupt_mid_file,
            "resume_seq": self.resume_seq,
            "duration_s": round(self.duration_s, 6),
        }


def recover(directory: str, spec: LedgerSpec, device=None) -> RecoveryReport:
    """Load the newest CRC-valid generation (falling back per torn file),
    replay the journal tail through the read-update on ``device`` and
    return the recovered host state — free of any serving wiring, so a
    drill drives it exactly as the app does."""
    t0 = time.perf_counter()
    rep = RecoveryReport()
    # the injection point a drill stalls to hold the app in its 503
    # "recovering" window
    fire("lifeboat.recover", directory=directory)
    snap, skipped = snapshot_mod.load_latest(directory)
    rep.generations_skipped = skipped
    expect = snapshot_mod.spec_hash(spec)
    if snap is not None and snap.spec_hash != expect:
        # refuse loudly: the caller serves the train-time stamp instead
        rep.ok = False
        rep.refused_reason = (
            f"snapshot {snap.path} was taken under LedgerSpec hash "
            f"{snap.spec_hash}, served model expects {expect} — refusing; "
            "serving from the train-time stamp"
        )
        log.error("lifeboat: %s", rep.refused_reason)
        # resume journaling PAST everything on disk: restarting at seq 0
        # would land every new-spec generation below the stale snapshot's
        # seq, so load_latest would refuse forever and pruning would delete
        # the valid new-spec generations first. Sequencing past the stale
        # file lets the next snapshot supersede it and rotation age it out.
        old_tail = journal_mod.read_tail(directory, 0)
        rep.resume_seq = max(snap.seq, old_tail.max_seq)
        rep.duration_s = time.perf_counter() - t0
        return rep
    if snap is None:
        # no valid snapshot: replay whatever journal there is onto a fresh
        # table — a process that crashed before its first snapshot still
        # recovers its journaled rows (each file's header hash-checked)
        tail = journal_mod.read_tail(directory, 0, expect_hash=expect)
        rep.torn_rows = tail.torn_rows
        rep.corrupt_mid_file = tail.corrupt_mid_file
        rep.resume_seq = tail.max_seq
        if tail.fp.shape[0]:
            rep.state = replay_records(spec, None, tail.records, device=device)
            rep.replayed_rows = int(tail.fp.shape[0])
            rep.restored = True
        rep.duration_s = time.perf_counter() - t0
        return rep
    tail = journal_mod.read_tail(directory, snap.seq, expect_hash=expect)
    rep.snapshot_seq = snap.seq
    rep.snapshot_path = snap.path
    rep.snapshot_created_at = snap.created_at
    rep.slot_version = snap.slot_version
    rep.rows_seen = snap.rows_seen
    rep.torn_rows = tail.torn_rows
    rep.corrupt_mid_file = tail.corrupt_mid_file
    rep.resume_seq = max(tail.max_seq, snap.seq)
    rep.state = replay_records(spec, snap.ledger, tail.records, device=device)
    rep.replayed_rows = int(tail.fp.shape[0])
    rep.window = snap.window
    rep.shard_window = snap.shard_window
    rep.restored = True
    rep.duration_s = time.perf_counter() - t0
    log.info(
        "lifeboat: warm restart from seq %d (%d generation(s) skipped), "
        "replayed %d journaled row(s) in %.3fs, %d torn row(s) lost",
        snap.seq, skipped, rep.replayed_rows, rep.duration_s, rep.torn_rows,
    )
    return rep
