"""The entity journal: a host-side append-only log of the ledger's inputs.

The port of the JAX package's ``lifeboat/journal.py``, its file format byte
for byte. Every ledger flush folds exactly three per-row quantities into
the device table (``ledger/features._ledger_read_update``): the entity
fingerprint, the origin-relative event time and the amount **as the flush
consumes it** (the dequantized code on the int8 wire, the bf16-rounded
value on the bf16 wire). The journal records those triples and nothing
else, so a warm restart replays the tail through the same body.

File layout (``journal-{base_seq:012d}.wal``; ``base_seq`` is the flush
sequence number of the snapshot the file was rotated at, and every record
in it carries ``seq > base_seq``)::

    header:  "LBJ1" | version u16 | base_seq u64 | spec_hash 16s | crc u32
    record:  "LR" | n u32 | seq u64 | fp u32[n] | ts f32[n] | amt f32[n]
             | crc u32  (over the n/seq fields and the payload)

Fingerprints are ``uint32`` on disk; the port stages them as ``int64`` and
:meth:`Journal.append` casts them. One record a flush; the fsync cadence
is ``LIFEBOAT_FSYNC_S`` (0: every append), and the appended rows not yet
fsynced are the crash-loss bound (``lifeboat_journal_lag_rows``). The
reader checks every record's CRC and **resyncs on the record magic** past
a bad region: a torn tail (the crash shape: the last record half-written)
is skipped with its rows counted (``lifeboat_torn_tail_rows``), and a
corrupt record mid-file (disk damage, not a crash) is skipped loudly while
every later valid record still replays.
"""

from __future__ import annotations

import logging
import os
import re
import struct
import zlib
from dataclasses import dataclass, field

import numpy as np

from fraud_detection_tpu_torch.utils import lockdep

log = logging.getLogger("fraud_detection_tpu_torch.lifeboat")

J_MAGIC = b"LBJ1"
REC_MAGIC = b"LR"
J_VERSION = 1

JOURNAL_RE = re.compile(r"^journal-(\d{12})\.wal$")

_HDR = struct.Struct("<4sHQ16s")  # magic, version, base_seq, spec_hash
_HDR_CRC = struct.Struct("<I")
_REC = struct.Struct("<2sIQ")  # magic, n, seq
_REC_CRC = struct.Struct("<I")

#: rows-per-record sanity bound for the resyncing reader — a corrupt
#: length field must not be trusted into a gigabyte read
_MAX_REC_ROWS = 1 << 22


def journal_path(directory: str, base_seq: int) -> str:
    return os.path.join(directory, f"journal-{base_seq:012d}.wal")


def list_journals(directory: str) -> list[tuple[int, str]]:
    """(base_seq, path), oldest → newest."""
    out: list[tuple[int, str]] = []
    try:
        names = os.listdir(directory)
    except OSError:
        return out
    for name in names:
        m = JOURNAL_RE.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(directory, name)))
    out.sort()
    return out


class Journal:
    """The write side. One open file, records appended under the caller's
    serialization (the lifeboat flush lock couples append order to dispatch
    order); ``sync()``/``rotate()`` are internally locked so the
    maintenance thread's fsync tick can run beside appends."""

    def __init__(
        self,
        directory: str,
        spec_hash: str,
        base_seq: int = 0,
        fsync_s: float = 0.5,
    ):
        self.directory = directory
        self.spec_hash = spec_hash
        self.fsync_s = float(fsync_s)
        self.seq = int(base_seq)  # last assigned flush sequence number
        self.pending_rows = 0  # appended but not yet fsynced (the lag bound)
        self.rows_appended = 0
        self._lock = lockdep.lock("lifeboat.journal")
        self._f = None
        os.makedirs(directory, exist_ok=True)
        self._open(int(base_seq))

    def _open(self, base_seq: int) -> None:
        path = journal_path(self.directory, base_seq)
        f = open(path, "ab")
        if f.tell() == 0:
            header = _HDR.pack(
                J_MAGIC, J_VERSION, base_seq,
                self.spec_hash.encode()[:16].ljust(16, b"\0"),
            )
            f.write(header + _HDR_CRC.pack(zlib.crc32(header)))
            f.flush()
            os.fsync(f.fileno())
        self._f = f
        self.base_seq = base_seq

    def append(self, fp: np.ndarray, ts: np.ndarray, amount: np.ndarray) -> int:
        """Append one flush's entity triples as a single CRC-framed record;
        returns the record's flush sequence number. Arrays must be aligned
        1-D; rows are copied into the record bytes immediately, so staging
        buffers can recycle the moment this returns. The fingerprints may
        come as the staging's ``int64`` (0..2³²−1): they are written as
        ``uint32``."""
        n = int(fp.shape[0])
        fp = np.ascontiguousarray(fp).astype(np.uint32, copy=False)
        ts = np.ascontiguousarray(ts, np.float32)
        amount = np.ascontiguousarray(amount, np.float32)
        if ts.shape[0] != n or amount.shape[0] != n:
            raise ValueError("journal triple arrays must be aligned")
        with self._lock:
            if self._f is None:
                # closed (shutdown raced an in-flight flush): the rows
                # still dispatch, they just aren't journaled — the same
                # bounded loss as a crash in the fsync window, not an
                # AttributeError inside the flush lock
                return self.seq
            self.seq += 1
            seq = self.seq
            head = _REC.pack(REC_MAGIC, n, seq)
            payload = fp.tobytes() + ts.tobytes() + amount.tobytes()
            crc = zlib.crc32(head[2:])  # n + seq fields
            crc = zlib.crc32(payload, crc)
            self._f.write(head + payload + _REC_CRC.pack(crc))
            self.pending_rows += n
            self.rows_appended += n
            if self.fsync_s == 0:
                # LIFEBOAT_FSYNC_S=0 is a group commit per append by contract: the fsync is the
                # critical section
                # lockcheck: ignore[blocking-under-lock] (the reason above)
                self._sync_locked()
        return seq

    def _sync_locked(self) -> None:
        self._f.flush()
        os.fsync(self._f.fileno())
        self.pending_rows = 0

    def sync(self) -> None:
        """Make every appended record durable; zeroes the lag bound."""
        with self._lock:
            if self._f is not None:
                # the durability tick: appends must not interleave with the sync point
                # lockcheck: ignore[blocking-under-lock] (the reason above)
                self._sync_locked()

    def rotate(self, new_base_seq: int) -> None:
        """Close the current file (synced) and start a fresh one — called
        at snapshot boundaries with the snapshot's sequence number, so each
        journal file spans exactly one inter-snapshot interval and pruning
        by base sequence is safe."""
        with self._lock:
            if self._f is not None:
                # rotation seals the old file; a racing append must land in the new one
                # lockcheck: ignore[blocking-under-lock] (the reason above)
                self._sync_locked()
                self._f.close()
            # the directory fsync that makes the rotated file durable; the same seal
            # lockcheck: ignore[blocking-under-lock] (the reason above)
            self._open(int(new_base_seq))

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                # close drains under the lock so no append races the final sync
                # lockcheck: ignore[blocking-under-lock] (the reason above)
                self._sync_locked()
                self._f.close()
                self._f = None


@dataclass
class JournalTail:
    """Everything read back past a snapshot point.

    ``records`` preserves the per-flush framing — one entry per journaled
    flush, in sequence (= dispatch) order. Recovery MUST fold these one
    dispatch per record: the traced body decays each dispatch's slots to a
    per-dispatch anchor, so the fold is order-insensitive *within* a
    record but segmentation-sensitive *across* them — replaying a
    flattened tail in arbitrary chunks lands ulp-level off the table the
    serving process computed, and the chaos parity invariant is bitwise.
    The flattened ``fp``/``ts``/``amount`` views remain for accounting and
    order-insensitive consumers."""

    fp: np.ndarray  # (n,) uint32
    ts: np.ndarray  # (n,) f32
    amount: np.ndarray  # (n,) f32
    records: list = field(default_factory=list)  # [(seq, fp, ts, amount)]
    n_records: int = 0
    torn_rows: int = 0  # rows in CRC-failed/truncated records (bounded loss)
    corrupt_mid_file: int = 0  # corrupt records NOT at a file tail
    max_seq: int = 0


def read_journal_file(path: str):
    """Yield ``(seq, fp, ts, amount)`` per valid record, plus a summary.

    Returns ``(records, torn_rows, mid_file_corruptions, header_ok,
    header_spec_hash)`` — the hash is the 16-hex-char ``LedgerSpec``
    identity the writer stamped (``None`` when the header is torn), so
    callers can refuse records written under different hash geometry.
    The reader is resyncing: after a CRC/length failure it scans forward
    for the next record magic, so one damaged record never hides the rest
    of the file. Rows lost to damage are counted from the failed record's
    parsed length when plausible."""
    try:
        with open(path, "rb") as f:
            blob = f.read()
    except OSError as e:
        log.error("lifeboat: unreadable journal %s: %s", path, e)
        return [], 0, 0, False, None
    records: list[tuple[int, np.ndarray, np.ndarray, np.ndarray]] = []
    good_offsets: list[int] = []  # start offsets of CRC-valid records
    torn_rows = 0
    failures: list[int] = []  # byte offsets of failed parses
    hdr_len = _HDR.size + _HDR_CRC.size
    header_ok = False
    header_hash = None
    off = 0
    if len(blob) >= hdr_len and blob[:4] == J_MAGIC:
        head = blob[: _HDR.size]
        (crc,) = _HDR_CRC.unpack_from(blob, _HDR.size)
        if zlib.crc32(head) == crc:
            header_ok = True
            off = hdr_len
            _magic, _ver, _base, hash_bytes = _HDR.unpack(head)
            header_hash = hash_bytes.rstrip(b"\0").decode(
                "ascii", "replace"
            )
    if not header_ok:
        log.error("lifeboat: journal %s has a bad/torn header", path)
        # resync into the body anyway — records are self-framed
        off = 0
    n_bytes = len(blob)
    while off < n_bytes:
        idx = blob.find(REC_MAGIC, off)
        if idx < 0:
            if off < n_bytes:
                failures.append(off)
            break
        if idx != off:
            failures.append(off)
        off = idx
        if off + _REC.size > n_bytes:
            failures.append(off)
            break
        magic, n, seq = _REC.unpack_from(blob, off)
        if n > _MAX_REC_ROWS:
            failures.append(off)
            off += len(REC_MAGIC)
            continue
        body_len = n * 12
        end = off + _REC.size + body_len + _REC_CRC.size
        if end > n_bytes:
            # truncated record — the torn-tail shape. Keep scanning rather
            # than stopping: a spurious magic match inside a corrupt
            # region can also land here, and breaking would drop every
            # valid record after the damage.
            torn_rows += n
            failures.append(off)
            off += len(REC_MAGIC)
            continue
        payload = blob[off + _REC.size : off + _REC.size + body_len]
        (crc,) = _REC_CRC.unpack_from(blob, off + _REC.size + body_len)
        calc = zlib.crc32(blob[off + 2 : off + _REC.size])
        calc = zlib.crc32(payload, calc)
        if calc != crc:
            torn_rows += n
            failures.append(off)
            off += len(REC_MAGIC)  # resync past the bad magic
            continue
        fp = np.frombuffer(payload, np.uint32, count=n)
        ts = np.frombuffer(payload, np.float32, count=n, offset=4 * n)
        amt = np.frombuffer(payload, np.float32, count=n, offset=8 * n)
        records.append((int(seq), fp, ts, amt))
        good_offsets.append(off)
        off = end
    # a failure with a CRC-VALID record after it is mid-file corruption
    # (disk damage — a crash can only tear the tail); failures past the
    # last good record are the ordinary torn tail
    last_good = good_offsets[-1] if good_offsets else -1
    mid_file = sum(1 for x in failures if x < last_good)
    if mid_file:
        log.error(
            "lifeboat: journal %s has %d corrupt region(s) MID-file (valid "
            "records follow) — this is disk damage, not a torn tail; "
            "replaying around it",
            path,
            mid_file,
        )
    return records, torn_rows, mid_file, header_ok, header_hash


def read_tail(
    directory: str, after_seq: int, expect_hash: str | None = None
) -> JournalTail:
    """Collect every journal record with ``seq > after_seq`` across all
    journal files, in sequence (= dispatch) order — the replay input for a
    snapshot taken at ``after_seq``. Per-flush framing is preserved in
    ``records``; the flattened arrays are concatenated views of the same
    rows.

    ``expect_hash`` (the served spec's identity, as the snapshot side
    checks it) refuses files whose VALID header was stamped under a
    different ``LedgerSpec`` — replaying old-geometry triples into a new
    table silently scrambles entities, the same hazard the snapshot
    refusal guards. A torn header can't be judged and still replays (the
    crash shape, bounded by the fsync cadence — not a spec change)."""
    torn = 0
    mid = 0
    max_seq = int(after_seq)
    collected: list[tuple[int, np.ndarray, np.ndarray, np.ndarray]] = []
    for base, path in list_journals(directory):
        records, t, m, header_ok, header_hash = read_journal_file(path)
        if (
            expect_hash is not None
            and header_ok
            and header_hash != expect_hash[:16]
        ):
            log.error(
                "lifeboat: journal %s was written under LedgerSpec hash "
                "%s, served model expects %s — refusing its records "
                "(serving geometry changed; the stale file ages out at "
                "the next snapshot rotation)",
                path, header_hash, expect_hash[:16],
            )
            continue
        torn += t
        mid += m
        for seq, fp, ts, amt in records:
            if seq > after_seq:
                collected.append((seq, fp, ts, amt))
                max_seq = max(max_seq, seq)
    collected.sort(key=lambda r: r[0])
    if collected:
        return JournalTail(
            fp=np.concatenate([r[1] for r in collected]),
            ts=np.concatenate([r[2] for r in collected]),
            amount=np.concatenate([r[3] for r in collected]),
            records=collected,
            n_records=len(collected),
            torn_rows=torn,
            corrupt_mid_file=mid,
            max_seq=max_seq,
        )
    return JournalTail(
        fp=np.zeros(0, np.uint32),
        ts=np.zeros(0, np.float32),
        amount=np.zeros(0, np.float32),
        records=[],
        n_records=0,
        torn_rows=torn,
        corrupt_mid_file=mid,
        max_seq=max_seq,
    )


def prune_journals(directory: str, keep_after_base: int) -> list[int]:
    """Drop journal files whose base sequence predates the oldest retained
    snapshot — rotation happens AT snapshot boundaries, so a file with
    ``base < oldest_snapshot_seq`` contains only records the oldest
    retained snapshot already covers."""
    pruned: list[int] = []
    for base, path in list_journals(directory):
        if base < keep_after_base:
            try:
                os.unlink(path)
                pruned.append(base)
            except OSError:  # already gone
                pass
    return pruned
