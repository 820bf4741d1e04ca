"""Versioned, CRC-stamped snapshots of the serving state on the device.

The port of the JAX package's ``lifeboat/snapshot.py``, its file format
byte for byte. One snapshot file (``lifeboat-{seq:012d}.snap``) holds what
a warm restart needs to rebuild the state the flushes update in place: the
ledger's hashed entity table, the drift window, the
:class:`~fraud_detection_tpu_torch.ledger.state.LedgerSpec` geometry it was
built against, and what anchors the journal replay — the **flush sequence
number** the table covers, the model slot version serving it and the spec
hash a loader must match.

Layout (little-endian, every section CRC-guarded so that a cut at any
boundary is detected, never trusted)::

    magic "LBS1" | version u16 | header_len u32 | header JSON
    | header_crc u32 | payload (npz bytes) | payload_crc u32

The header JSON carries ``{seq, slot_version, spec_hash, created_at,
rows_seen, payload_len}``; the payload is a plain ``np.savez`` archive with
the reference's keys: ``spec_*``, the five table arrays (the fingerprint
``uint32``) and ``win_*`` for the window's six fields in the reference's
``DriftWindow`` order (:data:`~fraud_detection_tpu_torch.monitor.drift.
WINDOW_FIELDS`). Files land through ``ckpt/atomic`` (tmp → fsync → rename
→ dir fsync) and ``LIFEBOAT_KEEP`` generations are kept: a torn newest
file falls back one generation instead of failing the recovery.
"""

from __future__ import annotations

import hashlib
import io
import json
import logging
import os
import re
import struct
import time
import zlib
from dataclasses import dataclass

import numpy as np
import torch

from fraud_detection_tpu_torch.ckpt.atomic import atomic_write_bytes, savez_bytes
from fraud_detection_tpu_torch.ledger.state import LedgerSpec, LedgerState, host_state
from fraud_detection_tpu_torch.monitor.drift import (
    WINDOW_FIELDS,
    DriftWindow,
    _window_leaves,
)

log = logging.getLogger("fraud_detection_tpu_torch.lifeboat")

MAGIC = b"LBS1"
VERSION = 1

SNAPSHOT_RE = re.compile(r"^lifeboat-(\d{12})\.snap$")

#: sanity bound on the declared header length: a torn length field must
#: not make the reader allocate gigabytes
_MAX_HEADER = 1 << 20


class TornSnapshot(Exception):
    """The file is truncated, CRC-corrupt or structurally invalid: recovery
    falls back a generation, never trusts partial bytes."""


def spec_hash(spec: LedgerSpec) -> str:
    """Stable 16-hex-character identity of the ledger geometry a snapshot
    was taken under, equal to the reference's for the same spec. A
    snapshot of another spec (resized table, new decay horizon, another
    clock origin) is refused: replaying it through mismatched geometry
    would scramble every entity's aggregates. The two float fields are
    formatted as Python floats: under numpy 2 an ``np.float64``'s repr is
    ``np.float64(3600.0)``, not ``3600.0``."""
    null = np.asarray(spec.null_features, np.float32).tobytes()
    key = (
        f"{spec.n_base}|{spec.slots}|{float(spec.halflife_s)!r}|{spec.amount_col}"
        f"|{float(spec.ts_origin)!r}|".encode() + null
    )
    return hashlib.sha256(key).hexdigest()[:16]


def snapshot_path(directory: str, seq: int) -> str:
    return os.path.join(directory, f"lifeboat-{seq:012d}.snap")


@dataclass
class Snapshot:
    """A loaded, CRC-valid snapshot (host arrays)."""

    seq: int
    slot_version: int | None
    spec_hash: str
    created_at: float
    rows_seen: int
    spec: LedgerSpec
    ledger: LedgerState
    window: DriftWindow | None
    shard_window: DriftWindow | None
    path: str


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.cpu().numpy()
    return np.asarray(leaf, np.float32)


def _pack_payload(
    spec: LedgerSpec,
    ledger: LedgerState,
    window,
    shard_window,
) -> bytes:
    table = host_state(ledger)
    arrays: dict[str, np.ndarray] = {
        "spec_n_base": np.int64(spec.n_base),
        "spec_slots": np.int64(spec.slots),
        "spec_halflife_s": np.float64(spec.halflife_s),
        "spec_amount_col": np.int64(spec.amount_col),
        "spec_ts_origin": np.float64(spec.ts_origin),
        "spec_null_features": np.asarray(spec.null_features, np.float32),
        "acc": table.acc,
        "last_ts": table.last_ts,
        "fingerprint": table.fingerprint,
        "collisions": table.collisions,
        "evictions": table.evictions,
    }
    for prefix, win in (("win_", window), ("sw_", shard_window)):
        if win is not None:
            for name, leaf in zip(WINDOW_FIELDS, _window_leaves(win)):
                arrays[f"{prefix}{name}"] = _host(leaf)
    return savez_bytes(**arrays)


def _unpack_window(z, prefix: str) -> DriftWindow | None:
    if f"{prefix}{WINDOW_FIELDS[0]}" not in z:
        return None
    return DriftWindow(*(np.asarray(z[f"{prefix}{name}"]) for name in WINDOW_FIELDS))


def write_snapshot(
    directory: str,
    seq: int,
    spec: LedgerSpec,
    ledger: LedgerState,
    window=None,
    shard_window=None,
    slot_version: int | None = None,
    rows_seen: int = 0,
    created_at: float | None = None,
) -> str:
    """Serialize and atomically land one generation; returns its path.
    ``ledger`` and the windows may hold device tensors or host arrays."""
    payload = _pack_payload(spec, ledger, window, shard_window)
    header = json.dumps(
        {
            "seq": int(seq),
            "slot_version": slot_version,
            "spec_hash": spec_hash(spec),
            "created_at": float(created_at if created_at is not None else time.time()),
            "rows_seen": int(rows_seen),
            "payload_len": len(payload),
        },
        sort_keys=True,
    ).encode()
    blob = b"".join(
        (
            MAGIC,
            struct.pack("<H", VERSION),
            struct.pack("<I", len(header)),
            header,
            struct.pack("<I", zlib.crc32(header)),
            payload,
            struct.pack("<I", zlib.crc32(payload)),
        )
    )
    os.makedirs(directory, exist_ok=True)
    return atomic_write_bytes(snapshot_path(directory, seq), blob)


def load_snapshot(path: str) -> Snapshot:
    """Parse and CRC-check one snapshot file. Raises :class:`TornSnapshot`
    on any truncation or corruption: a partial table never binds."""
    try:
        with open(path, "rb") as f:
            blob = f.read()
    except OSError as e:
        raise TornSnapshot(f"unreadable snapshot {path}: {e}") from e
    if len(blob) < len(MAGIC) + 2 + 4:
        raise TornSnapshot(f"{path}: truncated before the header ({len(blob)} bytes)")
    if blob[:4] != MAGIC:
        raise TornSnapshot(f"{path}: bad magic {blob[:4]!r}")
    (version,) = struct.unpack_from("<H", blob, 4)
    if version != VERSION:
        raise TornSnapshot(f"{path}: unsupported snapshot version {version}")
    (header_len,) = struct.unpack_from("<I", blob, 6)
    if header_len > _MAX_HEADER:
        raise TornSnapshot(f"{path}: implausible header length {header_len}")
    off = 10
    if len(blob) < off + header_len + 4:
        raise TornSnapshot(f"{path}: truncated inside the header")
    header_bytes = blob[off : off + header_len]
    off += header_len
    (header_crc,) = struct.unpack_from("<I", blob, off)
    off += 4
    if zlib.crc32(header_bytes) != header_crc:
        raise TornSnapshot(f"{path}: header CRC mismatch")
    try:
        header = json.loads(header_bytes)
        payload_len = int(header["payload_len"])
    except (ValueError, KeyError, TypeError) as e:
        raise TornSnapshot(f"{path}: unparseable header: {e}") from e
    if len(blob) < off + payload_len + 4:
        raise TornSnapshot(f"{path}: truncated inside the payload")
    payload = blob[off : off + payload_len]
    off += payload_len
    (payload_crc,) = struct.unpack_from("<I", blob, off)
    if zlib.crc32(payload) != payload_crc:
        raise TornSnapshot(f"{path}: payload CRC mismatch")
    try:
        with np.load(io.BytesIO(payload), allow_pickle=False) as z:
            spec = LedgerSpec(
                n_base=int(z["spec_n_base"]),
                slots=int(z["spec_slots"]),
                halflife_s=float(z["spec_halflife_s"]),
                amount_col=int(z["spec_amount_col"]),
                ts_origin=float(z["spec_ts_origin"]),
                null_features=np.asarray(z["spec_null_features"], np.float32),
            )
            ledger = LedgerState(
                acc=np.asarray(z["acc"], np.float32),
                last_ts=np.asarray(z["last_ts"], np.float32),
                fingerprint=np.asarray(z["fingerprint"], np.uint32),
                collisions=np.asarray(z["collisions"], np.float32),
                evictions=np.asarray(z["evictions"], np.float32),
            )
            window = _unpack_window(z, "win_")
            shard_window = _unpack_window(z, "sw_")
    except (ValueError, KeyError, OSError) as e:
        # the CRC passed but the archive is malformed: torn all the same —
        # the loader makes a trust decision, not forensics
        raise TornSnapshot(f"{path}: corrupt payload archive: {e}") from e
    return Snapshot(
        seq=int(header["seq"]),
        slot_version=header.get("slot_version"),
        spec_hash=str(header["spec_hash"]),
        created_at=float(header.get("created_at", 0.0)),
        rows_seen=int(header.get("rows_seen", 0)),
        spec=spec,
        ledger=ledger,
        window=window,
        shard_window=shard_window,
        path=path,
    )


def list_snapshots(directory: str) -> list[tuple[int, str]]:
    """(seq, path) pairs, oldest → newest."""
    out: list[tuple[int, str]] = []
    try:
        names = os.listdir(directory)
    except OSError:
        return out
    for name in names:
        m = SNAPSHOT_RE.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(directory, name)))
    out.sort()
    return out


def load_latest(directory: str) -> tuple[Snapshot | None, int]:
    """The newest CRC-valid snapshot, falling back a generation per torn
    file. Returns ``(snapshot_or_None, generations_skipped)``."""
    skipped = 0
    for seq, path in reversed(list_snapshots(directory)):
        try:
            return load_snapshot(path), skipped
        except TornSnapshot as e:
            skipped += 1
            log.error(
                "lifeboat: snapshot generation %d is torn (%s) — falling "
                "back a generation", seq, e,
            )
    return None, skipped


def prune_snapshots(directory: str, keep: int) -> list[int]:
    """Drop all but the newest ``keep`` generations; returns the pruned
    seqs."""
    snaps = list_snapshots(directory)
    pruned: list[int] = []
    for seq, path in snaps[: max(0, len(snaps) - max(keep, 1))]:
        try:
            os.unlink(path)
            pruned.append(seq)
        except OSError:  # already gone
            pass
    return pruned
