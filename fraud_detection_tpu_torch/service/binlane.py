"""The binary ingest lane: length-prefixed columnar frames, parsed straight
into pooled staging.

The port's own copy of the JAX package's ``service/binlane.py``, with its
wire contract byte for byte, so either package's client talks to either
package's server:

- **Persistent connections, length-prefixed frames.** A 4-byte big-endian
  length prefix; a per-receive stall timeout tells an idle peer at a frame
  boundary (the timeout re-arms) from one stalled inside a frame
  (:class:`StalledPeerError`: the connection is dropped, never a wedged
  handler thread).
- **The parse is the receive.** An f32 frame's feature block is received
  with ``recv_into`` straight into a pooled
  :class:`~fraud_detection_tpu_torch.ops.scorer.StagingPool` slot — on a
  card a numpy view of a page-locked tensor, the buffer the flush's h2d
  copy reads: no per-row Python object, no ``np.stack``, no allocation in
  steady state (the pool's ``allocations`` stays constant).
- **One queue item a frame.** A frame admits as one
  :class:`~fraud_detection_tpu_torch.service.microbatch.IngestBlock` with
  one future; the micro-batcher counts its rows, and the flush copies the
  frame's scores (and reason codes) back into the slot it was parsed into.
  At ``SCORER_ADMIT_MAX_ROWS`` the lane answers a BUSY frame carrying the
  retry hint (the binary twin of HTTP 429 + ``Retry-After``).

Request frame, after the length prefix (network byte order header)::

    magic   u16 = 0x4642 ("FB")
    version u8  = 1
    layout  u8  : 1 = f32 features, 2 = int8 features (quantized by the
                  dequant scale the server publishes at connect)
    d       u16 : feature count (must match the served schema)
    flags   u8  : bit0 = entity fingerprints ride, bit1 = event timestamps,
                  bit2 = a 64-byte traceparent field
    pad     u8
    n_rows  u32
    -- columns, little-endian, in order --
    features  f32[n][d]  (or int8[n][d] for layout 2)
    entities  u32[n]     (iff flags bit0)
    ts        f64[n]     (iff flags bit1)
    trace     64 bytes   (iff flags bit2: W3C traceparent, NUL-padded)

Response frame (also sent once as a HELLO on connect, with ``n = d`` and
the int8 dequant scale as payload when the int8 layout is served)::

    magic u16, version u8, status u8, explain_k u8, pad u8, n u32
    status 0 payload: scores f32[n]
                      [+ reason idx u8[n][k] + reason values f32[n][k]]
    status >0 payload: retry_after_ms u32 + utf-8 message
    status codes: 1 bad frame, 2 busy (admission shed), 3 unavailable
                  (lifeboat recovering, or no healthy shard), 4 internal

The lane feeds a micro-batcher or, under ``MESH_SHARDS``, the shard front
(``mesh/front``): a frame lands whole on one shard, and a front with no
healthy shard answers status 3 with ``MESH_SHARD_REOPEN_S`` as its retry.

The same payload (no length prefix) posts to ``POST /ingest/batch`` as
``application/x-fraud-frame``. For a ledger-widened model the entity and
timestamp columns become the ledger's per-row columns with the JSON
edge's hash and clock (:meth:`_FrameDecoder.entity_cols`), so a frame feeds
the ledger flush; for a wide model the fingerprints key the wide flush's
crosses; a stateless family receives and length-checks them and derives
nothing, as in the JAX package. A valid trace field links the frame's
``ingest.frame`` span (with the six stages as child spans, emitted after
the response is written) to the client's trace; a malformed one is dropped,
never the frame. Every frame's outcome feeds the ``binary`` lane's SLO
(``telemetry/slo``): a shed or a failure burns availability, a scored
frame counts good with its latency.
"""

from __future__ import annotations

import asyncio
import logging
import re
import socket
import struct
import sys
import threading
import time

import numpy as np

from fraud_detection_tpu_torch import config
from fraud_detection_tpu_torch.ledger.state import _MULT
from fraud_detection_tpu_torch.mesh.front import NoHealthyShards
from fraud_detection_tpu_torch.ops.scorer import _bucket
from fraud_detection_tpu_torch.service import metrics, tracing
from fraud_detection_tpu_torch.service.errors import ProtocolError
from fraud_detection_tpu_torch.service.microbatch import AdmissionFull, IngestBlock
from fraud_detection_tpu_torch.service.wire import _HDR, StalledPeerError
from fraud_detection_tpu_torch.telemetry import slo
from fraud_detection_tpu_torch.telemetry.timeline import RequestTimeline
from fraud_detection_tpu_torch.utils import lockdep

log = logging.getLogger("fraud_detection_tpu_torch.binlane")

MAGIC = 0x4642  # "FB"
VERSION = 1

LAYOUT_F32 = 1
LAYOUT_INT8 = 2

FLAG_ENTITY = 0x01
FLAG_TS = 0x02
FLAG_TRACE = 0x04
TRACE_LEN = 64

_FRAME = struct.Struct(">HBBHBxI")  # magic, version, layout, d, flags, n
_RESP = struct.Struct(">HBBBxI")    # magic, version, status, explain_k, n
_ERRPAY = struct.Struct(">I")       # retry_after_ms

ST_OK = 0
ST_BAD_FRAME = 1
ST_BUSY = 2
ST_UNAVAILABLE = 3
ST_ERROR = 4

_LE = sys.byteorder == "little"

_TRACEPARENT_RE = re.compile(
    r"^[0-9a-f]{2}-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$"
)


class FrameError(Exception):
    """A malformed request frame, answered with a status-1 error frame.
    ``fatal`` frames (the stream position can't be trusted) also close the
    connection."""

    def __init__(self, message: str, kind: str, fatal: bool = False):
        self.kind = kind
        self.fatal = fatal
        super().__init__(message)


class LaneBusy(Exception):
    """Client-side surface of a BUSY/UNAVAILABLE response frame."""

    def __init__(self, message: str, status: int, retry_after_s: float):
        self.status = status
        self.retry_after_s = retry_after_s
        super().__init__(message)


def batcher_max_batch(batcher) -> int:
    """The flush ceiling of a micro-batcher, or of a shard front's shards
    (they share it): the hard bound on rows a block."""
    shards = getattr(batcher, "shards", None)
    return int((shards[0].batcher if shards else batcher).max_batch)


def ingest_dequant_scale(model) -> np.ndarray | None:
    """The per-feature f32 scale int8-layout frames are quantized with: the
    scorer's int8-wire calibration when that wire is served (the lanes
    then share one lattice), else one derived from the model's scaler,
    else None (the int8 layout is refused). Published in the HELLO."""
    scorer = getattr(model, "scorer", model)
    scale = getattr(scorer, "_quant_scale", None)
    if scale is not None:
        return np.asarray(scale, np.float32)
    scaler = getattr(model, "scaler", None)
    if scaler is not None:
        from fraud_detection_tpu_torch.ops.quant import derive_calibration

        return np.asarray(derive_calibration(scaler).scale, np.float32)
    return None


def _scales_equal(a: np.ndarray | None, b: np.ndarray | None) -> bool:
    if a is None or b is None:
        return a is b
    return a.shape == b.shape and bool(np.array_equal(a, b))


# ---------------------------------------------------------------------------
# Frame encode/decode (the socket lane, /ingest/batch, and tests)
# ---------------------------------------------------------------------------


def encode_frame(
    rows: np.ndarray,
    entity_fps: np.ndarray | None = None,
    timestamps: np.ndarray | None = None,
    scale: np.ndarray | None = None,
    layout: int = LAYOUT_F32,
    length_prefix: bool = True,
    traceparent: str | None = None,
) -> bytes:
    """Client-side frame encoder. ``scale`` is required for
    :data:`LAYOUT_INT8` (the server's published dequant scale)."""
    rows = np.ascontiguousarray(rows, np.float32)
    if rows.ndim != 2:
        raise ValueError("rows must be 2-D")
    n, d = rows.shape
    flags = 0
    cols = []
    if layout == LAYOUT_INT8:
        if scale is None:
            raise ValueError("int8 layout needs the server's dequant scale")
        q = np.clip(np.rint(rows / np.asarray(scale, np.float32)), -127, 127)
        cols.append(q.astype(np.int8).tobytes())
    elif layout == LAYOUT_F32:
        cols.append(rows.astype("<f4", copy=False).tobytes())
    else:
        raise ValueError(f"unknown layout {layout}")
    if entity_fps is not None:
        flags |= FLAG_ENTITY
        cols.append(
            np.ascontiguousarray(entity_fps, np.uint32).astype("<u4", copy=False).tobytes()
        )
    if timestamps is not None:
        flags |= FLAG_TS
        cols.append(
            np.ascontiguousarray(timestamps, np.float64).astype("<f8", copy=False).tobytes()
        )
    if traceparent is not None:
        tp = traceparent.encode("ascii")
        if len(tp) > TRACE_LEN:
            raise ValueError("traceparent longer than the 64-byte field")
        flags |= FLAG_TRACE
        cols.append(tp.ljust(TRACE_LEN, b"\0"))
    payload = _FRAME.pack(MAGIC, VERSION, layout, d, flags, n) + b"".join(cols)
    if length_prefix:
        return _HDR.pack(len(payload)) + payload
    return payload


def _payload_sizes(layout: int, flags: int, d: int, n: int) -> tuple[int, int, int, int]:
    feat = n * d * (1 if layout == LAYOUT_INT8 else 4)
    ent = n * 4 if flags & FLAG_ENTITY else 0
    ts = n * 8 if flags & FLAG_TS else 0
    tp = TRACE_LEN if flags & FLAG_TRACE else 0
    return feat, ent, ts, tp


def _parse_trace_field(buf) -> str | None:
    """The frame's 64-byte traceparent field → a valid W3C header string,
    or None (a malformed context is dropped, never the frame)."""
    raw = bytes(buf).split(b"\0", 1)[0]
    try:
        tp = raw.decode("ascii").strip()
    except UnicodeDecodeError:
        return None
    m = _TRACEPARENT_RE.match(tp.lower())
    if not m or int(m.group(1), 16) == 0 or int(m.group(2), 16) == 0:
        return None
    return tp


def _check_header(
    layout: int, flags: int, d: int, n: int, version: int, magic: int,
    expect_d: int, max_rows: int, dequant: np.ndarray | None,
) -> None:
    if magic != MAGIC:
        raise FrameError(f"bad magic 0x{magic:04x}", "magic", fatal=True)
    if version != VERSION:
        raise FrameError(f"unsupported version {version}", "version", fatal=True)
    if layout not in (LAYOUT_F32, LAYOUT_INT8):
        raise FrameError(f"unknown layout {layout}", "layout")
    if layout == LAYOUT_INT8 and dequant is None:
        raise FrameError("int8 layout not served (no quantization calibration)",
                         "layout")
    if flags & ~(FLAG_ENTITY | FLAG_TS | FLAG_TRACE):
        raise FrameError(f"unknown flags 0x{flags:02x}", "flags")
    if d != expect_d:
        raise FrameError(f"frame is {d}-wide, served schema wants {expect_d}", "width")
    if not 1 <= n <= max_rows:
        raise FrameError(
            f"frame of {n} rows outside [1, {max_rows}] (INGEST_MAX_ROWS)", "rows"
        )


class _FrameDecoder:
    """Per-connection (or per-request) decode state: the reusable scratch
    buffers that keep steady-state ingest allocation-free. Not
    thread-safe — each connection handler owns one."""

    def __init__(self, scorer, max_rows: int, dequant: np.ndarray | None):
        self.scorer = scorer
        self.max_rows = max_rows
        self.dequant = dequant
        self.d = int(scorer.staging_features)
        self.spec = getattr(scorer, "ledger_spec", None)
        # the wide family keys its crosses on the fingerprint alone: the
        # entity column still rides, or every lane row would score base-only
        self.wide = getattr(scorer, "wide_spec", None)
        # reusable scratch (sized at first use): int8 codes, a byte-order
        # staging block for big-endian hosts, the entity and ts columns,
        # the derived ledger columns, the u8 reason indices, the trace field
        self._i8: np.ndarray | None = None
        self._fb: np.ndarray | None = None
        self._ent_raw: np.ndarray | None = None
        self._ts_raw: np.ndarray | None = None
        self._ls: np.ndarray | None = None
        self._lf: np.ndarray | None = None
        self._lt: np.ndarray | None = None
        self._ei8: np.ndarray | None = None
        self._tp = bytearray(TRACE_LEN)

    def _ensure(self, n: int) -> None:
        if self._ent_raw is None or self._ent_raw.shape[0] < n:
            cap = max(n, self.max_rows)
            self._i8 = np.zeros((cap, self.d), np.int8)
            self._fb = np.zeros((cap, self.d), np.float32)
            self._ent_raw = np.zeros(cap, np.uint32)
            self._ts_raw = np.zeros(cap, np.float64)
            self._ls = np.zeros(cap, np.int64)
            self._lf = np.zeros(cap, np.int64)
            self._lt = np.zeros(cap, np.float32)

    def features_into(self, slot, n: int, layout: int, buf) -> None:
        """Decode the feature column (a little-endian byte buffer) into the
        slot's f32 rows: the int8 codes times the dequant scale, or the f32
        rows. (The socket lane receives f32 rows into the slot directly.)"""
        # lockcheck: hot-path — decode writes into preallocated staging
        if layout == LAYOUT_INT8:
            codes = np.frombuffer(buf, np.int8, n * self.d).reshape(n, self.d)
            np.multiply(codes, self.dequant, out=slot.f32[:n])
        else:
            rows = np.frombuffer(buf, "<f4", n * self.d).reshape(n, self.d)
            np.copyto(slot.f32[:n], rows, casting="unsafe")

    def entity_cols(self, n: int, ent_buf, ts_buf):
        """The ledger's ``(slots, fingerprints, timestamps)`` columns from a
        frame's entity column (u32 fingerprints, little-endian) and
        optional timestamp column (f64 epochs), by the JSON edge's hash and
        clock: the slot by multiply-shift (the product's low 32 bits, then
        the top ``log2_slots``), the time origin-relative in float64, at
        least 1e-3, then float32; without timestamps, now. None for a
        stateless family or a frame without entities. For the wide family
        only the fingerprints: the slot and time columns are zero. Views of
        reusable scratch: valid until this decoder's next frame."""
        if ent_buf is None or (self.spec is None and self.wide is None):
            return None
        self._ensure(n)
        ls, lf, lt = self._ls[:n], self._lf[:n], self._lt[:n]
        np.copyto(lf, np.frombuffer(ent_buf, "<u4", n))
        if self.spec is None:
            ls[:] = 0
            lt[:] = 0.0
            return ls, lf, lt
        # < 2^64 as an unsigned product; int64 wraps it, and the mask keeps
        # the low 32 bits either way
        np.multiply(lf, _MULT, out=ls)
        np.bitwise_and(ls, 0xFFFFFFFF, out=ls)
        np.right_shift(ls, 32 - self.spec.log2_slots, out=ls)
        if ts_buf is not None:
            rel = self._ts_raw[:n]
            np.subtract(np.frombuffer(ts_buf, "<f8", n), self.spec.ts_origin, out=rel)
            np.maximum(rel, 1e-3, out=rel)
            np.copyto(lt, rel, casting="unsafe")
        else:
            lt[:] = self.spec.rel_ts(time.time())
        return ls, lf, lt

    def check_finite(self, slot, n: int) -> None:
        """The edge poison guard: a NaN/Inf feature is a client input error
        answered at the frame, as ``/predict`` answers 422."""
        if not np.isfinite(slot.f32[:n]).all():
            raise FrameError("non-finite feature values", "poison")

    def decode_payload(self, slot, layout: int, flags: int, n: int, payload):
        """Decode one frame payload (length-checked here) into ``slot``.
        Returns ``(entity_cols, traceparent)``; the entity columns
        (:meth:`entity_cols`) are None for a stateless family."""
        feat, ent, ts, tp = _payload_sizes(layout, flags, self.d, n)
        if len(payload) != feat + ent + ts + tp:
            raise FrameError(
                f"payload is {len(payload)} bytes, layout wants "
                f"{feat + ent + ts + tp}", "size",
            )
        mv = memoryview(payload)
        self.features_into(slot, n, layout, mv[:feat])
        trace = _parse_trace_field(mv[feat + ent + ts:]) if tp else None
        self.check_finite(slot, n)
        entity = self.entity_cols(
            n, mv[feat:feat + ent] if ent else None,
            mv[feat + ent:feat + ent + ts] if ts else None,
        )
        return entity, trace

    def reasons_u8(self, slot, n: int, k: int) -> np.ndarray:
        """The slot's int32 reason indices narrowed to the wire's u8 (the
        schema's d ≤ 255) through a reusable buffer."""
        if self._ei8 is None or self._ei8.shape[0] < n or self._ei8.shape[1] != k:
            self._ei8 = np.zeros((max(n, self.max_rows), k), np.uint8)
        np.copyto(self._ei8[:n], slot.ei[:n, :k], casting="unsafe")
        return self._ei8[:n]


def decode_frame_body(scorer, body, max_rows: int, dequant=None):
    """Decode one ``/ingest/batch`` frame body (the socket frame's payload,
    no length prefix) into a freshly acquired staging slot. Returns
    ``(slot, n, entity_cols, traceparent)``; the CALLER releases the slot
    to ``scorer.staging`` after encoding its response. Raises
    :class:`FrameError` on a malformed body (→ 422)."""
    if len(body) < _FRAME.size:
        raise FrameError(
            f"body of {len(body)} bytes is shorter than a frame header", "size"
        )
    magic, version, layout, d, flags, n = _FRAME.unpack(bytes(body[:_FRAME.size]))
    dec = _FrameDecoder(scorer, max(1, min(n, max_rows)), dequant)
    _check_header(layout, flags, d, n, version, magic, dec.d, max_rows, dequant)
    slot = scorer.staging.acquire(_bucket(n, scorer.min_bucket))
    try:
        entity, trace = dec.decode_payload(
            slot, layout, flags, n, memoryview(body)[_FRAME.size:]
        )
    except Exception:
        scorer.staging.release(slot)
        raise
    return slot, n, entity, trace


def block_from_arrays(scorer, rows: np.ndarray, entity_fps=None, timestamps=None,
                      max_rows: int | None = None):
    """An admitted block straight from parsed arrays (the msgpack lane):
    validate, copy once into a freshly acquired staging slot, derive the
    ledger columns. Returns ``(slot, n, entity_cols)``; the caller
    releases the slot. Raises
    :class:`FrameError` on client input errors (→ 422)."""
    rows = np.ascontiguousarray(rows, np.float32)
    if rows.ndim != 2 or rows.shape[1] != scorer.staging_features:
        raise FrameError(
            f"rows must be (n, {scorer.staging_features}); got {rows.shape}", "width"
        )
    n = rows.shape[0]
    bound = max_rows or n
    if not 1 <= n <= bound:
        raise FrameError(f"batch of {n} rows outside [1, {bound}]", "rows")
    if not np.isfinite(rows).all():
        raise FrameError("non-finite feature values", "poison")
    for name, col in (("entity_fps", entity_fps), ("timestamps", timestamps)):
        if col is not None and np.shape(col) != (n,):
            raise FrameError(f"{name} must align with rows", "flags")
    entity = None
    if entity_fps is not None:
        ts_buf = (
            None if timestamps is None
            else np.ascontiguousarray(timestamps, "<f8").tobytes()
        )
        entity = _FrameDecoder(scorer, n, None).entity_cols(
            n, np.ascontiguousarray(entity_fps, "<u4").tobytes(), ts_buf
        )
    slot = scorer.staging.acquire(_bucket(n, scorer.min_bucket))
    np.copyto(slot.f32[:n], rows, casting="unsafe")
    return slot, n, entity


def encode_response_body(slot, n: int, ek: int) -> bytes:
    """``/ingest/batch``'s response body: the socket response frame's
    payload."""
    parts = [
        _RESP.pack(MAGIC, VERSION, ST_OK, ek, n),
        slot.scores[:n].astype("<f4", copy=False).tobytes(),
    ]
    if ek:
        parts.append(slot.ei[:n, :ek].astype(np.uint8).tobytes())
        parts.append(slot.ev[:n, :ek].astype("<f4", copy=False).tobytes())
    return b"".join(parts)


def _parse_response_payload(status: int, ek: int, n: int, payload):
    """Shared response decode: raises :class:`LaneBusy` or
    :class:`FrameError` on an error status, else returns ``(scores f32[n],
    reasons | None)``."""
    if status in (ST_BUSY, ST_UNAVAILABLE):
        (retry_ms,) = _ERRPAY.unpack(payload[:4])
        raise LaneBusy(payload[4:].decode(errors="replace"), status, retry_ms / 1000.0)
    if status != ST_OK:
        raise FrameError(payload[4:].decode(errors="replace"), f"status{status}")
    scores = np.frombuffer(payload, "<f4", n).copy()
    reasons = None
    if ek:
        off = n * 4
        idx = np.frombuffer(payload, np.uint8, n * ek, off).reshape(n, ek)
        off += n * ek
        vals = np.frombuffer(payload, "<f4", n * ek, off).reshape(n, ek)
        reasons = (idx.copy(), vals.copy())
    return scores, reasons


def decode_response_body(body: bytes):
    """An ``/ingest/batch`` response body → ``(scores, reasons | None)``;
    raises :class:`LaneBusy`/:class:`FrameError` on error statuses."""
    magic, version, status, ek, n = _RESP.unpack(body[:_RESP.size])
    if magic != MAGIC or version != VERSION:
        raise ProtocolError("bad response body")
    return _parse_response_payload(status, ek, n, body[_RESP.size:])


def error_frame(status: int, message: str, retry_after_s: float = 0.0) -> bytes:
    body = _ERRPAY.pack(int(retry_after_s * 1000)) + message.encode()
    payload = _RESP.pack(MAGIC, VERSION, status, 0, 0) + body
    return _HDR.pack(len(payload)) + payload


# ---------------------------------------------------------------------------
# The socket server
# ---------------------------------------------------------------------------


def _recv_into_exact(sock: socket.socket, mv: memoryview) -> bool:
    """Fill ``mv`` from the socket; False on a clean EOF before any byte.
    A timeout before the first byte propagates (idle: the caller decides);
    after it the stream is inside the buffer (:class:`StalledPeerError`)."""
    got, n = 0, len(mv)
    while got < n:
        try:
            k = sock.recv_into(mv[got:], n - got)
        except TimeoutError:
            if not got:
                raise
            raise StalledPeerError(f"peer stalled mid-frame ({got}/{n} bytes)") from None
        if not k:
            if not got:
                return False
            raise ProtocolError("connection closed mid-frame")
        got += k
    return True


class BinaryIngestServer:
    """The persistent-connection binary lane: a thread a connection (sync
    sockets: ``recv_into`` straight into the staging slot), each frame
    hopping onto the serving event loop once via
    ``run_coroutine_threadsafe``. It serves ``scorer_fn()``, the scorer live
    at each frame (serving passes the ``ModelSlot``'s), whose int8 lattice
    (from the live model's scaler, ``model_fn()``, or the fixed ``model``'s,
    when the scorer is not on the int8 wire) each connection's HELLO
    publishes. A hot swap rebinds a connection's frame decoder at its next
    frame; when the swap changed the int8 lattice the HELLO published, that
    frame is answered UNAVAILABLE and the connection closed, so the client
    reconnects and learns the new scale instead of quantizing against a
    dead one."""

    def __init__(
        self,
        batcher,
        scorer_fn,
        model=None,
        host: str | None = None,
        port: int | None = None,
        max_rows: int | None = None,
        max_frame: int | None = None,
        stall_timeout: float | None = None,
        model_fn=None,
        unavailable_fn=None,
    ):
        self.batcher = batcher
        self.scorer_fn = scorer_fn
        self.model_fn = model_fn
        self.model = model
        # ``unavailable_fn() -> (message, retry_after_s) | None``: the
        # process-level not-ready gate (the lifeboat's ``recovering`` state).
        # The HTTP edges answer 503 then; this lane refuses the same window,
        # since rows folded into a table about to be replaced by the journal
        # replay would be lost
        self.unavailable_fn = unavailable_fn
        self.host = host if host is not None else config.ingest_host()
        self.port = port if port is not None else config.ingest_port()
        # clamped to the batcher's flush ceiling: a frame the header check
        # admits must never die on score_block's max_batch bound
        self.max_rows = min(
            max_rows or config.ingest_max_rows() or config.scorer_max_batch(),
            batcher_max_batch(batcher),
        )
        self.max_frame = max_frame or config.ingest_max_frame()
        self.stall_timeout = (
            stall_timeout if stall_timeout is not None
            else config.ingest_stall_timeout_s()
        )
        self._loop: asyncio.AbstractEventLoop | None = None
        self._sock: socket.socket | None = None
        self._accept_thread: threading.Thread | None = None
        self._conns: set[socket.socket] = set()
        self._threads: set[threading.Thread] = set()
        self._lock = lockdep.lock("binlane.server")
        self._stopping = False
        self._c_req = metrics.ingest_requests.labels("binary")
        self._c_rows = metrics.ingest_rows.labels("binary")
        self._c_shed = metrics.ingest_shed.labels("binary")
        self._obs_parse = metrics.request_stage_duration.labels("parse").observe

    def _dequant_for(self, scorer) -> np.ndarray | None:
        """The int8 lattice for ``scorer``: from the live model when
        ``model_fn`` follows hot swaps, else from the construction-time
        model, else from the scorer."""
        if self.model_fn is not None:
            return ingest_dequant_scale(self.model_fn())
        return ingest_dequant_scale(self.model if self.model is not None else scorer)

    # -- lifecycle -----------------------------------------------------------

    def start(self, loop: asyncio.AbstractEventLoop) -> None:
        """Bind and accept. ``loop`` runs the batcher: admissions are
        scheduled onto it."""
        self._loop = loop
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind((self.host, self.port))
        sock.listen(128)
        sock.settimeout(0.5)  # poll the stop flag
        self._sock = sock
        self.port = sock.getsockname()[1]  # resolve port 0
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="binlane-accept", daemon=True
        )
        self._accept_thread.start()
        log.info("binary ingest lane listening on %s:%d (max %d rows/frame)",
                 self.host, self.port, self.max_rows)

    def stop(self) -> None:
        """Close the listener and every connection, and join every thread."""
        self._stopping = True
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                log.debug("listen socket close failed", exc_info=True)
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5.0)
        with self._lock:
            conns = list(self._conns)
            threads = list(self._threads)
        for c in conns:  # unblock the handlers' recv()
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                log.debug("conn shutdown failed", exc_info=True)
        for t in threads:
            t.join(timeout=5.0)

    # -- accept/handler ------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stopping:
            try:
                conn, addr = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break  # listener closed
            # the stall timeout from accept on: a peer dead without a RST
            # cannot hold a handler thread forever
            conn.settimeout(self.stall_timeout)
            try:
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                log.debug("TCP_NODELAY failed", exc_info=True)
            t = threading.Thread(target=self._handle, args=(conn, addr),
                                 name=f"binlane-{addr[0]}:{addr[1]}", daemon=True)
            with self._lock:
                if self._stopping:
                    conn.close()
                    break
                self._conns.add(conn)
                self._threads.add(t)
            t.start()

    def _handle(self, conn: socket.socket, addr) -> None:
        scorer = self.scorer_fn()
        dec = _FrameDecoder(scorer, self.max_rows, self._dequant_for(scorer))
        hdr_buf = bytearray(_HDR.size)
        fhdr_buf = bytearray(_FRAME.size)
        resp_buf = bytearray(256)
        try:
            self._send_hello(conn, dec)
            while not self._stopping:
                try:
                    if not _recv_into_exact(conn, memoryview(hdr_buf)):
                        return  # clean EOF between frames
                except TimeoutError:
                    continue  # idle at the frame boundary: re-arm
                (length,) = _HDR.unpack(hdr_buf)
                if length > self.max_frame or length < _FRAME.size:
                    metrics.ingest_frame_errors.labels("size").inc()
                    conn.sendall(error_frame(
                        ST_BAD_FRAME,
                        f"frame of {length} bytes outside [{_FRAME.size}, "
                        f"{self.max_frame}]",
                    ))
                    return  # the stream position can't be trusted
                unavailable = self.unavailable_fn() if self.unavailable_fn else None
                if unavailable is not None:
                    # not ready (the lifeboat recovering): drain the frame so
                    # the stream stays at a boundary, answer UNAVAILABLE with
                    # the retry time, keep the connection
                    msg, retry_after = unavailable
                    self._drain(conn, length)
                    conn.sendall(error_frame(ST_UNAVAILABLE, msg, retry_after))
                    continue
                scorer = self.scorer_fn()
                if scorer is not dec.scorer:  # a hot swap: rebind the decoder
                    scale = self._dequant_for(scorer)
                    if not _scales_equal(scale, dec.dequant):
                        # the promoted model carries another int8 lattice
                        # than the one this connection's HELLO published
                        metrics.ingest_frame_errors.labels("recal").inc()
                        conn.sendall(error_frame(
                            ST_UNAVAILABLE,
                            "quantization calibration changed (hot swap) — "
                            "reconnect for the new scale", 0.0,
                        ))
                        return
                    dec = _FrameDecoder(scorer, self.max_rows, scale)
                if not self._frame(conn, dec, length, fhdr_buf, resp_buf):
                    return
        except (StalledPeerError, ProtocolError) as e:
            metrics.ingest_frame_errors.labels("stall").inc()
            log.warning("ingest peer %s dropped: %s", addr, e)
        except OSError as e:
            log.debug("ingest connection %s lost: %s", addr, e)
        finally:
            try:
                conn.close()
            except OSError:
                log.debug("conn close failed", exc_info=True)
            with self._lock:
                self._conns.discard(conn)
                self._threads.discard(threading.current_thread())

    def _send_hello(self, conn: socket.socket, dec: _FrameDecoder) -> None:
        """Connect-time spec frame: the served width (as ``n``) and, when
        the int8 layout is served, its dequant scale."""
        payload = _RESP.pack(MAGIC, VERSION, ST_OK, 0, dec.d)
        if dec.dequant is not None:
            payload += np.ascontiguousarray(dec.dequant, np.float32).astype(
                "<f4", copy=False).tobytes()
        conn.sendall(_HDR.pack(len(payload)) + payload)

    def _frame(self, conn: socket.socket, dec: _FrameDecoder, length: int,
               fhdr_buf: bytearray, resp_buf: bytearray) -> bool:
        """Read, validate, admit and answer ONE frame. Returns False when
        the connection must close (a fatal frame error)."""
        # lockcheck: hot-path — the steady-state parse reuses pooled buffers
        t_parse = time.perf_counter()
        if not _recv_into_exact(conn, memoryview(fhdr_buf)):
            raise ProtocolError("connection closed before frame header")
        magic, version, layout, d, flags, n = _FRAME.unpack(fhdr_buf)
        scorer = dec.scorer
        slot = None
        trace = None
        consumed = 0  # payload bytes read so far (drained on a rejection)
        try:
            _check_header(layout, flags, d, n, version, magic, dec.d,
                          self.max_rows, dec.dequant)
            feat, ent, ts, tp = _payload_sizes(layout, flags, d, n)
            if length != _FRAME.size + feat + ent + ts + tp:
                raise FrameError(
                    f"length {length} disagrees with layout "
                    f"({_FRAME.size + feat + ent + ts + tp})", "size",
                )
            slot = scorer.staging.acquire(_bucket(n, scorer.min_bucket))
            if layout == LAYOUT_F32 and _LE:
                # the parse is the receive: f32 rows land in the pooled slot
                # the flush stages from
                mv = memoryview(slot.f32).cast("B")[:feat]
            else:
                dec._ensure(n)
                scratch = dec._i8 if layout == LAYOUT_INT8 else dec._fb
                mv = memoryview(scratch).cast("B")[:feat]
            if not _recv_into_exact(conn, mv):
                raise ProtocolError("connection closed mid-frame")
            if not (layout == LAYOUT_F32 and _LE):
                dec.features_into(slot, n, layout, mv)
            consumed += feat
            if ent or ts:
                dec._ensure(n)
            cols = []
            for size, buf in ((ent, dec._ent_raw), (ts, dec._ts_raw)):
                cols.append(memoryview(buf).cast("B")[:size] if size else None)
                if size:
                    if not _recv_into_exact(conn, cols[-1]):
                        raise ProtocolError("connection closed mid-frame")
                    consumed += size
            if tp:
                if not _recv_into_exact(conn, memoryview(dec._tp)):
                    raise ProtocolError("connection closed mid-frame")
                consumed += tp
                trace = _parse_trace_field(dec._tp)
            dec.check_finite(slot, n)
            entity = dec.entity_cols(n, *cols)
        except FrameError as e:
            if slot is not None:
                scorer.staging.release(slot)
            metrics.ingest_frame_errors.labels(e.kind).inc()
            if not e.fatal:
                # drain the rejected frame's unread payload so the stream
                # stays at a frame boundary; a fatal error closes instead
                self._drain(conn, length - _FRAME.size - consumed)
            conn.sendall(error_frame(ST_BAD_FRAME, str(e)))
            return not e.fatal
        except TimeoutError:
            if slot is not None:
                scorer.staging.release(slot)
            raise StalledPeerError("peer stalled between frame header and body") from None
        except BaseException:
            if slot is not None:
                scorer.staging.release(slot)
            raise
        self._obs_parse(time.perf_counter() - t_parse)
        timeline = RequestTimeline() if self.batcher.telemetry else None
        try:
            self._c_req.inc()
            ek = self._admit(slot, n, entity, timeline)
        except AdmissionFull as e:
            scorer.staging.release(slot)
            self._c_shed.inc()
            slo.record_lane("binary", False)
            conn.sendall(error_frame(ST_BUSY, str(e), e.retry_after_s))
            return True
        except Exception as e:
            scorer.staging.release(slot)
            status, retry = ST_ERROR, 0.0
            if isinstance(e, NoHealthyShards):
                # every shard of the front down: a retryable outage
                status, retry = ST_UNAVAILABLE, float(config.mesh_shard_reopen_s())
            log.error("ingest frame failed: %s", e)
            slo.record_lane("binary", False)
            conn.sendall(error_frame(status, str(e), retry))
            return True
        try:
            self._c_rows.inc(n)
            self._respond(conn, dec, slot, n, ek, resp_buf)
        finally:
            scorer.staging.release(slot)
        slo.record_lane("binary", True, time.perf_counter() - t_parse)
        if trace is not None and tracing._tracer is not None:
            # the frame's server-side work as a span linked to the client's
            # trace, off the response path (the client has its scores)
            with tracing.span("ingest.frame", traceparent=trace, lane="binary", rows=n):
                if timeline is not None:
                    tracing.emit_stage_spans(timeline)
        return True

    _DRAIN_CHUNK = 1 << 16

    def _drain(self, conn: socket.socket, k: int) -> None:
        """Read and discard ``k`` unread payload bytes of a rejected frame
        (bounded by the already-validated length prefix)."""
        buf = bytearray(min(k, self._DRAIN_CHUNK)) if k > 0 else None
        while k > 0:
            mv = memoryview(buf)[: min(k, len(buf))]
            if not _recv_into_exact(conn, mv):
                raise ProtocolError("connection closed mid-frame")
            k -= len(mv)

    def _admit(self, slot, n: int, entity=None, timeline=None) -> int:
        """One loop hop a frame: schedule score_block on the serving loop
        and wait for the flush to resolve it."""
        fut = asyncio.run_coroutine_threadsafe(
            self.batcher.score_block(IngestBlock(slot, n, entity), timeline),
            self._loop,
        )
        return fut.result()

    def _respond(self, conn: socket.socket, dec: _FrameDecoder, slot, n: int,
                 ek: int, resp_buf: bytearray) -> None:
        """Encode scores (+ reason codes) out of the slot into the reusable
        response buffer — one sendall a frame."""
        # lockcheck: hot-path — response assembly reuses the response buffer
        body = n * 4 + (n * ek * 5 if ek else 0)
        total = _HDR.size + _RESP.size + body
        if len(resp_buf) < total:
            resp_buf.extend(b"\0" * (total - len(resp_buf)))
        _HDR.pack_into(resp_buf, 0, _RESP.size + body)
        _RESP.pack_into(resp_buf, _HDR.size, MAGIC, VERSION, ST_OK, ek, n)
        off = _HDR.size + _RESP.size
        mv = memoryview(resp_buf)
        scores = slot.scores[:n]
        if not _LE:
            scores = scores.astype("<f4")
        mv[off:off + n * 4] = memoryview(scores).cast("B")
        off += n * 4
        if ek:
            idx8 = dec.reasons_u8(slot, n, ek)
            mv[off:off + n * ek] = memoryview(np.ascontiguousarray(idx8)).cast("B")
            off += n * ek
            vals = np.ascontiguousarray(slot.ev[:n, :ek])
            if not _LE:
                vals = vals.astype("<f4")
            mv[off:off + n * ek * 4] = memoryview(vals).cast("B")
        conn.sendall(mv[:total])


# ---------------------------------------------------------------------------
# Client (tests, chip_smoke.py, and a reference for real clients)
# ---------------------------------------------------------------------------


class BinLaneClient:
    """Synchronous reference client: connect once, stream frames.
    ``score_batch`` raises :class:`LaneBusy` on a shed (status 2/3 — honor
    ``retry_after_s``) and :class:`FrameError` on a rejected frame."""

    def __init__(self, host: str, port: int, timeout: float = 30.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        status, _k, self.d, payload = self._read_response()
        if status != ST_OK:
            raise ProtocolError(f"bad hello (status {status})")
        self.scale = (
            np.frombuffer(payload, "<f4", self.d).copy()
            if len(payload) >= self.d * 4 else None
        )

    def _read_response(self):
        (length,) = _HDR.unpack(self._read_exact(_HDR.size))
        payload = self._read_exact(length)
        magic, version, status, ek, n = _RESP.unpack(payload[:_RESP.size])
        if magic != MAGIC or version != VERSION:
            raise ProtocolError("bad response frame")
        return status, ek, n, payload[_RESP.size:]

    def _read_exact(self, n: int) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise ProtocolError("connection closed")
            buf += chunk
        return bytes(buf)

    def score_batch(self, rows: np.ndarray, entity_fps: np.ndarray | None = None,
                    timestamps: np.ndarray | None = None, layout: int = LAYOUT_F32,
                    traceparent: str | None = None):
        """Score one frame → ``(scores f32[n], reasons | None)``, where
        ``reasons`` is ``(indices u8 (n, k), values f32 (n, k))`` when the
        explain leg rode the flush."""
        self.sock.sendall(encode_frame(rows, entity_fps, timestamps, scale=self.scale,
                                       layout=layout, traceparent=traceparent))
        status, ek, n, payload = self._read_response()
        return _parse_response_payload(status, ek, n, payload)

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            log.debug("client close failed", exc_info=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
