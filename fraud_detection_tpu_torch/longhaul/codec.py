"""Request/response codecs for the longhaul front tier.

The port's counterpart of the JAX package's ``longhaul/codec.py``, byte for
byte on every wire. The front accepts one scoring request in three formats
and answers in kind:

- ``json`` — ``{"rows": [[...]], "entities": [...|null], "ts": [...]}``;
- ``msgpack`` — the same schema, msgpack-packed (``msgpack`` is imported
  only inside its branch: where it is not installed, asking for it raises
  the ``ImportError`` that names it, with no fallback);
- ``binary`` — the binary lane's frame layout (``service/binlane.py``:
  magic/version/layout header, little-endian f32 feature block, u32 entity
  fingerprints, f64 timestamps), so a lane client can point at the front
  unchanged.

Whatever the format, the internal form is the ``(rows f32[n,d], ents)``
pair the micro-batcher flushes — ``ents[i]`` is ``(slot, fingerprint,
rel_ts)`` or ``None`` — so routed scores are bitwise across formats:
JSON/msgpack carry f32 values through f64, exact both ways; the binary
path ships the f32 bytes.

Host-to-host frames (front → owning host) carry base64-packed arrays inside
the framed-JSON wire (``service/wire.py``). A ledger table crosses in the
file's dtypes (``uint32`` fingerprint), whatever device it was read from.
"""

from __future__ import annotations

import base64
import json

import numpy as np
import torch

from fraud_detection_tpu_torch.ledger.state import (
    LedgerState,
    entity_fingerprint,
    entity_slot,
    host_state,
)
from fraud_detection_tpu_torch.service.binlane import (
    _ERRPAY,
    _FRAME,
    _RESP,
    FLAG_ENTITY,
    FLAG_TS,
    LAYOUT_F32,
    MAGIC,
    ST_OK,
    ST_UNAVAILABLE,
    VERSION,
)

FORMATS = ("json", "msgpack", "binary")

_TABLE_LEAVES = ("acc", "last_ts", "fingerprint", "collisions", "evictions")


class Unavailable(Exception):
    """The typed 503: the segment's owner is inheriting, or no healthy host
    serves it. Always carries a Retry-After hint — the degradation floor."""

    def __init__(self, message: str, retry_after_s: float):
        self.retry_after_s = retry_after_s
        super().__init__(message)


# -- base64 array packing (host-to-host frames) ------------------------------

def pack_array(arr) -> dict:
    """An array (numpy, or a tensor on any device) as base64 bytes with its
    dtype and shape. The shape is the array's own: a 0-d scalar comes back
    0-d."""
    a = arr.detach().cpu().numpy() if isinstance(arr, torch.Tensor) else np.asarray(arr)
    return {
        "b64": base64.b64encode(np.ascontiguousarray(a).tobytes()).decode("ascii"),
        "dtype": str(a.dtype),
        "shape": list(a.shape),
    }


def unpack_array(d: dict) -> np.ndarray:
    return np.frombuffer(
        base64.b64decode(d["b64"]), dtype=np.dtype(d["dtype"])
    ).reshape(d["shape"])


def pack_table(state: LedgerState) -> dict:
    """A ledger table of either form in the file's dtypes."""
    host = host_state(state)
    return {name: pack_array(getattr(host, name)) for name in _TABLE_LEAVES}


def unpack_table(d: dict) -> LedgerState:
    """The host table (numpy, the file's dtypes)."""
    return LedgerState(**{name: unpack_array(d[name]) for name in d})


# -- the three ingress formats -----------------------------------------------

def _ents_from_ids(entities, ts, spec):
    ents = []
    for i, ent in enumerate(entities):
        if ent is None:
            ents.append(None)
        else:
            s, fp = spec.row_keys(ent)
            ents.append((s, fp, float(ts[i])))
    return ents


def decode_request(payload: bytes, fmt: str, spec):
    """One scoring request → ``(rows f32[n,d], ents)``."""
    if fmt == "json":
        return _decode_mapping(json.loads(payload.decode("utf-8")), spec)
    if fmt == "msgpack":
        import msgpack

        return _decode_mapping(msgpack.unpackb(payload, raw=False), spec)
    if fmt == "binary":
        return _decode_binary(payload, spec)
    raise ValueError(f"unknown request format: {fmt}")


def _decode_mapping(obj: dict, spec):
    rows = np.asarray(obj["rows"], np.float32)
    if rows.ndim == 1:
        rows = rows[None, :]
    n = rows.shape[0]
    entities = obj.get("entities") or [None] * n
    ts = obj.get("ts") or [0.0] * n
    return rows, _ents_from_ids(entities, ts, spec)


def _decode_binary(payload: bytes, spec):
    """The binary lane's request frame (f32 layout). Entities arrive as u32
    fingerprints; the slot comes from the same multiply-shift hash the JSON
    edge applies, so an entity keyed on any lane shares one slot (and one
    owning host)."""
    if len(payload) < _FRAME.size:
        raise ValueError("short binary frame")
    magic, version, layout, d, flags, n = _FRAME.unpack_from(payload, 0)
    if magic != MAGIC or version != VERSION:
        raise ValueError("bad magic/version")
    if layout != LAYOUT_F32:
        raise ValueError("longhaul front accepts the f32 layout only")
    off = _FRAME.size
    rows = np.frombuffer(
        payload, dtype="<f4", count=n * d, offset=off
    ).reshape(n, d).astype(np.float32)
    off += n * d * 4
    fps = None
    if flags & FLAG_ENTITY:
        fps = np.frombuffer(payload, dtype="<u4", count=n, offset=off)
        off += n * 4
    ts = None
    if flags & FLAG_TS:
        ts = np.frombuffer(payload, dtype="<f8", count=n, offset=off)
        off += n * 8
    ents = []
    for i in range(n):
        fp = int(fps[i]) if fps is not None else 0
        if fp == 0:
            ents.append(None)  # the reserved null path
        else:
            slot = entity_slot(fp, spec.log2_slots)
            t = float(ts[i]) if ts is not None else 0.0
            ents.append((slot, fp, t))
    return rows, ents


def encode_request(rows, entities, ts, fmt: str, spec=None) -> bytes:
    """The client side's encoder (tests and drills drive the front with
    it)."""
    rows = np.asarray(rows, np.float32)
    n = rows.shape[0]
    if fmt in ("json", "msgpack"):
        body = {
            "rows": rows.astype(np.float64).tolist(),
            "entities": list(entities),
            "ts": [float(t) for t in ts],
        }
        if fmt == "json":
            return json.dumps(body).encode("utf-8")
        import msgpack

        return msgpack.packb(body, use_single_float=False)
    if fmt == "binary":
        if spec is None:
            raise ValueError("binary encoding needs the ledger spec")
        fps = np.zeros(n, "<u4")
        for i, ent in enumerate(entities):
            if ent is not None:
                fps[i] = entity_fingerprint(ent)
        hdr = _FRAME.pack(
            MAGIC, VERSION, LAYOUT_F32, rows.shape[1], FLAG_ENTITY | FLAG_TS, n,
        )
        return (
            hdr
            + rows.astype("<f4").tobytes()
            + fps.tobytes()
            + np.asarray(ts, "<f8").tobytes()
        )
    raise ValueError(f"unknown request format: {fmt}")


def encode_response(scores, fmt: str) -> bytes:
    scores = np.asarray(scores, np.float32)
    if fmt in ("json", "msgpack"):
        body = {"scores": scores.astype(np.float64).tolist()}
        if fmt == "json":
            return json.dumps(body).encode("utf-8")
        import msgpack

        return msgpack.packb(body, use_single_float=False)
    if fmt == "binary":
        hdr = _RESP.pack(MAGIC, VERSION, ST_OK, 0, scores.shape[0])
        return hdr + scores.astype("<f4").tobytes()
    raise ValueError(f"unknown response format: {fmt}")


def encode_unavailable(message: str, retry_after_s: float, fmt: str) -> bytes:
    """The 503 + Retry-After floor, in the caller's own format."""
    if fmt in ("json", "msgpack"):
        body = {"error": message, "status": 503, "retry_after_s": retry_after_s}
        if fmt == "json":
            return json.dumps(body).encode("utf-8")
        import msgpack

        return msgpack.packb(body)
    if fmt == "binary":
        msg = message.encode("utf-8")
        hdr = _RESP.pack(MAGIC, VERSION, ST_UNAVAILABLE, 0, len(msg))
        return hdr + _ERRPAY.pack(int(retry_after_s * 1000.0)) + msg
    raise ValueError(f"unknown response format: {fmt}")


def decode_response(payload: bytes, fmt: str) -> np.ndarray:
    """A front response's scores; raises :class:`Unavailable` on the 503."""
    if fmt in ("json", "msgpack"):
        if fmt == "json":
            obj = json.loads(payload.decode("utf-8"))
        else:
            import msgpack

            obj = msgpack.unpackb(payload, raw=False)
        if obj.get("status") == 503:
            raise Unavailable(
                obj.get("error", "unavailable"),
                float(obj.get("retry_after_s", 1.0)),
            )
        return np.asarray(obj["scores"], np.float32)
    if fmt == "binary":
        magic, version, status, _k, n = _RESP.unpack_from(payload, 0)
        if magic != MAGIC or version != VERSION:
            raise ValueError("bad response magic/version")
        if status == ST_OK:
            return np.frombuffer(
                payload, dtype="<f4", count=n, offset=_RESP.size
            ).astype(np.float32)
        (retry_ms,) = _ERRPAY.unpack_from(payload, _RESP.size)
        msg = payload[_RESP.size + _ERRPAY.size:].decode("utf-8", "replace")
        raise Unavailable(msg or "unavailable", retry_ms / 1000.0)
    raise ValueError(f"unknown response format: {fmt}")
