"""Framed-JSON wire protocol for the network store tier.

The port's own copy of the JAX package's ``service/wire.py``, byte for byte
on the wire, so either package's client talks to either package's server.

One frame = 4-byte big-endian length + UTF-8 JSON payload. Requests are
``{"op": <name>, ...kwargs}``; responses ``{"ok": true, "result": ...}`` or
``{"ok": false, "error": <msg>, "kind": <classifier>}``. A subscription
stream (replication) reuses the same framing with typed messages.

This replaces the reference's two wire protocols — the Celery/Redis protocol
(xai_tasks.py:59-60) and libpq (db/db.py:6-9) — with one dependency-free
protocol carrying both the queue and the results store.
"""

from __future__ import annotations

import hmac
import json
import socket
import struct
from typing import Any

from fraud_detection_tpu_torch.service.errors import ProtocolError

MAX_FRAME = 64 << 20  # 64 MiB: snapshots of large stores stay under this
_HDR = struct.Struct(">I")

# Stall timeout applied to every accepted command connection AT ACCEPT TIME
# (netserver and sentinel share this value). On the receive side it is a
# per-recv() progress timeout: an idle-but-alive client just re-arms the
# recv (TimeoutError at a frame boundary, handler loops), while a peer that
# stalls mid-frame raises StalledPeerError and is dropped. Note the
# asymmetry: for sendall() Python applies the socket timeout as a deadline
# on the WHOLE call, so a frame that cannot be fully handed to the kernel
# within this window is also treated as a stalled peer — a silently-dead
# peer can no longer wedge a handler thread for the ~15 min TCP
# retransmission takes to give up.
CONN_STALL_TIMEOUT = 30.0


class StalledPeerError(ProtocolError, OSError):
    """Socket timeout fired mid-frame: the peer stalled (dead without RST,
    or wedged) — the connection is unrecoverable because the stream position
    is inside a frame. Inherits OSError so every existing transient-network
    handler (``except OSError``) treats it as a connection loss."""


def _recv_exact(sock: socket.socket, n: int) -> bytes | None:
    """Read exactly n bytes; None on clean EOF at a frame boundary.

    With a socket timeout set, a timeout BEFORE any byte arrives propagates
    as ``TimeoutError`` (caller may treat as idle and retry — no stream
    state was consumed); a timeout after a partial read raises
    :class:`StalledPeerError` (resuming is impossible mid-frame).
    """
    buf = bytearray()
    while len(buf) < n:
        try:
            chunk = sock.recv(min(n - len(buf), 1 << 20))
        except TimeoutError:
            if not buf:
                raise
            raise StalledPeerError(
                f"peer stalled mid-frame ({len(buf)}/{n} bytes)"
            ) from None
        if not chunk:
            if not buf:
                return None
            raise ProtocolError("connection closed mid-frame")
        buf += chunk
    return bytes(buf)


def send_frame(sock: socket.socket, obj: Any) -> None:
    payload = json.dumps(obj, separators=(",", ":")).encode()
    if len(payload) > MAX_FRAME:
        raise ProtocolError(f"frame too large ({len(payload)} bytes)")
    sock.sendall(_HDR.pack(len(payload)) + payload)


def recv_frame(sock: socket.socket) -> Any | None:
    """One decoded frame, or None on clean EOF.

    Under a socket timeout, ``TimeoutError`` escapes only while the stream
    is at a frame boundary (idle peer — safe to retry); once the header has
    been consumed, a timeout is a :class:`StalledPeerError`.
    """
    hdr = _recv_exact(sock, _HDR.size)
    if hdr is None:
        return None
    (n,) = _HDR.unpack(hdr)
    if n > MAX_FRAME:
        raise ProtocolError(f"frame too large ({n} bytes)")
    try:
        data = _recv_exact(sock, n)
    except TimeoutError:
        # the header was already consumed, so even a zero-byte body read
        # timing out leaves the stream mid-frame
        raise StalledPeerError(
            "peer stalled between frame header and body"
        ) from None
    if data is None:
        raise ProtocolError("connection closed before frame body")
    return json.loads(data)


def parse_hostport(s: str, default_port: int) -> tuple[str, int]:
    host, _, port = s.partition(":")
    return host or "127.0.0.1", int(port) if port else default_port


# -- shared-secret auth (one implementation for every tier) ------------------

AUTH_REJECTION = {"ok": False, "kind": "auth", "error": "authentication failed"}


def attach_auth(req: dict, token: str) -> dict:
    """Attach the shared secret to an outgoing request frame (no-op when
    unconfigured)."""
    if token:
        req["auth"] = token
    return req


def check_auth(req: dict, token: str) -> bool:
    """Pop and verify the frame's credential (constant-time). True when the
    server has no token configured or the frame's token matches."""
    tok = req.pop("auth", None)
    if not token:
        return True
    return isinstance(tok, str) and hmac.compare_digest(
        tok.encode(), token.encode()
    )
