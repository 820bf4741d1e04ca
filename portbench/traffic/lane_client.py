"""The binary lane's load: a process apart from the server, one thread a
connection, each with one frame in flight (a closed loop).

Run by ``traffic/lane.py``: it prints ``ready`` once every connection has
its HELLO and has warmed (``warm_frames`` rounds of a frame on every
connection at once), waits for ``go`` on its standard
input, sends for ``--seconds``, then waits for the frames still in flight
(at most a minute), writes the answers the run checks to ``--out`` and
prints one JSON line of counts. Frames are encoded here from the wire
contract (``service/binlane.py``'s docstring): a 4-byte big-endian length,
the header ``>HBBHBxI`` (magic 0x4642, version 1, layout 1 = f32, d,
flags 0, n), the f32 rows little-endian; the answer ``>HBBBxI`` (magic,
version, status, k, n), then n f32 scores, n·k u8 reason indices and n·k
f32 reason values. Runs on the cores ``--cpus`` names, which the server
leaves free. Imports numpy and the benchmark's inputs only.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import struct
import sys
import threading
import time
from pathlib import Path

if __name__ == "__main__":  # before numpy starts any thread
    for _i, _a in enumerate(sys.argv):
        if _a == "--cpus" and _i + 1 < len(sys.argv):
            os.sched_setaffinity(0, {int(c) for c in sys.argv[_i + 1].split(",")})

import numpy as np  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench import inputs, registry  # noqa: E402

HDR = struct.Struct(">I")
FRAME = struct.Struct(">HBBHBxI")
RESP = struct.Struct(">HBBBxI")
MAGIC, VERSION, LAYOUT_F32 = 0x4642, 1, 1
#: how long past the window the client waits for an answer in flight
DRAIN_S = 60.0


def encode(rows: np.ndarray) -> bytes:
    n, d = rows.shape
    payload = FRAME.pack(MAGIC, VERSION, LAYOUT_F32, d, 0, n) + rows.astype("<f4").tobytes()
    return HDR.pack(len(payload)) + payload


def read_exact(sock: socket.socket, buf: bytearray, n: int) -> memoryview:
    mv = memoryview(buf)[:n]
    got = 0
    while got < n:
        k = sock.recv_into(mv[got:], n - got)
        if not k:
            raise ConnectionError("server closed the connection")
        got += k
    return mv


def read_answer(sock, buf):
    (length,) = HDR.unpack(read_exact(sock, buf, HDR.size))
    if length > len(buf):
        buf.extend(b"\0" * (length - len(buf)))
    mv = read_exact(sock, buf, length)
    magic, version, status, k, n = RESP.unpack(mv[:RESP.size])
    if magic != MAGIC or version != VERSION:
        raise ConnectionError("bad answer frame")
    return status, k, n, mv[RESP.size:]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--config", required=True)
    ap.add_argument("--mix", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--sample", type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--pkg", default=str(registry.PKG))
    ap.add_argument("--cpus", default=None, help="comma-separated cores (set at start-up)")
    a = ap.parse_args(argv)
    pkg = Path(a.pkg)
    cfg, mix = registry.config(a.config, pkg), registry.mix(a.mix, pkg)
    n_frames, frame_rows = mix["frames"], mix["frame_rows"]
    x, _ = inputs.rows(cfg, a.seed, n_frames * frame_rows)
    frames = [encode(x[i * frame_rows:(i + 1) * frame_rows]) for i in range(n_frames)]
    sample = set(inputs.check_sample(a.seed, n_frames, a.sample).tolist())
    conns = []
    for _ in range(mix["connections"]):
        s = socket.create_connection(("127.0.0.1", a.port), timeout=DRAIN_S)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        conns.append(s)
    bufs = [bytearray(1 << 16) for _ in conns]
    for s, b in zip(conns, bufs):  # the HELLO
        status, _, d, _ = read_answer(s, b)
        if status != 0 or d != x.shape[1]:
            raise ConnectionError(f"hello status {status}, width {d}")
    # warm with every connection's frame in flight at once, as in the window,
    # so the server's pools grow to their steady size before it
    for j in range(mix.get("warm_frames", 2)):
        for i, s in enumerate(conns):
            s.sendall(frames[(i + j * len(conns)) % n_frames])
        for s, b in zip(conns, bufs):
            if read_answer(s, b)[0] != 0:
                raise ConnectionError("warm-up frame refused")
    print("ready", flush=True)
    if sys.stdin.readline().strip() != "go":
        return 1

    lock = threading.Lock()
    answers: dict[int, tuple] = {}
    lat: list[float] = []
    counts = {"sent": 0, "ok": 0, "failed": 0, "rows_in_window": 0, "frames_in_window": 0,
              "late": 0}
    t0 = time.perf_counter()
    deadline = t0 + a.seconds
    start = threading.Event()

    def worker(i: int) -> None:
        sock, buf = conns[i], bufs[i]
        k = i
        mine = []
        c = dict.fromkeys(counts, 0)
        start.wait()
        while True:
            t_send = time.perf_counter()
            if t_send >= deadline:
                break
            fid = k % n_frames
            k += len(conns)
            c["sent"] += 1
            try:
                sock.sendall(frames[fid])
                status, ek, n, payload = read_answer(sock, buf)
            except (OSError, ConnectionError):
                c["failed"] += 1
                break
            t_recv = time.perf_counter()
            if status != 0 or n != frame_rows:
                c["failed"] += 1
                continue
            c["ok"] += 1
            if t_recv <= deadline:
                c["rows_in_window"] += n
                c["frames_in_window"] += 1
                mine.append(t_recv - t_send)
            else:
                c["late"] += 1
            if fid in sample and fid not in answers:
                scores = np.frombuffer(payload, "<f4", n).copy()
                idx = np.frombuffer(payload, np.uint8, n * ek, 4 * n).reshape(n, ek).copy()
                val = np.frombuffer(payload, "<f4", n * ek, 4 * n + n * ek).reshape(n, ek).copy()
                with lock:
                    answers.setdefault(fid, (scores, idx, val))
        with lock:
            lat.extend(mine)
            for key, v in c.items():
                counts[key] += v

    threads = [threading.Thread(target=worker, args=(i,), daemon=True)
               for i in range(len(conns))]
    for t in threads:
        t.start()
    start.set()
    for t in threads:
        t.join(a.seconds + DRAIN_S)
    for s in conns:
        s.close()
    ids = sorted(answers)
    ek = answers[ids[0]][1].shape[1] if ids else 0
    np.savez(
        a.out, ids=np.asarray(ids, np.int64),
        scores=np.stack([answers[i][0] for i in ids]) if ids else np.zeros((0, frame_rows)),
        idx=np.stack([answers[i][1] for i in ids]) if ids else np.zeros((0, frame_rows, ek)),
        val=np.stack([answers[i][2] for i in ids]) if ids else np.zeros((0, frame_rows, ek)),
        lat=np.asarray(lat, np.float64),
    )
    counts["seconds"] = a.seconds
    counts["stuck_threads"] = sum(t.is_alive() for t in threads)
    print(json.dumps(counts), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
