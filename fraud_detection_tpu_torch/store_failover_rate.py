"""Count the acknowledged writes that a SIGKILL of the primary store server
loses, over many kills.

A write's row ships to the replica from the primary's subscriber thread.
The JAX package's store server answers the write once it has committed it,
so a primary killed between the answer and the shipping loses a write whose
acknowledgement the client already holds. The port's server answers only
once the row frame has been sent on the replica's connection
(``service/netserver.py``). This script repeats the kill leg of
``chip_smoke.py``'s phase 15 at the store tier and counts how often an
acknowledged write is lost:

    python -m fraud_detection_tpu_torch.store_failover_rate --repeats 30 --think-ms 8

Each repeat starts a primary, a replica and a sentinel (quorum 1, the
default down-after of 3 s) of the port as child processes on loopback with
``FRAUD_STORE_TOKEN`` set. ``--clients`` threads then send the app's two
writes for a transaction (``create_pending``, then ``send_task``) through
one ``NetResultsDB`` and one ``NetBroker`` on ``sentinel://``, as the app's
``/predict`` does, each pausing ``--think-ms`` between transactions. A
first wave of 64 transactions is written and replicated (the replica's seq
at the primary's); in the second wave the primary is SIGKILLed once its
depth has grown by 8, after a random delay of up to 20 ms (phase 15 polls
the depth every 20 ms), and the threads go on across the failover until 64
transactions of that wave are acknowledged. Every acknowledged transaction
is then looked up on the promoted store: its row and its task. Per repeat it
prints the transactions acknowledged and lost, the primary's seq at its
last read before the kill, the replica's seq at its promotion (from its
log), the seconds to the promotion and the median time of a transaction's
two writes in the first wave; then a JSON line, also written to
``chiprun_out/store_failover_rate.json``. Imports no ``torch``. The server
is the one of the package the script is run from: to time another version,
run its copy with that copy's root as the working directory.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import re
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import uuid
from pathlib import Path

from fraud_detection_tpu_torch.service.errors import StoreError
from fraud_detection_tpu_torch.service.netclient import NetBroker, NetResultsDB
from fraud_detection_tpu_torch.service.sentinel import _call

ROOT = Path(__file__).resolve().parent.parent
TOKEN = "store-failover-rate-token"
WAVE = 64  # transactions before the kill, and acknowledged after it
KILL_AFTER = 8  # tasks the second wave adds before the kill
FEATURES = ["Time", *(f"V{i}" for i in range(1, 29)), "Amount"]


def free_port() -> int:
    # binds, reads the port and closes: never sends or receives on it
    with socket.socket() as s:  # lockcheck: ignore[socket-no-timeout] (the reason above)
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(args: list[str], log_path: Path) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=str(ROOT), FRAUD_STORE_TOKEN=TOKEN)
    with open(log_path, "w") as log:
        return subprocess.Popen([sys.executable, "-m", *args], cwd=ROOT, env=env,
                                stdout=log, stderr=subprocess.STDOUT)


def store_call(port: int, op: str, **kw):
    return _call(("127.0.0.1", port), op, timeout=1.0, **kw)


def wait_until(pred, timeout: float, what: str) -> None:
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        try:
            if pred():
                return
        except OSError:
            pass
        # polls a local child this tool started, not a shared dependency a
        # retry storm could hammer: a fixed 5 ms tick bounds the wait's error
        time.sleep(0.005)  # lockcheck: ignore[retry-no-backoff] (the reason above)
    raise AssertionError(f"{what} within {timeout} s")


class Writers:
    """``clients`` threads writing the app's two rows a transaction through
    one results client and one broker client, until ``stop`` or ``target``
    acknowledged transactions."""

    def __init__(self, url: str, clients: int, think_s: float, seed: int):
        self.db, self.broker = NetResultsDB(url), NetBroker(url)
        self.clients, self.think_s = clients, think_s
        self.rng = random.Random(seed)
        self.lock = threading.Lock()
        self.acked: list[tuple[str, str]] = []
        self.write_s: list[float] = []
        self.failed = 0
        self.target = 0
        self.done = threading.Event()

    def run(self, target: int) -> list[threading.Thread]:
        self.target, self.acked, self.failed = target, [], 0
        self.done.clear()
        threads = [threading.Thread(target=self._loop, daemon=True) for _ in range(self.clients)]
        for t in threads:
            t.start()
        return threads

    def _loop(self) -> None:
        while not self.done.is_set():
            with self.lock:
                row = {f: self.rng.gauss(0.0, 1.0) for f in FEATURES}
            tx = str(uuid.uuid4())
            t = time.perf_counter()
            try:
                self.db.create_pending(tx, row, None)
                tid = self.broker.send_task("xai_tasks.compute_shap", [tx, row, None, None])
            except StoreError:
                with self.lock:
                    self.failed += 1
                continue
            with self.lock:
                self.write_s.append(time.perf_counter() - t)
                self.acked.append((tx, tid))
                if len(self.acked) >= self.target:
                    self.done.set()
            if self.think_s:
                time.sleep(self.think_s)

    def close(self) -> None:
        self.db.close()
        self.broker.close()


def one_kill(work: Path, clients: int, think_s: float, seed: int) -> dict:
    p1, p2, ps = free_port(), free_port(), free_port()
    procs: dict[str, subprocess.Popen] = {}
    writers = None
    try:
        procs["primary"] = spawn(["fraud_detection_tpu_torch.service.netserver", "--port",
                                  str(p1), "--data-dir", str(work / "s1")], work / "s1.log")
        wait_until(lambda: store_call(p1, "ping"), 60, "the primary answered")
        procs["replica"] = spawn(["fraud_detection_tpu_torch.service.netserver", "--port",
                                  str(p2), "--data-dir", str(work / "s2"),
                                  "--replicate-from", f"127.0.0.1:{p1}"], work / "s2.log")
        wait_until(lambda: store_call(p2, "ping"), 60, "the replica answered")
        procs["sentinel"] = spawn(["fraud_detection_tpu_torch.service.sentinel", "--port",
                                   str(ps), "--master-name", "m1", "--stores",
                                   f"127.0.0.1:{p1},127.0.0.1:{p2}", "--quorum", "1"],
                                  work / "sentinel.log")
        wait_until(lambda: store_call(ps, "s.get-master", name="m1") == {
            "host": "127.0.0.1", "port": p1}, 60, "the sentinel named the primary")
        writers = Writers(f"sentinel://127.0.0.1:{ps}/m1", clients, think_s, seed)

        for t in writers.run(WAVE):
            t.join()
        seq = store_call(p1, "info")["seq"]
        wait_until(lambda: store_call(p2, "info")["seq"] == seq, 60,
                   "the replica reached the primary's seq")
        acked_before = list(writers.acked)
        write_s = sorted(writers.write_s)

        depth = store_call(p1, "info")["depth"]
        threads = writers.run(WAVE)
        last = {}

        def grown() -> bool:
            last.update(store_call(p1, "info"))
            return last["depth"] >= depth + KILL_AFTER

        wait_until(grown, 120, "the second wave reached the primary")
        time.sleep(random.Random(seed).uniform(0.0, 0.020))
        procs["primary"].send_signal(signal.SIGKILL)
        procs["primary"].wait(timeout=30)
        t_kill = time.perf_counter()
        wait_until(lambda: store_call(p2, "ping")["role"] == "primary", 60,
                   "the sentinel promoted the replica")
        promoted_s = time.perf_counter() - t_kill
        for t in threads:
            t.join(timeout=120)
        acked = acked_before + writers.acked
        match = re.search(r"PROMOTED to primary \(seq (\d+)", (work / "s2.log").read_text())

        db, broker = NetResultsDB(f"fraud://127.0.0.1:{p2}"), NetBroker(f"fraud://127.0.0.1:{p2}")
        try:
            lost_rows = [tx for tx, _ in acked if db.get(tx) is None]
            lost_tasks = [tid for _, tid in acked if broker.get_status(tid) is None]
        finally:
            db.close()
            broker.close()
        return {
            "acked": len(acked), "acked_across_kill": len(writers.acked),
            "failed_calls": writers.failed,
            "lost_rows": len(lost_rows), "lost_tasks": len(lost_tasks),
            "lost_transactions": len({tx for tx, tid in acked
                                      if tx in lost_rows or tid in lost_tasks}),
            "primary_seq_last_read": last.get("seq"),
            "replica_seq_at_promotion": int(match.group(1)) if match else None,
            "promoted_s": promoted_s,
            "write_p50_ms": write_s[len(write_s) // 2] * 1e3,
        }
    finally:
        if writers is not None:
            writers.done.set()
            writers.close()
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=30)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--think-ms", type=float, default=8.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "store_failover_rate.json"))
    args = ap.parse_args()
    os.environ["FRAUD_STORE_TOKEN"] = TOKEN  # the clients' token: the children's
    runs = []
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="store-failover-") as tmp:
        for r in range(args.repeats):
            work = Path(tmp) / f"r{r}"
            work.mkdir()
            run = one_kill(work, args.clients, args.think_ms / 1e3, args.seed + r)
            runs.append(run)
            print(f"repeat {r}: {json.dumps(run)}", flush=True)
    lost = sum(run["lost_transactions"] > 0 for run in runs)
    out = {"repeats": args.repeats, "clients": args.clients, "think_ms": args.think_ms,
           "kills_losing_acknowledged_writes": lost,
           "lost_transactions": sum(run["lost_transactions"] for run in runs),
           "acked": sum(run["acked"] for run in runs),
           "write_p50_ms_median": sorted(run["write_p50_ms"] for run in runs)[len(runs) // 2],
           "seconds": time.perf_counter() - t0, "runs": runs}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps({k: v for k, v in out.items() if k != "runs"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
