"""The port's network store tier (``fraud_detection_tpu_torch.service.
{wire,netserver,netclient,sentinel,storectl,migrate}``) on the CPU, held
against the JAX package's tier: the frames byte for byte, each package's
clients driving the other's server with equal rows, replication and data
directories across packages, a sentinel of either package failing over
stores of the other, and the cases of the JAX package's
``tests/test_netstore.py`` on the port — the SIGKILL failover through
``python -m fraud_detection_tpu_torch.service.netserver`` children among
them. Every comparison is exact: this is host code."""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import types

import pytest
import torch

import fraud_detection_tpu.service.db as jax_db_mod
import fraud_detection_tpu.service.taskq as jax_taskq_mod
from fraud_detection_tpu.service import netclient as jax_netclient
from fraud_detection_tpu.service import sentinel as jax_sentinel
from fraud_detection_tpu.service import wire as jax_wire
from fraud_detection_tpu.service.netserver import StoreServer as JaxStoreServer
import fraud_detection_tpu_torch.service.db as port_db_mod
import fraud_detection_tpu_torch.service.taskq as port_taskq_mod
from fraud_detection_tpu_torch.range.faults import FaultPlan
from fraud_detection_tpu_torch.service import metrics
from fraud_detection_tpu_torch.service import netclient as port_netclient
from fraud_detection_tpu_torch.service import sentinel as port_sentinel
from fraud_detection_tpu_torch.service import storectl
from fraud_detection_tpu_torch.service import wire
from fraud_detection_tpu_torch.service.db import ResultsDB
from fraud_detection_tpu_torch.service.errors import DatabaseError, ProtocolError, StoreAuthError
from fraud_detection_tpu_torch.service.netclient import NetBroker, NetResultsDB, _parse
from fraud_detection_tpu_torch.service.netserver import StoreServer, store_metrics
from fraud_detection_tpu_torch.service.sentinel import Sentinel, _call, _election_key
from fraud_detection_tpu_torch.service.taskq import Broker, SqliteBroker
from fraud_detection_tpu_torch.service.wire import parse_hostport, recv_frame, send_frame

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SERVERS = {"port": StoreServer, "jax": JaxStoreServer}
CLIENTS = {
    "port": (port_netclient.NetResultsDB, port_netclient.NetBroker),
    "jax": (jax_netclient.NetResultsDB, jax_netclient.NetBroker),
}
SENTINELS = {"port": port_sentinel.Sentinel, "jax": jax_sentinel.Sentinel}


def _wait(pred, timeout=10.0, interval=0.02):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return False


@pytest.fixture(autouse=True)
def _no_token(monkeypatch):
    monkeypatch.delenv("FRAUD_STORE_TOKEN", raising=False)


# ---------------------------------------------------------------------------
# the wire, byte for byte
# ---------------------------------------------------------------------------

FRAMES = [
    {"op": "ping"},
    {"op": "db.create_pending", "transaction_id": "tx-1",
     "input_data": {"Amount": 12.5, "V1": -1e-7}, "correlation_id": None},
    {"ok": True, "result": [{"id": "a", "args": ["tx", {"x": 0.1}, None], "attempts": 0}]},
    {"ok": False, "kind": "readonly", "error": "q.ack rejected: server is a replica"},
    {"t": "snapshot", "seq": 7, "epoch": 2, "results": [], "tasks": [],
     "unicode": "é — ✓"},
    wire.attach_auth({"op": "info"}, "s3cret"),
]


@pytest.mark.parametrize("obj", FRAMES, ids=[f"frame{i}" for i in range(len(FRAMES))])
def test_frames_equal_the_jax_packages_bytes(obj):
    """send_frame's bytes on a socketpair equal the JAX package's, and each
    package's recv_frame decodes the other's frame."""
    got = []
    for send, recv in ((send_frame, jax_wire.recv_frame), (jax_wire.send_frame, recv_frame)):
        a, b = socket.socketpair()
        try:
            send(a, dict(obj))
            a.shutdown(socket.SHUT_WR)
            raw = b.recv(1 << 20)
        finally:
            a.close()
            b.close()
        got.append(raw)
        a, b = socket.socketpair()
        try:
            a.sendall(raw)
            assert recv(b) == obj
        finally:
            a.close()
            b.close()
    assert got[0] == got[1]
    assert got[0][:4] == wire._HDR.pack(len(got[0]) - 4)


def test_wire_constants_and_auth_equal_the_jax_packages():
    assert (wire.MAX_FRAME, wire._HDR.format, wire.CONN_STALL_TIMEOUT) == (
        jax_wire.MAX_FRAME, jax_wire._HDR.format, jax_wire.CONN_STALL_TIMEOUT)
    assert wire.AUTH_REJECTION == jax_wire.AUTH_REJECTION
    for s, port in (("h:1", 2), (":9", 1), ("", 7600), ("db", 5)):
        assert parse_hostport(s, port) == jax_wire.parse_hostport(s, port)
    for token, frame in (("", {}), ("t", {"auth": "t"}), ("t", {"auth": "u"}),
                         ("t", {}), ("", {"auth": "x"}), ("t", {"auth": 5})):
        assert wire.check_auth(dict(frame), token) == jax_wire.check_auth(dict(frame), token)
    # the binary lane's length prefix and stall error are the wire's
    from fraud_detection_tpu_torch.service import binlane

    assert binlane._HDR is wire._HDR and binlane.StalledPeerError is wire.StalledPeerError


def test_url_parsing_equals_the_jax_packages():
    for url in ("fraud://h:7601", "fraud://h", "fraud://h:7601/", "sentinel://s1:1,s2:2/m1",
                "sentinel://s1/", "sentinel://a,b:3/x"):
        assert _parse(url) == jax_netclient._parse(url)
    with pytest.raises(ValueError):
        _parse("redis://h")
    assert (port_netclient.RETRIES, port_netclient.BACKOFF_BASE, port_netclient.BACKOFF_CAP,
            port_netclient.CONNECT_TIMEOUT, port_netclient.CALL_TIMEOUT) == (
        jax_netclient.RETRIES, jax_netclient.BACKOFF_BASE, jax_netclient.BACKOFF_CAP,
        jax_netclient.CONNECT_TIMEOUT, jax_netclient.CALL_TIMEOUT)


def test_election_key_orders_as_the_jax_packages():
    import random

    rnd = random.Random(5)
    infos = [{"epoch": rnd.randrange(4), "seq": rnd.randrange(50), "port": i}
             for i in range(64)] + [{}, {"seq": 3}, {"epoch": 1}]
    assert [_election_key(i) for i in infos] == [jax_sentinel._election_key(i) for i in infos]
    order = sorted(range(len(infos)), key=lambda i: _election_key(infos[i]))
    assert order == sorted(range(len(infos)), key=lambda i: jax_sentinel._election_key(infos[i]))
    # a later reign beats a longer history
    assert _election_key({"epoch": 1, "seq": 1}) > _election_key({"epoch": 0, "seq": 99})


# ---------------------------------------------------------------------------
# cross-package traffic: each package's clients against each package's server
# ---------------------------------------------------------------------------

_CLOCK = types.SimpleNamespace(time=lambda: 1_700_000_000.25)


@pytest.fixture()
def fixed_clock(monkeypatch):
    """The engines of both packages read one fixed clock, so the rows their
    servers hold compare exactly (timestamps included)."""
    for mod in (port_db_mod, port_taskq_mod, jax_db_mod, jax_taskq_mod):
        monkeypatch.setattr(mod, "time", _CLOCK)


def _traffic(db, q) -> dict:
    """One fixed run of every op of both clients; returns what they answered."""
    out = {}
    out["tx"] = [db.create_pending(f"tx{i}", {"Amount": float(i), "V1": -0.5 * i}, f"c{i}")
                 for i in range(4)]
    db.complete("tx0", {"Amount": 0.25, "V1": -1.5}, 0.125, 0.875)
    db.complete("tx1", {"Amount": 0.5}, -0.5, 0.0625)
    db.fail("tx2", "boom")
    db.fail("tx0", "late report")  # never clobbers COMPLETED
    out["get"] = [db.get(t) for t in ("tx0", "tx2", "tx3", "missing")]
    out["count"] = [db.count(), db.count("COMPLETED"), db.count("FAILED")]
    out["sent"] = [q.send_task("xai_tasks.compute_shap", [f"tx{i}", {"a": 1.0}, None],
                               correlation_id=f"c{i}", task_id=f"task{i}") for i in range(5)]
    out["resent"] = q.send_task("xai_tasks.compute_shap", [], task_id="task0")  # no dup
    out["depth"] = q.depth()
    tasks = q.claim_many("w1", 3, visibility_timeout=60.0)
    out["claimed"] = [t.__dict__ for t in tasks]
    q.ack(tasks[0].id)
    out["nack"] = [q.nack(tasks[1].id, 30.0, "retry", expected_attempts=0, claimed_by="w1"),
                   q.nack(tasks[1].id, 30.0, "retry", expected_attempts=0, claimed_by="w1")]
    out["single"] = q.claim("w2", visibility_timeout=60.0).__dict__
    out["status"] = [q.get_status(f"task{i}") for i in range(5)] + [q.get_status("none")]
    out["depth_after"] = q.depth()
    out["ping"] = [db.ping(), q.ping()]
    return out


@pytest.mark.parametrize("client,server", [("port", "jax"), ("jax", "port"), ("port", "port")])
def test_clients_drive_the_other_packages_server(tmp_path, fixed_clock, client, server):
    """The same operations through every (client, server) pairing answer the
    same and leave the same rows as the JAX client on the JAX server."""
    results = {}
    for c, s in ((client, server), ("jax", "jax")):
        srv = SERVERS[s](str(tmp_path / f"{c}-{s}"), port=0)
        srv.start()
        url = f"fraud://127.0.0.1:{srv.port}"
        db_cls, q_cls = CLIENTS[c]
        db, q = db_cls(url), q_cls(url)
        try:
            answers = _traffic(db, q)
            info = db.info()
            results[c, s] = (answers, srv.db.dump_rows(), srv.broker.dump_rows(), info)
        finally:
            db.close()
            q.close()
            srv.stop()
    got, want = results[client, server], results["jax", "jax"]
    assert got[0] == want[0]
    assert got[1] == want[1] and got[2] == want[2]
    assert got[3] == want[3]
    assert len(got[1]) == 4 and len(got[2]) == 5


# ---------------------------------------------------------------------------
# replication and data directories across packages
# ---------------------------------------------------------------------------

def _by_key(rows: list[dict]) -> list[dict]:
    """Rows in primary-key order (a replica inserts in stream order)."""
    return sorted(rows, key=lambda r: r.get("transaction_id") or r["id"])


@pytest.mark.parametrize("primary,replica", [("jax", "port"), ("port", "jax")])
def test_replica_of_the_other_packages_primary(tmp_path, primary, replica):
    """A snapshot then the row stream: the replica's dump_rows end equal to
    the primary's, and its seq and epoch follow."""
    p = SERVERS[primary](str(tmp_path / "p"), port=0)
    p.start()
    db, q = NetResultsDB(f"fraud://127.0.0.1:{p.port}"), NetBroker(f"fraud://127.0.0.1:{p.port}")
    pre = [db.create_pending(f"pre{i}", {"i": float(i)}, None) for i in range(3)]
    r = SERVERS[replica](str(tmp_path / "r"), port=0, replicate_from=f"127.0.0.1:{p.port}")
    r.start()
    try:
        assert _wait(lambda: r.db.count() == 3)  # the snapshot
        db.complete(pre[0], {"i": 0.5}, 0.0, 0.5)
        tids = [q.send_task("t", [i]) for i in range(4)]
        t = q.claim("w")
        q.ack(t.id)
        db.fail(pre[1], "x")
        assert _wait(lambda: r.seq == p.seq and r.broker.depth() == 3)
        assert _by_key(r.db.dump_rows()) == _by_key(p.db.dump_rows())
        assert _by_key(r.broker.dump_rows()) == _by_key(p.broker.dump_rows())
        assert r.epoch == p.epoch and r.role == "replica"
        assert sorted(row["id"] for row in r.broker.dump_rows()) == sorted(tids)
    finally:
        db.close()
        q.close()
        r.stop()
        p.stop()


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_data_directory_served_by_the_other_package(tmp_path, writer, reader):
    """``state.json`` and the two sqlite files one package's server wrote
    are served by the other's: role, epoch and seq restored, rows readable,
    writes continue."""
    d = str(tmp_path / "store")
    a = SERVERS[writer](d, port=0)
    a.start()
    db, q = NetResultsDB(f"fraud://127.0.0.1:{a.port}"), NetBroker(f"fraud://127.0.0.1:{a.port}")
    db.create_pending("tx", {"a": 1.0}, "c")
    q.send_task("t", ["tx"], task_id="t1")
    _call(("127.0.0.1", a.port), "promote")  # epoch 1, durable
    rows, tasks, seq = a.db.dump_rows(), a.broker.dump_rows(), a.seq
    db.close()
    q.close()
    a.stop()
    with open(os.path.join(d, "state.json")) as f:
        state = json.load(f)
    assert state == {"role": "primary", "replicate_from": None, "epoch": 1, "seq": seq}
    b = SERVERS[reader](d, port=0, replicate_from="127.0.0.1:1")  # argv says replica
    b.start()
    try:
        assert (b.role, b.epoch, b.seq, b.replicate_from) == ("primary", 1, seq, None)
        assert b.db.dump_rows() == rows and b.broker.dump_rows() == tasks
        db2 = ResultsDB(f"fraud://127.0.0.1:{b.port}")
        assert db2.get("tx")["input_data"] == {"a": 1.0}
        db2.create_pending("tx2", {}, None)
        assert db2.count() == 2
        db2.close()
    finally:
        b.stop()


@pytest.mark.parametrize("sentinel_pkg,store_pkg", [("port", "jax"), ("jax", "port")])
def test_sentinel_fails_over_the_other_packages_stores(tmp_path, sentinel_pkg, store_pkg):
    """A sentinel discovers the other package's primary, names it to
    clients, and promotes the replica when the primary stops; the same
    client then claims every task, none lost."""
    p = SERVERS[store_pkg](str(tmp_path / "p"), port=0)
    p.start()
    r = SERVERS[store_pkg](str(tmp_path / "r"), port=0, replicate_from=f"127.0.0.1:{p.port}")
    r.start()
    s = SENTINELS[sentinel_pkg]("m1", stores=[("127.0.0.1", p.port), ("127.0.0.1", r.port)],
                                quorum=1, down_after=0.5, poll_interval=0.05)
    s.start()
    try:
        assert _wait(lambda: s.master == ("127.0.0.1", p.port))
        q = Broker(f"sentinel://127.0.0.1:{s.port}/m1")
        sent = [q.send_task("t", [i]) for i in range(6)]
        assert _wait(lambda: r.broker.depth() == 6)
        p.stop()
        assert _wait(lambda: r.role == "primary", timeout=15.0)
        # the sentinel records its pick once the promote call returns
        assert _wait(lambda: s.master == ("127.0.0.1", r.port)) and r.epoch == 1
        sent.append(q.send_task("t", [99]))
        got = []
        while (t := q.claim("w", visibility_timeout=60)) is not None:
            got.append(t.id)
        assert sorted(got) == sorted(sent)
        q.close()
    finally:
        s.stop()
        r.stop()
        if p._listener is not None:
            p.stop()


# ---------------------------------------------------------------------------
# the cases of the JAX package's tests/test_netstore.py, on the port
# ---------------------------------------------------------------------------

def test_wire_roundtrip_large_frame():
    a, b = socket.socketpair()
    try:
        big = {"op": "x", "blob": "y" * (1 << 20)}
        # a 1 MiB frame overflows the socketpair's buffer: send beside recv
        t = threading.Thread(target=lambda: (send_frame(a, big), a.close()))
        t.start()
        assert recv_frame(b) == big
        assert recv_frame(b) is None  # clean EOF
        t.join(timeout=10)
    finally:
        b.close()


def test_wire_mid_frame_eof_is_protocol_error():
    a, b = socket.socketpair()
    try:
        a.sendall(b"\x00\x00\x00\x10partial")
        a.close()
        with pytest.raises(ProtocolError):
            recv_frame(b)
    finally:
        b.close()


def test_wire_mid_frame_stall_is_a_stalled_peer():
    """A timeout inside a frame is a StalledPeerError (an OSError); one at a
    frame boundary stays a TimeoutError (an idle peer)."""
    a, b = socket.socketpair()
    try:
        b.settimeout(0.05)
        with pytest.raises(TimeoutError):
            recv_frame(b)
        a.sendall(b"\x00\x00\x00\x10part")
        with pytest.raises(wire.StalledPeerError):
            recv_frame(b)
        assert issubclass(wire.StalledPeerError, OSError)
    finally:
        a.close()
        b.close()


def test_url_parsing():
    assert _parse("fraud://h:7601") == ("direct", [("h", 7601)], "")
    assert _parse("fraud://h") == ("direct", [("h", 7600)], "")
    mode, eps, name = _parse("sentinel://s1:1,s2:2/m1")
    assert mode == "sentinel" and eps == [("s1", 1), ("s2", 2)] and name == "m1"
    assert _parse("sentinel://s1/")[2] == "mymaster"
    assert parse_hostport(":9", 1) == ("127.0.0.1", 9)


@pytest.fixture()
def primary(tmp_path):
    srv = StoreServer(str(tmp_path / "p"), port=0)
    srv.start()
    yield srv
    srv.stop()


@pytest.fixture()
def replica(tmp_path, primary):
    srv = StoreServer(str(tmp_path / "r"), port=0, replicate_from=f"127.0.0.1:{primary.port}")
    srv.start()
    yield srv
    srv.stop()


def test_factories_dispatch_on_scheme(primary):
    url = f"fraud://127.0.0.1:{primary.port}"
    assert isinstance(Broker(url), NetBroker)
    assert isinstance(ResultsDB(url), NetResultsDB)
    with pytest.raises(NotImplementedError):
        Broker("amqp://x")


def test_db_roundtrip_over_network(primary):
    db = ResultsDB(f"fraud://127.0.0.1:{primary.port}")
    tx = db.create_pending(None, {"Amount": 5.0}, "corr-1")
    assert db.get(tx)["status"] == "PENDING"
    db.complete(tx, {"Amount": 0.7}, 0.1, 0.93)
    row = db.get(tx)
    assert row["status"] == "COMPLETED"
    assert row["shap_values"] == {"Amount": 0.7}
    assert row["prediction_score"] == 0.93
    assert db.count() == 1 and db.count("COMPLETED") == 1
    assert db.ping()
    db.fail("other", "boom")
    assert db.get("other")["status"] == "FAILED"
    assert db.migrate() == [] and db.applied_at_init == []  # the server migrates


def test_replication_streams_rows(primary, replica):
    db = ResultsDB(f"fraud://127.0.0.1:{primary.port}")
    q = Broker(f"fraud://127.0.0.1:{primary.port}")
    tx = db.create_pending(None, {"a": 1.0}, None)
    tid = q.send_task("xai_tasks.compute_shap", [tx, {"a": 1.0}, None])
    assert _wait(lambda: replica.db.get(tx) is not None)
    assert _wait(lambda: replica.broker.get_status(tid) == "QUEUED")
    assert replica.db.get(tx)["input_data"] == {"a": 1.0}


def test_replica_snapshot_catches_up_preexisting_state(tmp_path, primary):
    db = ResultsDB(f"fraud://127.0.0.1:{primary.port}")
    for i in range(5):
        db.create_pending(f"tx{i}", {"i": float(i)}, None)
    late = StoreServer(str(tmp_path / "late"), port=0,
                       replicate_from=f"127.0.0.1:{primary.port}")
    late.start()
    try:
        assert _wait(lambda: late.db.count() == 5)
    finally:
        late.stop()


def test_replica_rejects_writes_allows_reads(primary, replica, monkeypatch):
    monkeypatch.setattr(port_netclient, "RETRIES", 2)  # the readonly answer, twice
    ResultsDB(f"fraud://127.0.0.1:{primary.port}").create_pending("t1", {}, None)
    assert _wait(lambda: replica.db.get("t1") is not None)
    rdb = ResultsDB(f"fraud://127.0.0.1:{replica.port}")
    assert rdb.get("t1") is not None  # reads are served on a replica
    with pytest.raises(DatabaseError, match="replica"):
        rdb.create_pending("t2", {}, None)


def test_client_reconnects_after_server_restart(tmp_path):
    srv = StoreServer(str(tmp_path / "s"), port=0)
    srv.start()
    port = srv.port
    q = Broker(f"fraud://127.0.0.1:{port}")
    q.send_task("t", [1])
    srv.stop()
    q.close()  # drop the dead socket so the port leaves FIN_WAIT promptly
    time.sleep(0.1)
    srv2 = StoreServer(str(tmp_path / "s"), host="127.0.0.1", port=port)
    srv2.start()
    try:
        assert q.depth() == 1  # same data dir: the task persisted
        assert q.claim("w").args == [1]
    finally:
        srv2.stop()


def test_sentinel_discovers_and_serves_master(primary, replica):
    s = Sentinel("m1", stores=[("127.0.0.1", primary.port), ("127.0.0.1", replica.port)],
                 down_after=0.6, poll_interval=0.1)
    s.start()
    try:
        assert _wait(lambda: s.master == ("127.0.0.1", primary.port))
        q = Broker(f"sentinel://127.0.0.1:{s.port}/m1")
        q.send_task("t", [])
        assert q.depth() == 1
        assert _call(("127.0.0.1", s.port), "s.get-master", name="m1") == {
            "host": "127.0.0.1", "port": primary.port}
        assert _call(("127.0.0.1", s.port), "s.get-master", name="other") is None
    finally:
        s.stop()


def test_sentinel_quorum_blocks_lone_vote(primary, replica):
    """quorum=2 with no peers: a single sentinel must NOT fail over."""
    s = Sentinel("m1", stores=[("127.0.0.1", primary.port), ("127.0.0.1", replica.port)],
                 quorum=2, down_after=0.4, poll_interval=0.1)
    s.start()
    try:
        assert _wait(lambda: s.master is not None)
        primary.stop()
        time.sleep(1.5)
        assert replica.role == "replica"  # no promotion without quorum
    finally:
        s.stop()


def test_sentinel_quorum_failover_promotes_replica(primary, replica):
    """Two sentinels, quorum 2: the primary's death → agreement → the
    replica promoted; clients resolving through either sentinel keep
    working and the replicated tasks survive."""
    stores = [("127.0.0.1", primary.port), ("127.0.0.1", replica.port)]
    s1 = Sentinel("m1", stores=stores, quorum=2, down_after=0.5, poll_interval=0.1)
    s1.start()
    s2 = Sentinel("m1", stores=stores, peers=[("127.0.0.1", s1.port)],
                  quorum=2, down_after=0.5, poll_interval=0.1)
    s2.start()
    s1.peers = [("127.0.0.1", s2.port)]
    try:
        assert _wait(lambda: s1.master is not None and s2.master is not None)
        q = Broker(f"sentinel://127.0.0.1:{s1.port},127.0.0.1:{s2.port}/m1")
        sent = [q.send_task("t", [i]) for i in range(8)]
        assert _wait(lambda: replica.broker.depth() == 8), "replication did not catch up"
        primary.stop()
        assert _wait(lambda: replica.role == "primary", timeout=15.0), "no failover"
        sent.append(q.send_task("t", [99]))  # the same client, the new primary
        got = []
        while (t := q.claim("w", visibility_timeout=60)) is not None:
            got.append(t.id)
        assert sorted(got) == sorted(sent)  # zero task loss across failover
    finally:
        s1.stop()
        s2.stop()


def _spawn(args, log_path):
    env = dict(os.environ, PYTHONPATH=ROOT)
    with open(log_path, "w") as log:
        return subprocess.Popen([sys.executable, "-m", *args], env=env, cwd=ROOT,
                                stdout=log, stderr=subprocess.STDOUT)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait_server(port, timeout=20.0):
    def up():
        try:
            _call(("127.0.0.1", port), "ping", timeout=0.5)
            return True
        except OSError:
            return False

    assert _wait(up, timeout=timeout), f"server on :{port} never came up"


def test_kill9_primary_failover_no_task_loss(tmp_path):
    """The port's store servers and sentinel as their own processes: the
    primary dies by SIGKILL, the sentinel promotes the replica, and the
    same clients find every row and task."""
    p1, p2, ps = _free_port(), _free_port(), _free_port()
    procs = []
    try:
        procs.append(_spawn(["fraud_detection_tpu_torch.service.netserver", "--host",
                             "127.0.0.1", "--port", str(p1), "--data-dir",
                             str(tmp_path / "d1")], tmp_path / "p1.log"))
        _wait_server(p1)
        procs.append(_spawn(["fraud_detection_tpu_torch.service.netserver", "--host",
                             "127.0.0.1", "--port", str(p2), "--data-dir",
                             str(tmp_path / "d2"), "--replicate-from", f"127.0.0.1:{p1}"],
                            tmp_path / "p2.log"))
        _wait_server(p2)
        procs.append(_spawn(["fraud_detection_tpu_torch.service.sentinel", "--host",
                             "127.0.0.1", "--port", str(ps), "--master-name", "m1",
                             "--stores", f"127.0.0.1:{p1},127.0.0.1:{p2}", "--quorum", "1",
                             "--down-after", "0.8", "--poll-interval", "0.2"],
                            tmp_path / "s.log"))
        _wait_server(ps)

        url = f"sentinel://127.0.0.1:{ps}/m1"
        q, db = Broker(url), ResultsDB(url)
        sent = []
        for i in range(20):
            db.create_pending(f"tx{i}", {"i": float(i)}, None)
            sent.append(q.send_task("xai_tasks.compute_shap", [f"tx{i}", {}, None]))
        assert _wait(lambda: _call(("127.0.0.1", p2), "info", timeout=0.5)["depth"] == 20,
                     timeout=15.0)

        procs[0].send_signal(signal.SIGKILL)  # the primary dies hard
        procs[0].wait(timeout=10)

        def promoted():
            try:
                return _call(("127.0.0.1", p2), "ping", timeout=0.5)["role"] == "primary"
            except OSError:
                return False

        assert _wait(promoted, timeout=20.0), "the sentinel never promoted the replica"
        assert db.count() == 20
        sent.append(q.send_task("xai_tasks.compute_shap", ["tx_post", {}, None]))
        got = []
        while (t := q.claim("w", visibility_timeout=60)) is not None:
            got.append(t.id)
        assert sorted(got) == sorted(sent)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)


def test_auth_rejects_unauthenticated_and_accepts_token(tmp_path, monkeypatch):
    srv = StoreServer(str(tmp_path / "a"), port=0, auth_token="s3cret")
    srv.start()
    try:
        bad = ResultsDB(f"fraud://127.0.0.1:{srv.port}")  # no token client-side
        t0 = time.time()
        with pytest.raises(StoreAuthError, match="auth"):
            bad.get("x")
        assert time.time() - t0 < 2.0, "an auth failure must not burn the retry budget"
        monkeypatch.setenv("FRAUD_STORE_TOKEN", "s3cret")
        good = ResultsDB(f"fraud://127.0.0.1:{srv.port}")
        assert good.ping()
        tx = good.create_pending(None, {"a": 1.0}, None)
        assert good.get(tx)["status"] == "PENDING"
        # the JAX package's client carries the same credential
        assert jax_netclient.NetResultsDB(f"fraud://127.0.0.1:{srv.port}").get(tx) is not None
    finally:
        srv.stop()


def test_replica_auth_and_replication_with_token(tmp_path, monkeypatch):
    monkeypatch.setenv("FRAUD_STORE_TOKEN", "tok")
    p = StoreServer(str(tmp_path / "p"), port=0, auth_token="tok")
    p.start()
    r = StoreServer(str(tmp_path / "r"), port=0, replicate_from=f"127.0.0.1:{p.port}",
                    auth_token="tok")
    r.start()
    try:
        db = ResultsDB(f"fraud://127.0.0.1:{p.port}")
        db.create_pending("tx1", {"a": 1.0}, None)
        assert _wait(lambda: r.db.get("tx1") is not None)
    finally:
        r.stop()
        p.stop()


def test_sentinel_demotes_rejoining_stale_primary(tmp_path):
    """Split-brain recovery: after a failover, a healed old primary is
    demoted (a replica of the elected primary) and its partitioned writes
    are discarded by the snapshot-replace resync."""
    p1 = StoreServer(str(tmp_path / "p1"), port=0)
    p1.start()
    p2 = StoreServer(str(tmp_path / "p2"), port=0, replicate_from=f"127.0.0.1:{p1.port}")
    p2.start()
    s = Sentinel("m1", stores=[("127.0.0.1", p1.port), ("127.0.0.1", p2.port)],
                 quorum=1, down_after=0.5, poll_interval=0.1)
    s.start()
    old_port = p1.port
    try:
        assert _wait(lambda: s.master == ("127.0.0.1", p1.port))
        db = ResultsDB(f"fraud://127.0.0.1:{p1.port}")
        db.create_pending("pre", {"a": 1.0}, None)
        assert _wait(lambda: p2.db.get("pre") is not None)
        p1.stop()
        assert _wait(lambda: p2.role == "primary", timeout=15.0)
        # the old primary returns (same dir, same port, still primary)
        # carrying a write accepted while partitioned
        back = StoreServer(str(tmp_path / "p1"), host="127.0.0.1", port=old_port)
        back.db.create_pending("partitioned-write", {"x": 9.0}, None)
        back.start()
        try:
            assert _wait(lambda: back.role == "replica", timeout=15.0), \
                "the sentinel never demoted the stale primary"
            assert back.replicate_from == f"127.0.0.1:{p2.port}"
            assert _wait(lambda: back.db.get("partitioned-write") is None)
            assert _wait(lambda: back.db.get("pre") is not None)
        finally:
            back.stop()
    finally:
        s.stop()
        p2.stop()
        if p1._listener is not None:
            p1.stop()


def test_nack_with_expected_attempts_is_idempotent(tmp_path):
    b = SqliteBroker(f"sqlite:///{tmp_path}/q.db")
    tid = b.send_task("t", [], max_retries=2)
    assert b.claim("w").attempts == 0
    assert b.nack(tid, 0.0, "e", expected_attempts=0) is True
    assert b.nack(tid, 0.0, "e", expected_attempts=0) is True  # the same nack again
    with b._lock:
        row = b._conn.execute("SELECT attempts FROM tasks WHERE id = ?", (tid,)).fetchone()
    assert row["attempts"] == 1


def test_send_task_with_client_id_is_idempotent(primary):
    q = Broker(f"fraud://127.0.0.1:{primary.port}")
    tid = "fixed-id-123"
    assert q.send_task("t", [1], task_id=tid) == tid
    assert q.send_task("t", [1], task_id=tid) == tid  # an ambiguous retry's replay
    assert q.depth() == 1


def test_stalled_subscriber_dropped_healthy_replica_unaffected(primary, replica):
    """A subscriber that stops draining is dropped with a poison pill on
    overflow (no unbounded buffer on the primary), while healthy
    subscribers keep replicating."""
    import queue as queue_mod

    db = ResultsDB(f"fraud://127.0.0.1:{primary.port}")
    tx0 = db.create_pending(None, {"a": 1.0}, None)
    assert _wait(lambda: replica.db.get(tx0) is not None)
    stuck: queue_mod.Queue = queue_mod.Queue(maxsize=2)
    stuck.put({"t": "rows"})
    stuck.put({"t": "rows"})  # full: a subscriber that stopped draining
    primary._subs.append(stuck)
    tx1 = db.create_pending(None, {"a": 2.0}, None)  # its publish overflows `stuck`
    assert stuck not in primary._subs
    drained = []
    while True:
        try:
            drained.append(stuck.get_nowait())
        except queue_mod.Empty:
            break
    assert drained[-1] is None, "a dropped subscriber gets the poison pill"
    assert _wait(lambda: replica.db.get(tx1) is not None)
    tx2 = db.create_pending(None, {"a": 3.0}, None)
    assert _wait(lambda: replica.db.get(tx2) is not None)


def _subscribe(port: int) -> socket.socket:
    """A bare replica connection: subscribed, its snapshot read."""
    sub = socket.create_connection(("127.0.0.1", port), timeout=10)
    send_frame(sub, {"op": "subscribe"})
    assert recv_frame(sub)["t"] == "snapshot"
    return sub


def test_a_write_is_answered_after_its_row_frame_is_sent(primary, monkeypatch):
    """The port's semi-synchronous hand-off (where the JAX server is
    asynchronous): a write's answer waits until its row frame has been sent
    on every live replica's connection, so a primary killed after answering
    has already handed the replica every acknowledged row."""
    from fraud_detection_tpu_torch.service import netserver

    shipped = []

    def slow_send(sock, obj):
        if obj.get("t") == "rows":
            time.sleep(0.3)  # a subscriber thread slow to be scheduled
        send_frame(sock, obj)
        if obj.get("t") == "rows":
            shipped.append(time.perf_counter())

    monkeypatch.setattr(netserver, "send_frame", slow_send)
    sub = _subscribe(primary.port)
    try:
        db = ResultsDB(f"fraud://127.0.0.1:{primary.port}")
        tx = db.create_pending(None, {"a": 1.0}, None)
        answered = time.perf_counter()
        assert shipped and shipped[0] <= answered
        msg = recv_frame(sub)
        assert msg["t"] == "rows" and msg["rows"][0]["transaction_id"] == tx
        db.close()
    finally:
        sub.close()


def test_a_stalled_replica_is_waited_for_once(primary, monkeypatch):
    """A replica that does not take a row frame within ``SHIP_WAIT`` holds
    that one write's answer, is marked lagging and is not waited for again
    until it has sent the newest seq."""
    from fraud_detection_tpu_torch.service import netserver

    monkeypatch.setattr(netserver, "SHIP_WAIT", 1.0)
    release = threading.Event()

    def stalled_send(sock, obj):
        if obj.get("t") == "rows":
            release.wait(30)
        send_frame(sock, obj)

    monkeypatch.setattr(netserver, "send_frame", stalled_send)
    sub = _subscribe(primary.port)
    db = ResultsDB(f"fraud://127.0.0.1:{primary.port}")
    try:
        t = time.perf_counter()
        db.create_pending(None, {"a": 1.0}, None)
        first = time.perf_counter() - t
        t = time.perf_counter()
        db.create_pending(None, {"a": 2.0}, None)
        second = time.perf_counter() - t
        assert first >= 1.0 and second < 1.0
        assert len(primary._lagging) == 1
        release.set()
        assert recv_frame(sub)["t"] == "rows" and recv_frame(sub)["t"] == "rows"
        assert _wait(lambda: not primary._lagging), "caught up: waited for again"
    finally:
        release.set()
        db.close()
        sub.close()


def test_full_tier_restart_after_failover_preserves_writes(tmp_path):
    """Failover promotes pod-1, writes land on it, then the whole tier
    restarts with its original bootstrap args: ``state.json`` beats the
    argv, pod-0 comes back a replica of pod-1, every post-failover write
    survives."""
    dir0, dir1 = str(tmp_path / "p0"), str(tmp_path / "p1")
    pod0 = StoreServer(dir0, port=0)
    pod0.start()
    pod1 = StoreServer(dir1, port=0, replicate_from=f"127.0.0.1:{pod0.port}")
    pod1.start()
    db = ResultsDB(f"fraud://127.0.0.1:{pod0.port}")
    tx_pre = db.create_pending(None, {"a": 1.0}, None)
    assert _wait(lambda: pod1.db.get(tx_pre) is not None)
    pod0.stop()
    _call(("127.0.0.1", pod1.port), "promote")
    assert pod1.role == "primary" and pod1.epoch == 1
    tx_post = ResultsDB(f"fraud://127.0.0.1:{pod1.port}").create_pending(None, {"a": 2.0}, None)
    pod0a = StoreServer(dir0, port=0)
    pod0a.start()
    assert pod0a.role == "primary", "an un-demoted crash restores the stale primary"
    _call(("127.0.0.1", pod0a.port), "demote", replicate_from=f"127.0.0.1:{pod1.port}")
    assert _wait(lambda: pod0a.db.get(tx_post) is not None)  # resynced
    assert _wait(lambda: pod0a.epoch == 1)  # adopted the promoted epoch
    pod0a.stop()
    pod1.stop()
    pod0b = StoreServer(dir0, port=0)  # argv says "primary"
    pod0b.start()
    pod1b = StoreServer(dir1, port=0, replicate_from=f"127.0.0.1:{pod0b.port}")
    pod1b.start()
    try:
        assert pod1b.role == "primary" and pod1b.epoch == 1
        assert pod0b.role == "replica" and pod0b.epoch == 1
        assert pod1b.db.get(tx_post) is not None
        assert pod1b.db.get(tx_pre) is not None
        assert pod0b.db.get(tx_post) is not None
    finally:
        pod0b.stop()
        pod1b.stop()


@pytest.mark.parametrize("stale_pkg", ["port", "jax"])
def test_replica_refuses_snapshot_from_lower_epoch_upstream(tmp_path, stale_pkg):
    """A promoted port node pointed at a pre-failover primary (of either
    package) refuses the snapshot-replace: applying it would delete the
    post-failover writes."""
    stale = SERVERS[stale_pkg](str(tmp_path / "stale"), port=0)  # epoch 0
    stale.start()
    promoted = StoreServer(str(tmp_path / "promoted"), port=0)
    promoted.start()
    _call(("127.0.0.1", promoted.port), "promote")  # epoch 1
    tx = ResultsDB(f"fraud://127.0.0.1:{promoted.port}").create_pending(None, {"a": 3.0}, None)
    try:
        _call(("127.0.0.1", promoted.port), "demote", replicate_from=f"127.0.0.1:{stale.port}")
        time.sleep(1.5)  # the replica loop connects and refuses
        assert promoted.db.get(tx) is not None, \
            "a lower-epoch snapshot must not replace post-failover state"
        assert promoted.epoch == 1
    finally:
        stale.stop()
        promoted.stop()


def test_sentinel_elects_higher_epoch_over_higher_seq(tmp_path):
    """The election ranks by (epoch, seq): a stale primary with a long
    history loses to a later reign, and is then demoted toward it."""
    stale = StoreServer(str(tmp_path / "stale"), port=0)
    stale.start()
    later = StoreServer(str(tmp_path / "later"), port=0)
    later.start()
    _call(("127.0.0.1", later.port), "promote")  # epoch 1
    db = ResultsDB(f"fraud://127.0.0.1:{stale.port}")
    for i in range(6):  # stale seq = 6
        db.create_pending(f"s{i}", {"a": float(i)}, None)
    ResultsDB(f"fraud://127.0.0.1:{later.port}").create_pending("p0", {"a": 9.0}, None)
    assert stale.seq > later.seq and later.epoch > stale.epoch
    s = Sentinel("m1", stores=[("127.0.0.1", stale.port), ("127.0.0.1", later.port)],
                 quorum=1, down_after=0.5, poll_interval=0.05)
    s.start()
    try:
        assert _wait(lambda: s.master == ("127.0.0.1", later.port), timeout=10)
        assert _wait(lambda: stale.role == "replica", timeout=10)
        assert _wait(lambda: stale.epoch >= later.epoch, timeout=10)
    finally:
        s.stop()
        stale.stop()
        later.stop()


def test_seq_persisted_within_throttle_window(tmp_path):
    """The durable seq tracks the live seq (throttled ~0.5 s), not only the
    role transitions."""
    srv = StoreServer(str(tmp_path / "s"), port=0)
    srv.start()
    db = ResultsDB(f"fraud://127.0.0.1:{srv.port}")
    try:
        for i in range(5):
            db.create_pending(f"a{i}", {"v": float(i)}, None)
        time.sleep(0.6)  # past the save throttle
        db.create_pending("trigger", {"v": 9.0}, None)  # saves the seq on its way
        with open(f"{tmp_path}/s/state.json") as f:
            state = json.load(f)
        assert state["seq"] == srv.seq == 6
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# the port's own surfaces: the fault point, the metrics, the operator CLI
# ---------------------------------------------------------------------------

def test_fault_plan_stalls_netclient_call(primary):
    """``netclient.call`` is a named fault point, as in the JAX package: an
    armed stall holds the call before its first frame, then it completes."""
    db = ResultsDB(f"fraud://127.0.0.1:{primary.port}")
    plan = FaultPlan().stall("netclient.call", seconds=0.3, times=1)
    with plan.armed():
        t0 = time.perf_counter()
        assert db.count() == 0
        stalled = time.perf_counter() - t0
        t0 = time.perf_counter()
        assert db.count() == 0
        plain = time.perf_counter() - t0
    assert plan.fired("netclient.call") == 1
    assert stalled >= 0.3 and plain < 0.3


def test_store_metrics_in_a_registry_of_their_own(primary):
    """The store server's six series, read from the server at scrape time,
    in their own registry (none leaks into the API's), over HTTP."""
    import http.client

    before = len(metrics.REGISTRY)
    q = Broker(f"fraud://127.0.0.1:{primary.port}")
    q.send_task("t", [1])
    q.send_task("t", [2])
    server = metrics.start_http_server(0, "127.0.0.1", registry=store_metrics(primary))
    try:
        conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=10)
        conn.request("GET", "/metrics")
        text = conn.getresponse().read().decode()
        conn.close()
    finally:
        server.shutdown()
        server.server_close()
    assert len(metrics.REGISTRY) == before
    want = {"fraud_store_queue_depth": 2.0, "fraud_store_is_primary": 1.0,
            "fraud_store_replication_seq": 2.0, "fraud_store_failover_epoch": 0.0,
            "fraud_store_taskq_redeliveries_total": 0.0,
            "fraud_store_taskq_expired_claims_total": 0.0}
    got = {line.split()[0]: float(line.split()[1]) for line in text.splitlines()
           if line and not line.startswith("#")}
    assert got == want
    assert "# TYPE fraud_store_queue_depth gauge" in text
    assert [m.name for m in store_metrics(primary)] == list(want)
    assert metrics.render(store_metrics(primary)).decode() == text


def test_storectl_against_both_packages_servers(tmp_path, capsys):
    """The operator CLI: ping, info, promote and demote on a port and a JAX
    store server, get-master on a sentinel."""
    for pkg in ("port", "jax"):
        srv = SERVERS[pkg](str(tmp_path / pkg), port=0)
        srv.start()
        ep = f"127.0.0.1:{srv.port}"
        try:
            assert storectl.main(["ping", ep]) == 0
            assert json.loads(capsys.readouterr().out)["role"] == "primary"
            assert storectl.main(["info", ep]) == 0
            info = json.loads(capsys.readouterr().out)
            assert (info["depth"], info["results"], info["replicas"]) == (0, 0, 0)
            assert storectl.main(["promote", ep]) == 0
            assert json.loads(capsys.readouterr().out) == {"role": "primary"}
            assert srv.epoch == 1
            assert storectl.main(["demote", ep]) == 2  # needs the new primary
            capsys.readouterr()
            assert storectl.main(["demote", ep, "127.0.0.1:1"]) == 0
            assert json.loads(capsys.readouterr().out) == {"role": "replica"}
        finally:
            srv.stop()
    p = StoreServer(str(tmp_path / "m"), port=0)
    p.start()
    s = Sentinel("m1", stores=[("127.0.0.1", p.port)], down_after=0.6, poll_interval=0.05)
    s.start()
    try:
        assert _wait(lambda: s.master is not None)
        assert storectl.main(["get-master", f"127.0.0.1:{s.port}", "m1"]) == 0
        assert json.loads(capsys.readouterr().out) == {"host": "127.0.0.1", "port": p.port}
        assert storectl.main(["ping", "127.0.0.1:1", "--timeout", "0.2"]) == 1
    finally:
        s.stop()
        p.stop()


def test_migrate_entry_point_applies_migrations(tmp_path, monkeypatch):
    from fraud_detection_tpu_torch.service import migrate

    monkeypatch.setenv("DATABASE_URL", f"sqlite:///{tmp_path}/m.db")
    monkeypatch.setattr(sys, "argv", ["migrate"])
    migrate.main()
    db = ResultsDB(f"sqlite:///{tmp_path}/m.db")
    assert db.applied_at_init == []  # already applied by the entry point
    db.close()
