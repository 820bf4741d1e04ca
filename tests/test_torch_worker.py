"""The port's SHAP worker (``fraud_detection_tpu_torch.service.worker``) on
the CPU over the three storage backends (sqlite files, ``fraud://`` and
``postgresql://``): the cases of the JAX package's ``tests/test_worker.py``
— one task, an unknown task and
bad input ending FAILED, redelivery after a worker's death, the idempotent
upsert and ``fail()`` never clobbering COMPLETED, a GBT forest, ``run_batch``
in one dispatch isolating a bad task, the batch and single paths agreeing,
two workers racing without loss — plus the worker's entry point."""

import math
import os
import threading
import time

import numpy as np
import pytest
import torch

from fraud_detection_tpu_torch.models import FraudGBTModel, FraudLogisticModel
from fraud_detection_tpu_torch.ops.gbt import GBTConfig, gbt_fit
from fraud_detection_tpu_torch.service import metrics
from fraud_detection_tpu_torch.service.db import COMPLETED, FAILED, PENDING, ResultsDB
from fraud_detection_tpu_torch.service.taskq import DONE, Broker
from fraud_detection_tpu_torch.service.worker import XaiWorker, main

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = FraudLogisticModel.load(os.path.join(ROOT, "models"), device="cpu").feature_names


_SERVER = None  # the in-process StoreServer while ``env`` runs "net"


@pytest.fixture(params=["sqlite", "net", "pg"])
def env(request, tmp_path, monkeypatch):
    """(db_url, broker_url, names) over the three storage backends, as the
    JAX package's ``tests/test_worker.py`` runs them: sqlite files, the
    port's network store server in process (``fraud://``), and the
    PostgreSQL wire client against the protocol emulator
    (``postgresql://``). The committed flagship is served on the CPU (from
    ``MODEL_PATH``: the tracking store is empty)."""
    global _SERVER
    monkeypatch.setenv("MODEL_PATH", os.path.join(ROOT, "models", "model.npz"))
    monkeypatch.setenv("MLFLOW_TRACKING_URI", f"file:{tmp_path}/mlruns")
    monkeypatch.setenv("DEVICE", "cpu")
    monkeypatch.setenv("LIFECYCLE_DB_URL", f"sqlite:///{tmp_path}/lifecycle.db")
    if request.param == "sqlite":
        yield f"sqlite:///{tmp_path}/fraud.db", f"sqlite:///{tmp_path}/q.db", NAMES
    elif request.param == "pg":
        from tests.pg_backend import pg_dsn

        with pg_dsn() as dsn:
            yield dsn, dsn, NAMES
    else:
        from fraud_detection_tpu_torch.service.netserver import StoreServer

        _SERVER = StoreServer(str(tmp_path / "store"), port=0)
        _SERVER.start()
        url = f"fraud://127.0.0.1:{_SERVER.port}"
        try:
            yield url, url, NAMES
        finally:
            _SERVER.stop()
            _SERVER = None


def _engine(broker):
    """The SQL engine behind ``broker``: the store server's on ``fraud://``."""
    return _SERVER.broker if _SERVER is not None else broker


def _force_all_visible(broker):
    """Zero every task's visible_at so retries don't sleep."""
    engine = _engine(broker)
    with engine._lock, engine._conn:
        engine._conn.execute("UPDATE tasks SET visible_at = 0")


def _random_features(rng, names):
    return {n: float(v) for n, v in zip(names, rng.standard_normal(len(names)))}


def test_worker_processes_task(env):
    db_url, broker_url, names = env
    broker, db = Broker(broker_url), ResultsDB(db_url)
    feats = {n: 0.1 for n in names}
    db.create_pending("tx1", feats, "c1")
    assert db.get("tx1")["status"] == PENDING
    broker.send_task("xai_tasks.compute_shap", ["tx1", feats, "c1"])

    w = XaiWorker(broker_url=broker_url, database_url=db_url)
    assert w.run_once() is True
    row = db.get("tx1")
    assert row["status"] == COMPLETED
    assert list(row["shap_values"]) == names
    # the linear closed form: Σφ + E[f] is the logit of the stored score
    logit = math.log(row["prediction_score"] / (1 - row["prediction_score"]))
    assert sum(row["shap_values"].values()) + row["expected_value"] == pytest.approx(
        logit, abs=1e-4
    )
    assert w.run_once() is False  # queue drained


def test_unknown_task_retries_then_fails(env):
    """A task name the worker does not serve takes the retry ladder to
    FAILED (the JAX test's task name)."""
    db_url, broker_url, _ = env
    broker = Broker(broker_url)
    tid = broker.send_task("no.such.task", ["txX", {}, None], max_retries=1)
    w = XaiWorker(broker_url=broker_url, database_url=db_url)
    assert w.run_once() is True  # attempt 1 fails -> nack, 10 s countdown
    assert broker.depth() == 0  # backing off
    _force_all_visible(broker)
    assert w.run_once() is True  # attempt 2 exceeds max_retries -> FAILED
    assert broker.get_status(tid) == FAILED
    row = ResultsDB(db_url).get("txX")
    assert row["status"] == FAILED
    assert "unknown task" in row["shap_values"]["error"]


def test_bad_input_marks_failed_after_retries(env):
    db_url, broker_url, _ = env
    broker, db = Broker(broker_url), ResultsDB(db_url)
    db.create_pending("tx2", {"bad": 1}, None)
    broker.send_task("xai_tasks.compute_shap", ["tx2", {"bad": 1.0}, None], max_retries=0)
    w = XaiWorker(broker_url=broker_url, database_url=db_url)
    assert w.run_once() is True
    assert db.get("tx2")["status"] == FAILED


def test_worker_death_reprocessing(env):
    """acks_late end to end: worker A claims and dies (no ack); worker B
    reprocesses the same task once the visibility window lapses."""
    db_url, broker_url, names = env
    broker, db = Broker(broker_url), ResultsDB(db_url)
    feats = {n: 0.5 for n in names}
    db.create_pending("tx3", feats, None)
    tid = broker.send_task("xai_tasks.compute_shap", ["tx3", feats, None])
    assert broker.claim("workerA", visibility_timeout=0.05) is not None
    time.sleep(0.06)
    w = XaiWorker(broker_url=broker_url, database_url=db_url, worker_id="workerB")
    assert w.run_once() is True
    assert db.get("tx3")["status"] == COMPLETED
    assert broker.get_status(tid) == DONE
    assert _engine(w.broker).expired_claims == 1


def test_results_db_upsert_idempotent_and_fail_never_clobbers_completed(env):
    db_url, *_ = env
    db = ResultsDB(db_url)
    # over fraud:// the store server migrated its own file at start-up
    first = (_SERVER.db if _SERVER is not None else db).applied_at_init
    assert first == ["0001_transaction_results", "0002_status_index"]
    assert ResultsDB(db_url).applied_at_init == []  # migrations applied once
    db.create_pending("t", {"a": 1}, None)
    db.complete("t", {"a": 0.5}, 0.1, 0.9)
    db.complete("t", {"a": 0.6}, 0.1, 0.9)  # duplicate delivery
    row = db.get("t")
    assert row["status"] == COMPLETED
    assert row["shap_values"] == {"a": 0.6}
    db.fail("t", "a late failure report")  # the WHERE guard
    assert db.get("t")["status"] == COMPLETED
    assert db.get("t")["shap_values"] == {"a": 0.6}
    db.create_pending("u", {"a": 1}, None)
    db.fail("u", "boom")
    assert db.get("u")["status"] == FAILED
    assert db.get("u")["shap_values"] == {"error": "boom"}
    assert db.count() == 2 and db.count(COMPLETED) == 1 and db.count(FAILED) == 1
    assert db.get("nope") is None


def test_worker_explains_gbt_model(env, tmp_path, monkeypatch):
    """A GBT forest explained end to end (TreeSHAP), in one task and in a
    batch: local accuracy Σφ + E[f] = logit(score)."""
    db_url, broker_url, names = env
    rng = np.random.default_rng(0)
    x = rng.standard_normal((300, 30)).astype(np.float32)
    y = (x[:, 0] > 0.5).astype(np.int32)
    forest = gbt_fit(x, y, GBTConfig(n_trees=5, max_depth=3, n_bins=16), device="cpu")
    model_dir = str(tmp_path / "gbt_models")
    FraudGBTModel(forest, names, background=x[:32], device="cpu").save(model_dir)
    monkeypatch.setenv("MODEL_PATH", os.path.join(model_dir, "model.npz"))

    broker, db = Broker(broker_url), ResultsDB(db_url)
    for i in range(3):
        feats = _random_features(rng, names)
        db.create_pending(f"txg{i}", feats, "cg")
        broker.send_task("xai_tasks.compute_shap", [f"txg{i}", feats, "cg"])
    w = XaiWorker(broker_url=broker_url, database_url=db_url)
    assert isinstance(w.model, FraudGBTModel)
    assert w.run_once() is True
    assert w.run_batch(max_batch=8) == 2
    for i in range(3):
        row = db.get(f"txg{i}")
        assert row["status"] == COMPLETED
        assert len(row["shap_values"]) == 30
        score = row["prediction_score"]
        recon = sum(row["shap_values"].values()) + row["expected_value"]
        assert abs(recon - math.log(score / (1 - score))) < 1e-3


def test_run_batch_processes_many_in_one_dispatch(env, monkeypatch):
    """One claim_many, one stacked predict_proba and one explain_batch
    settle every task."""
    db_url, broker_url, names = env
    broker, db = Broker(broker_url), ResultsDB(db_url)
    rng = np.random.default_rng(9)
    for i in range(10):
        feats = _random_features(rng, names)
        db.create_pending(f"btx{i}", feats, f"c{i}")
        broker.send_task("xai_tasks.compute_shap", [f"btx{i}", feats, f"c{i}"])
    w = XaiWorker(broker_url=broker_url, database_url=db_url)
    calls = {"predict_proba": [], "explain_batch": []}
    for obj, name in ((w.model.scorer, "predict_proba"), (w.model, "explain_batch")):
        inner = getattr(obj, name)

        def spy(x, _inner=inner, _name=name):
            calls[_name].append(np.asarray(x).shape)
            return _inner(x)

        monkeypatch.setattr(obj, name, spy)
    success = metrics.xai_task_success.get()
    assert w.run_batch(max_batch=64) == 10
    assert calls == {"predict_proba": [(16, 30)], "explain_batch": [(16, 30)]}
    assert metrics.xai_task_success.get() == success + 10
    assert broker.depth() == 0
    for i in range(10):
        row = db.get(f"btx{i}")
        assert row["status"] == COMPLETED and len(row["shap_values"]) == 30
        assert row["prediction_score"] is not None


def test_run_batch_isolates_bad_task(env):
    """A malformed task in a claimed batch fails alone; the rest complete."""
    db_url, broker_url, names = env
    broker, db = Broker(broker_url), ResultsDB(db_url)
    good = {n: 0.2 for n in names}
    db.create_pending("gtx", good, "cg")
    broker.send_task("xai_tasks.compute_shap", ["gtx", good, "cg"])
    db.create_pending("badtx", {"wrong": 1.0}, "cb")
    broker.send_task("xai_tasks.compute_shap", ["badtx", {"wrong": 1.0}, "cb"], max_retries=0)
    w = XaiWorker(broker_url=broker_url, database_url=db_url)
    assert w.run_batch(max_batch=8) == 2
    assert db.get("gtx")["status"] == COMPLETED
    assert db.get("badtx")["status"] == FAILED
    assert "missing features" in db.get("badtx")["shap_values"]["error"]


def test_batch_and_single_paths_agree(env):
    """compute_shap_many gives the values run_once gives, with 3-, 4- and
    5-argument payloads alike."""
    db_url, broker_url, names = env
    broker, db = Broker(broker_url), ResultsDB(db_url)
    feats = _random_features(np.random.default_rng(3), names)
    payloads = {
        "stx": [feats, "c"],
        "mtx": [feats, "c", None],
        "ktx": [feats, "c", None, {"indices": [0, 1], "values": [9.0, 8.0]}],
    }
    for tx, rest in payloads.items():
        db.create_pending(tx, feats, "c")
        broker.send_task("xai_tasks.compute_shap", [tx, *rest])
    w = XaiWorker(broker_url=broker_url, database_url=db_url)
    before = metrics.xai_explain_consistency_failures.get()
    assert w.run_once() is True  # settles stx one by one
    assert w.run_batch(max_batch=8) == 2  # settles mtx and ktx batched
    rows = [db.get(tx) for tx in payloads]
    assert all(r["status"] == COMPLETED for r in rows)
    for r in rows[1:]:
        np.testing.assert_allclose(
            [r["shap_values"][n] for n in names],
            [rows[0]["shap_values"][n] for n in names], rtol=1e-6,
        )
        assert abs(r["prediction_score"] - rows[0]["prediction_score"]) < 1e-9
    # ktx's serve-time top-k disagrees with the backfill: counted, not failed
    assert metrics.xai_explain_consistency_failures.get() == before + 1


def test_two_workers_race_without_loss_or_corruption(env):
    """Two workers draining one broker concurrently: every task completes,
    nothing is claimed twice inside the visibility window."""
    db_url, broker_url, names = env
    broker, db = Broker(broker_url), ResultsDB(db_url)
    rng = np.random.default_rng(1)
    n = 60
    for i in range(n):
        feats = _random_features(rng, names)
        db.create_pending(f"rx{i}", feats, "c")
        broker.send_task("xai_tasks.compute_shap", [f"rx{i}", feats, "c"])
    workers = [
        XaiWorker(broker_url=broker_url, database_url=db_url, worker_id=f"w{j}")
        for j in range(2)
    ]
    handled = [0, 0]

    def drain(j):
        while True:
            k = workers[j].run_batch(max_batch=7)
            if not k:
                break
            handled[j] += k

    ts = [threading.Thread(target=drain, args=(j,)) for j in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in ts)
    assert sum(handled) == n  # nothing lost, nothing double-claimed
    assert broker.depth() == 0
    assert db.count(COMPLETED) == n


def test_entry_point_drains_and_stops_on_sigterm(env, monkeypatch):
    """``main()`` warms the ladder, drains the queue, and returns when
    SIGTERM sets the stop flag (the graceful drain)."""
    import signal

    db_url, broker_url, names = env
    monkeypatch.setenv("DATABASE_URL", db_url)
    monkeypatch.setenv("CELERY_BROKER_URL", broker_url)
    broker, db = Broker(broker_url), ResultsDB(db_url)
    feats = {n: 0.3 for n in names}
    db.create_pending("etx", feats, None)
    broker.send_task("xai_tasks.compute_shap", ["etx", feats, None])
    handlers = {}
    monkeypatch.setattr(signal, "signal", lambda sig, fn: handlers.__setitem__(sig, fn))
    t = threading.Thread(
        target=main, args=(["--metrics-port", "0", "--max-batch", "16",
                            "--poll-interval", "0.02"],), daemon=True,
    )
    t.start()
    deadline = time.monotonic() + 30
    while db.get("etx")["status"] != COMPLETED and time.monotonic() < deadline:
        time.sleep(0.02)
    while signal.SIGTERM not in handlers and time.monotonic() < deadline:
        time.sleep(0.01)
    handlers[signal.SIGTERM](signal.SIGTERM, None)
    t.join(timeout=30)
    assert not t.is_alive()
    assert db.get("etx")["status"] == COMPLETED
    assert broker.depth() == 0


def test_predict_stays_up_with_dead_broker(tmp_path, monkeypatch):
    """The broker wholly down (``fraud://`` with nothing listening):
    ``/predict`` still answers 200 with ``explanation_status: "Queue
    failed"`` (the reference's degradation contract, api/app.py:248-250)."""
    from fraud_detection_tpu_torch.service import netclient
    from fraud_detection_tpu_torch.service.app import create_app
    from fraud_detection_tpu_torch.service.http import TestClient

    monkeypatch.setenv("MODEL_PATH", os.path.join(ROOT, "models", "model.npz"))
    monkeypatch.setenv("MLFLOW_TRACKING_URI", f"file:{tmp_path}/mlruns")
    monkeypatch.setenv("LIFECYCLE_DB_URL", f"sqlite:///{tmp_path}/lifecycle.db")
    monkeypatch.setattr(netclient, "RETRIES", 1)  # the degraded answer, at once
    app = create_app(database_url=f"sqlite:///{tmp_path}/fraud.db",
                     broker_url="fraud://127.0.0.1:1", device="cpu")
    with TestClient(app) as client:
        r = client.post("/predict", json={"features": [0.1] * 30})
        assert r.status_code == 200
        assert r.json()["explanation_status"] == "Queue failed"
        health = client.get("/health")
        assert health.status_code == 503
        assert health.json()["checks"]["broker"] != "ok"


def test_worker_survives_store_outage_and_resumes(tmp_path, monkeypatch):
    """A store outage longer than the client's retry budget does not crash
    ``run_forever``: the worker backs off and consumes again when the store
    returns on the same port and data directory."""
    from fraud_detection_tpu_torch.service import netclient
    from fraud_detection_tpu_torch.service.netserver import StoreServer

    monkeypatch.setenv("MODEL_PATH", os.path.join(ROOT, "models", "model.npz"))
    monkeypatch.setenv("MLFLOW_TRACKING_URI", f"file:{tmp_path}/mlruns")
    monkeypatch.setenv("DEVICE", "cpu")
    monkeypatch.setattr(netclient, "RETRIES", 2)  # the outage outlives it quickly
    srv = StoreServer(str(tmp_path / "s"), port=0)
    srv.start()
    port = srv.port
    url = f"fraud://127.0.0.1:{port}"
    w = XaiWorker(broker_url=url, database_url=url, poll_interval=0.05)
    t = threading.Thread(target=w.run_forever, daemon=True)
    t.start()
    try:
        srv.stop()  # the outage: the client's retries run out
        time.sleep(1.5)  # several failed poll cycles
        assert t.is_alive(), "the worker crashed during the store outage"
        srv2 = StoreServer(str(tmp_path / "s"), host="127.0.0.1", port=port)
        srv2.start()
        try:
            db, q = ResultsDB(url), Broker(url)
            feats = {n: 0.1 for n in NAMES}
            db.create_pending("tx-after", feats, None)
            q.send_task("xai_tasks.compute_shap", ["tx-after", feats, None])
            deadline = time.monotonic() + 30
            while (db.get("tx-after") or {}).get("status") != COMPLETED \
                    and time.monotonic() < deadline:
                time.sleep(0.02)
            assert db.get("tx-after")["status"] == COMPLETED, \
                "the worker did not consume again after the store returned"
        finally:
            w.stop()
            t.join(timeout=10)
            srv2.stop()
    finally:
        if t.is_alive():
            w.stop()
            t.join(timeout=10)
