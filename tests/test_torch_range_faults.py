"""The range's fault points on the port, on the CPU.

- The :class:`FaultPlan` machinery (disarmed no-ops, budgets and the firing
  log, patch / error / call, exclusive arming, ``ReplicaKilled`` escaping
  ``except Exception``), as the JAX package's ``tests/test_range.py`` holds
  it.
- The task queue's four points (``taskq.countdown``,
  ``taskq.visibility_timeout``, ``taskq.claim``, ``taskq.ack``): a collapsed
  visibility window redelivers at once, a kill at ``taskq.ack`` leaves the
  task ``CLAIMED``, a kill at ``taskq.claim`` fires after the claim
  committed (the task redelivers), a stretched countdown delays delivery;
  the delivery-anomaly counters and their series, as JAX's
  ``test_taskq_redelivery_and_expired_claim_metrics`` and
  ``test_taskq_metrics_exported_by_registry`` hold them.
- The micro-batcher's two: an ``error`` at ``microbatch.flush`` fails that
  flush's waiters and the next flush serves; a ``stall`` adds at least its
  seconds to that flush. ``ledger.update`` receives ``slot``, ``batch`` and
  ``placement`` once a ledger flush, after the entity columns are filled;
  on the int8 wire a mutation of ``slot.f32`` there reaches the device rows
  (the armed re-encode); disarmed, the flush encodes once.
- The store's poison guard and the served app's 503 + ``Retry-After`` on a
  store outage, word for word the JAX app's body.
"""

import asyncio
import os
import time

import numpy as np
import pytest
import torch

from fraud_detection_tpu_torch.lifecycle.store import LifecycleStore
from fraud_detection_tpu_torch.models.logistic import FraudLogisticModel
from fraud_detection_tpu_torch.monitor.baseline import build_baseline_profile, save_profile
from fraud_detection_tpu_torch.ops.logistic import LogisticParams
from fraud_detection_tpu_torch.ops.scaler import scaler_fit
from fraud_detection_tpu_torch.ops.scorer import BatchScorer
from fraud_detection_tpu_torch.range import faults
from fraud_detection_tpu_torch.range.scenarios import KAGGLE, build_ledger_model
from fraud_detection_tpu_torch.service.microbatch import MicroBatcher
from fraud_detection_tpu_torch.service.taskq import CLAIMED, QUEUED, SqliteBroker

torch.set_num_threads(1)

D = 30


# -- the plan machinery -------------------------------------------------------

def test_fire_is_noop_when_disarmed():
    faults.fire("nonexistent.point", anything=1)
    assert faults.patched("nonexistent.point", 42) == 42
    assert faults.active_plan() is None


def test_fault_plan_kill_budget_and_log():
    plan = faults.FaultPlan().kill("p.kill", times=2)
    with plan.armed():
        with pytest.raises(faults.ReplicaKilled):
            faults.fire("p.kill")
        with pytest.raises(faults.ReplicaKilled):
            faults.fire("p.kill")
        faults.fire("p.kill")  # budget exhausted: no-op
    assert plan.fired("p.kill") == 2
    assert faults.active_plan() is None


def test_fault_plan_patch_error_call():
    seen = {}
    plan = (
        faults.FaultPlan()
        .patch("p.v", 0.0, times=1)
        .error("p.err", lambda: RuntimeError("boom"), times=1)
        .call("p.cb", lambda **kw: seen.update(kw))
    )
    with plan.armed():
        assert faults.patched("p.v", 60.0) == 0.0
        assert faults.patched("p.v", 60.0) == 60.0  # budget spent
        with pytest.raises(RuntimeError):
            faults.fire("p.err")
        faults.fire("p.err")  # spent
        faults.fire("p.cb", x=7)
    assert seen == {"x": 7}


def test_arming_is_exclusive():
    plan = faults.FaultPlan()
    with plan.armed():
        with pytest.raises(RuntimeError):
            with faults.FaultPlan().armed():
                pass
    assert faults.active_plan() is None


def test_replica_killed_escapes_except_exception():
    try:
        try:
            raise faults.ReplicaKilled("x")
        except Exception:  # a worker's retry ladder
            pytest.fail("ReplicaKilled was caught by except Exception")
    except faults.ReplicaKilled:
        pass


# -- the task queue's points ----------------------------------------------------

def test_taskq_fault_points(tmp_path):
    broker = SqliteBroker(f"sqlite:///{tmp_path}/q2.db")
    plan = (
        faults.FaultPlan()
        .patch("taskq.visibility_timeout", 0.0, times=1)
        .kill("taskq.ack")
    )
    with plan.armed():
        broker.send_task("t.x", [])
        first = broker.claim("w1")  # collapsed window
        dup = broker.claim("w2")  # redelivered immediately
        assert dup is not None and dup.id == first.id
        with pytest.raises(faults.ReplicaKilled):
            broker.ack(dup.id)  # died pre-ack → will be redelivered
    assert broker.get_status(first.id) == CLAIMED  # never acked
    assert plan.fired("taskq.visibility_timeout") == 1 and plan.fired("taskq.ack") == 1
    broker.close()


def test_taskq_claim_fires_after_the_claim_commits(tmp_path):
    """``taskq.claim`` fires once a claimed task with its id and name; a
    kill there (a worker dying between the claim and the run) leaves the
    task claimed, and the lapsed window redelivers it."""
    broker = SqliteBroker(f"sqlite:///{tmp_path}/q3.db")
    seen = []
    ids = [broker.send_task("t.a", [1]), broker.send_task("t.b", [2])]
    with faults.FaultPlan().call("taskq.claim", lambda **kw: seen.append(kw)).armed():
        got = broker.claim_many("w1", 2, visibility_timeout=60.0)
    assert [t.id for t in got] == ids
    assert seen == [{"task_id": ids[0], "name": "t.a"}, {"task_id": ids[1], "name": "t.b"}]
    tid = broker.send_task("t.c", [3])
    with faults.FaultPlan().kill("taskq.claim").armed():
        with pytest.raises(faults.ReplicaKilled):
            broker.claim("w2", visibility_timeout=0.0)
    assert broker.get_status(tid) == CLAIMED
    again = broker.claim("w3", visibility_timeout=60.0)
    assert again is not None and again.id == tid and broker.redeliveries == 1
    broker.close()


def test_taskq_countdown_patch_delays_delivery(tmp_path):
    broker = SqliteBroker(f"sqlite:///{tmp_path}/q4.db")
    plan = faults.FaultPlan().patch("taskq.countdown", 60.0, times=1)
    with plan.armed():
        late = broker.send_task("t.late", [])
        now = broker.send_task("t.now", [])  # the budget is spent
    assert plan.fired("taskq.countdown") == 1
    got = broker.claim("w1")
    assert got is not None and got.id == now
    assert broker.claim("w1") is None and broker.get_status(late) == QUEUED
    broker.close()


def test_taskq_redelivery_and_expired_claim_metrics(tmp_path):
    """The broker's delivery-anomaly counts and their mirror in the
    process's series: an expired claim is a redelivery, a nack-retry a
    redelivery only, a first delivery neither."""
    from fraud_detection_tpu_torch.service import metrics

    broker = SqliteBroker(f"sqlite:///{tmp_path}/q5.db")
    red0 = metrics.taskq_redeliveries.get()
    exp0 = metrics.taskq_expired_claims.get()
    broker.send_task("t.work", [1])
    t1 = broker.claim("w1", visibility_timeout=0.0)
    assert t1 is not None
    t2 = broker.claim("w2", visibility_timeout=60.0)
    assert t2 is not None and t2.id == t1.id
    assert (broker.expired_claims, broker.redeliveries) == (1, 1)
    assert broker.nack(t2.id, countdown=0.0, claimed_by="w2")
    t3 = broker.claim("w3", visibility_timeout=60.0)
    assert t3 is not None and t3.attempts == 1
    assert (broker.expired_claims, broker.redeliveries) == (1, 2)
    assert metrics.taskq_expired_claims.get() - exp0 == 1
    assert metrics.taskq_redeliveries.get() - red0 == 2
    broker.send_task("t.other", [2])
    broker.claim("w1", visibility_timeout=60.0)
    assert broker.redeliveries == 2
    broker.close()


def test_taskq_metrics_exported_by_registry():
    from fraud_detection_tpu_torch.service import metrics

    text = metrics.render().decode()
    assert "taskq_redeliveries_total" in text
    assert "taskq_expired_claims_total" in text


# -- the micro-batcher's points -------------------------------------------------

def _scorer(seed: int = 3) -> BatchScorer:
    rng = np.random.default_rng(seed)
    params = LogisticParams(coef=torch.from_numpy(rng.standard_normal(D).astype(np.float32)),
                            intercept=torch.tensor(-1.0))
    return BatchScorer(params, None, device="cpu")


def test_microbatch_flush_error_fails_that_flush_and_the_next_serves():
    async def run():
        mb = MicroBatcher(scorer=_scorer(), max_batch=8, max_wait_ms=50.0,
                          telemetry=False)
        await mb.start()
        try:
            rows = np.random.default_rng(0).standard_normal((4, D)).astype(np.float32)
            plan = faults.FaultPlan().error(
                "microbatch.flush", lambda: RuntimeError("injected flush failure"), times=1)
            with plan.armed():
                out = await asyncio.gather(*(mb.score(r) for r in rows),
                                           return_exceptions=True)
            assert plan.fired("microbatch.flush") == 1
            assert all(isinstance(o, RuntimeError) and "injected" in str(o) for o in out)
            ok = await asyncio.gather(*(mb.score(r) for r in rows))
            np.testing.assert_allclose(ok, mb.scorer.predict_proba(rows), rtol=0, atol=1e-7)
        finally:
            await mb.stop()

    asyncio.run(run())


def test_microbatch_flush_stall_adds_its_seconds():
    async def run():
        mb = MicroBatcher(scorer=_scorer(), max_batch=8, max_wait_ms=0.0,
                          telemetry=False)
        await mb.start()
        row = np.zeros(D, np.float32)
        try:
            await mb.score(row)
            with faults.FaultPlan().stall("microbatch.flush", 0.25, times=1).armed():
                t0 = time.perf_counter()
                await mb.score(row)
                stalled = time.perf_counter() - t0
            assert stalled >= 0.25
        finally:
            await mb.stop()

    asyncio.run(run())


@pytest.fixture(scope="module")
def ledger_models():
    """A small widened champion on each wire (float32, int8)."""
    out = {}
    before = os.environ.get("SCORER_WIRE")
    for wire in ("float32", "int8"):
        os.environ["SCORER_WIRE"] = wire
        try:
            out[wire] = build_ledger_model(seed=7, n_base=600, device="cpu")
        finally:
            if before is None:
                os.environ.pop("SCORER_WIRE", None)
            else:
                os.environ["SCORER_WIRE"] = before
    assert out["int8"][0].model.scorer.io_dtype == "int8"
    return out


def _ledger_flush(built, rows, ents, plan=None, capture=None):
    """One ``_flush_device`` of a ledger model over ``rows`` (entity ids or
    None), armed with ``plan``; returns the scores. ``capture`` collects
    every host buffer the flush copies to the device."""
    from fraud_detection_tpu_torch.range.scenarios import _watchtower

    rm, spec, state, t0 = built
    scorer = rm.model.scorer
    wt = _watchtower(rm.profile, device="cpu")
    wt.drift.bind_ledger(spec, state)
    mb = MicroBatcher(scorer=scorer, watchtower=wt, telemetry=False, max_batch=64)
    items = []
    for i, (r, e) in enumerate(zip(rows, ents)):
        ent = None if e is None else (*spec.row_keys(e), t0 + 1.0 + i)
        items.append((r, None, None, ent))
    to_device = scorer.to_device
    if capture is not None:
        def spy(host):
            capture.append(np.array(host.numpy() if isinstance(host, torch.Tensor) else host))
            return to_device(host)
        scorer.to_device = spy
    try:
        if plan is None:
            out = mb._flush_device(scorer, mb._fused_target(scorer), items, False)
        else:
            with plan.armed():
                out = mb._flush_device(scorer, mb._fused_target(scorer), items, False)
        scores = np.array(out[0])
        scorer.staging.release(out[-1])
    finally:
        scorer.to_device = to_device
        wt.close()
    return scores, items


def test_ledger_update_receives_slot_batch_and_placement(ledger_models):
    rows = np.abs(np.random.default_rng(1).standard_normal((12, D))).astype(np.float32)
    ents = ["mule-1", None, "card-3"] * 4
    seen = []

    def record(slot=None, batch=None, placement=None, **kw):
        assert not kw
        # the entity columns are filled before the fire
        seen.append((slot, batch, placement, slot.lf[:12].copy(), slot.lh[:12].copy()))

    plan = faults.FaultPlan().call("ledger.update", record)
    _, items = _ledger_flush(ledger_models["float32"], rows, ents, plan)
    assert plan.fired("ledger.update") == 1 and len(seen) == 1
    slot, batch, placement, lf, lh = seen[0]
    assert batch is items and placement is None
    spec = ledger_models["float32"][1]
    want = [0 if e is None else spec.row_keys(e)[1] for e in ents]
    assert lf.tolist() == want
    assert lh.tolist() == [0.0 if e is None else 1.0 for e in ents]
    np.testing.assert_array_equal(slot.f32[:12], rows)


def test_int8_wire_mutation_reaches_the_device_rows(ledger_models):
    """The armed re-encode: on the int8 wire the rows were encoded before
    the ledger staged, so a mutation of ``slot.f32`` at ``ledger.update``
    reaches the device codes only through the re-encode, and changes the
    score of the mutated row alone."""
    built = ledger_models["int8"]
    rows = np.abs(np.random.default_rng(2).standard_normal((8, D))).astype(np.float32)
    ents = ["mule-1"] * 8

    def poison(slot=None, **_):
        slot.f32[3, 5] = 1e6  # far past the quantizer's range

    clean_dev, armed_dev, noop_dev = [], [], []
    clean, _ = _ledger_flush(built, rows, ents, capture=clean_dev)
    armed, _ = _ledger_flush(built, rows, ents, faults.FaultPlan().call("ledger.update", poison),
                             capture=armed_dev)
    noop, _ = _ledger_flush(built, rows, ents, faults.FaultPlan().call("ledger.update",
                                                                       lambda **_: None),
                            capture=noop_dev)

    def codes(bufs):
        (x,) = [b for b in bufs if b.dtype == np.int8]
        return x

    c, a, n = codes(clean_dev), codes(armed_dev), codes(noop_dev)
    assert a[3, 5] == 127 and c[3, 5] != 127
    diff = np.argwhere(a != c)
    assert diff.tolist() == [[3, 5]]
    np.testing.assert_array_equal(n, c)  # the re-encode of unchanged rows
    assert armed[3] != clean[3]
    np.testing.assert_array_equal(np.delete(armed, 3), np.delete(clean, 3))


def test_disarmed_ledger_flush_encodes_once(ledger_models):
    """Disarmed, the ledger flush encodes the rows once (in staging); with a
    plan armed it encodes them again after ``ledger.update``."""
    built = ledger_models["int8"]
    scorer = built[0].model.scorer
    rows = np.zeros((4, D), np.float32)
    calls = []
    enc = scorer._encode_slot

    def counting(slot):
        calls.append(1)
        return enc(slot)

    scorer._encode_slot = counting
    try:
        _ledger_flush(built, rows, ["a", "b", None, "c"])
        disarmed = len(calls)
        _ledger_flush(built, rows, ["a", "b", None, "c"], faults.FaultPlan())
        armed = len(calls) - disarmed
    finally:
        del scorer._encode_slot
    assert (disarmed, armed) == (1, 2)


# -- the store's poison guard and the app's 503s ----------------------------------

def test_store_rejects_poisoned_feedback(tmp_path):
    store = LifecycleStore(f"sqlite:///{tmp_path}/lc.db")
    x = np.zeros((4, D), np.float32)
    s = np.full(4, 0.5, np.float32)
    y = np.array([0, 1, 0, 1])
    with pytest.raises(ValueError, match="finite"):
        store.add_feedback(np.full((4, D), np.nan, np.float32), s, y)
    with pytest.raises(ValueError, match="probabilities"):
        store.add_feedback(x, np.full(4, np.nan, np.float32), y)
    with pytest.raises(ValueError, match="probabilities"):
        store.add_feedback(x, np.full(4, 1.5, np.float32), y)
    with pytest.raises(ValueError, match="labels"):
        store.add_feedback(x, s, np.array([0, 1, 2, 1]))
    assert store.feedback_counts()["seen"] == 0
    store.add_feedback(x, s, y)
    assert store.feedback_counts()["seen"] == 4
    store.close()


@pytest.fixture()
def served_app(tmp_path, monkeypatch):
    """The port's app over a real model, its monitor profile and a sqlite
    lifecycle store (beside the broker)."""
    from fraud_detection_tpu_torch.service.app import create_app
    from fraud_detection_tpu_torch.service.http import TestClient

    rng = np.random.default_rng(42)
    params = LogisticParams(coef=torch.from_numpy(rng.standard_normal(D).astype(np.float32)),
                            intercept=torch.tensor(-1.0))
    x = rng.standard_normal((600, D)).astype(np.float32)
    model_dir = str(tmp_path / "models")
    model = FraudLogisticModel(params, scaler_fit(x), KAGGLE, device="cpu")
    model.save(model_dir, joblib_too=False)
    save_profile(model_dir, build_baseline_profile(
        x, model.scorer.predict_proba(x), feature_names=KAGGLE, device="cpu"))
    monkeypatch.setenv("MODEL_PATH", os.path.join(model_dir, "logistic_model.joblib"))
    monkeypatch.setenv("MLFLOW_TRACKING_URI", f"file:{tmp_path}/mlruns")
    monkeypatch.setenv("LIFECYCLE_RELOAD_INTERVAL_S", "0")
    monkeypatch.delenv("LIFECYCLE_DB_URL", raising=False)
    client = TestClient(create_app(database_url=f"sqlite:///{tmp_path}/fraud.db",
                                   broker_url=f"sqlite:///{tmp_path}/taskq.db", device="cpu"))
    yield client
    client.close()


def test_lifecycle_status_503_with_retry_after_on_store_stall(served_app):
    from fraud_detection_tpu_torch.service.errors import StoreError

    client = served_app
    assert client.get("/lifecycle/status").status_code == 200
    plan = faults.FaultPlan().error(
        "lifecycle.store.get_state",
        lambda: StoreError("get_state failed after 8 attempts: stalled"),
    )
    with plan.armed():
        r = client.get("/lifecycle/status")
    assert r.status_code == 503
    assert r.headers.get("retry-after") == "10"
    assert r.json() == {"error": "lifecycle status temporarily unavailable — store outage",
                        "detail": "get_state failed after 8 attempts: stalled"}
    assert client.get("/lifecycle/status").status_code == 200


def test_monitor_feedback_rejects_nonfinite_features_at_edge(served_app):
    r = served_app.post(
        "/monitor/feedback",
        json={"features": [[float("nan")] * D], "scores": [0.5], "labels": [1]},
    )
    assert r.status_code == 422
    assert "finite" in r.json()["detail"]


def test_monitor_feedback_503_with_retry_after_on_store_outage(served_app):
    from fraud_detection_tpu_torch.service.errors import DatabaseError

    client = served_app
    payload = {"features": [[0.1] * D] * 4, "scores": [0.5] * 4, "labels": [0, 1, 0, 1]}
    assert client.post("/monitor/feedback", json=payload).status_code == 202
    plan = faults.FaultPlan().error(
        "lifecycle.store.add_feedback",
        lambda: DatabaseError("add_feedback failed after 8 attempts"),
    )
    with plan.armed():
        r = client.post("/monitor/feedback", json=payload)
    assert r.status_code == 503
    assert r.headers.get("retry-after") == "10"
    assert "store outage" in r.json()["error"]
    r = client.post("/monitor/feedback", json=payload)
    assert r.status_code == 202 and r.json()["persisted"] is True
