"""The slice as a whole: the JAX package's app and the port's app on one
model directory (the committed flagship artifact plus a drift baseline),
with ``SCORER_EXPLAIN=topk``, answering the same ``/predict`` rows — and
the port's micro-batcher paths (fused, split, narrow return wires,
bounded admission) on their own."""

import asyncio
import os
import shutil

import numpy as np
import pytest
import torch

from fraud_detection_tpu.models.logistic import FraudLogisticModel as JaxModel
from fraud_detection_tpu.monitor.baseline import build_baseline_profile, save_profile
from fraud_detection_tpu.service.app import create_app as jax_create_app
from fraud_detection_tpu.service.http import TestClient as JaxClient
from fraud_detection_tpu_torch.models import FraudLogisticModel
from fraud_detection_tpu_torch.monitor.baseline import load_profile
from fraud_detection_tpu_torch.monitor.watchtower import Watchtower
from fraud_detection_tpu_torch.service import metrics
from fraud_detection_tpu_torch.service.app import create_app
from fraud_detection_tpu_torch.service.http import TestClient
from fraud_detection_tpu_torch.service.microbatch import AdmissionFull, MicroBatcher

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_ROWS = 24


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """models/ plus a monitor_profile.npz built from 2000 real rows."""
    d = str(tmp_path_factory.mktemp("served") / "models")
    shutil.copytree(os.path.join(ROOT, "models"), d)
    data = np.loadtxt(
        os.path.join(ROOT, "data", "creditcard.csv"), delimiter=",",
        skiprows=1, max_rows=2000, dtype=np.float32,
    )
    x = data[:, :30]
    m = JaxModel.load(d)
    scores = np.asarray(m.scorer.predict_proba(x))
    save_profile(d, build_baseline_profile(x, scores, feature_names=m.feature_names))
    return d, x


@pytest.fixture(autouse=True)
def store_urls(tmp_path, monkeypatch):
    """Every app of this module opens its results DB and broker in
    ``tmp_path`` (the defaults would create files in the working
    directory), and an empty tracking store there, so it serves
    ``MODEL_PATH``'s directory, never a registered ``@prod``."""
    monkeypatch.setenv("MLFLOW_TRACKING_URI", f"file:{tmp_path}/mlruns")
    monkeypatch.setenv("DATABASE_URL", f"sqlite:///{tmp_path}/port_fraud.db")
    monkeypatch.setenv("CELERY_BROKER_URL", f"sqlite:///{tmp_path}/port_taskq.db")


@pytest.fixture()
def serving_env(model_dir, tmp_path, monkeypatch):
    d, x = model_dir
    monkeypatch.setenv("MODEL_PATH", os.path.join(d, "logistic_model.joblib"))
    monkeypatch.setenv("MLFLOW_TRACKING_URI", f"file:{tmp_path}/mlruns")
    monkeypatch.setenv("SCORER_EXPLAIN", "topk")
    monkeypatch.setenv("SCORER_MAX_BATCH", "64")  # a short warm-up ladder
    monkeypatch.setenv("DEVICE", "cpu")
    return d, x


def test_two_apps_answer_predict_alike(serving_env, tmp_path):
    """Scores within 1e-6 and attributions within 1e-6 (f32 folds and sums
    in different orders), equal reason-code features, the same 422, and
    equal /monitor/status row counts."""
    d, x = serving_env
    jax_app = jax_create_app(
        database_url=f"sqlite:///{tmp_path}/fraud.db",
        broker_url=f"sqlite:///{tmp_path}/taskq.db",
    )
    with JaxClient(jax_app) as jc, TestClient(create_app()) as tc:
        for i in range(N_ROWS):
            body = {"features": x[i].tolist()}
            jr, tr = jc.post("/predict", json=body), tc.post("/predict", json=body)
            assert jr.status_code == tr.status_code == 200
            jb, tb = jr.json(), tr.json()
            assert set(tb) == set(jb)
            assert tb["prediction"] == jb["prediction"]
            assert tb["score"] == pytest.approx(jb["score"], abs=1e-6)
            assert [r["feature"] for r in tb["reason_codes"]] == [
                r["feature"] for r in jb["reason_codes"]
            ]
            np.testing.assert_allclose(
                [r["attribution"] for r in tb["reason_codes"]],
                [r["attribution"] for r in jb["reason_codes"]],
                rtol=0, atol=1e-6,
            )
            assert tb["explanation_status"] == jb["explanation_status"] == "queued"
        by_name = dict(zip(JaxModel.load(d).feature_names, x[0].tolist()))
        jr = jc.post("/predict", json={"features": by_name})
        tr = tc.post("/predict", json={"features": by_name})
        assert tr.json()["score"] == pytest.approx(jr.json()["score"], abs=1e-6)
        for bad in ({"features": [0.1] * 7}, {"nope": 1}, {"features": "x"},
                    {"features": [0.1] * 30, "entity_id": True}):
            jr, tr = jc.post("/predict", json=bad), tc.post("/predict", json=bad)
            assert jr.status_code == tr.status_code == 422
            assert tr.json() == jr.json()
        jm, tm = jc.get("/monitor/status").json(), tc.get("/monitor/status").json()
        assert tm["drift"]["rows_seen"] == jm["drift"]["rows_seen"] == N_ROWS + 1
        assert tm["drift"]["window_rows"] == pytest.approx(
            jm["drift"]["window_rows"], rel=1e-6
        )
        assert tm["status"] == jm["status"] == "warming"
        th, jh = tc.get("/health"), jc.get("/health")
        assert th.status_code == jh.status_code == 200
        assert th.json()["checks"] == jh.json()["checks"] == {
            "model": "ok", "database": "ok", "broker": "ok",
        }
        assert th.json()["status"] == "healthy"
        assert tc.get("/status").json() == {"status": "UP"}
        text = tc.get("/metrics").text
        assert 'scorer_flushes_total{path="fused",shard="0"}' in text
        assert "predictions_submitted_total" in text
        assert "# TYPE api_inference_duration_seconds histogram" in text


@pytest.fixture(scope="module")
def gbt_dir(tmp_path_factory, model_dir):
    """A GBT forest fitted by the JAX package on scaled CSV rows (scaler
    folded, 64-row background) plus a drift baseline beside it."""
    from fraud_detection_tpu.models.gbt import FraudGBTModel as JaxGBT
    from fraud_detection_tpu.ops.gbt import GBTConfig, gbt_fit
    from fraud_detection_tpu.ops.scaler import scaler_fit, scaler_transform

    _, x = model_dir
    scaler = scaler_fit(x)
    xs = np.asarray(scaler_transform(scaler, x))
    w = np.random.default_rng(1).standard_normal(30).astype(np.float32)
    y = (xs @ w > 1.0).astype(np.int32)
    names = JaxModel.load(os.path.join(ROOT, "models")).feature_names
    d = str(tmp_path_factory.mktemp("served_gbt") / "models")
    m = JaxGBT(gbt_fit(xs, y, GBTConfig(n_trees=10, max_depth=4, n_bins=32)), names,
               scaler=scaler, background=x[:64])
    m.save(d)
    scores = np.asarray(m.scorer.predict_proba(x)).reshape(-1)
    save_profile(d, build_baseline_profile(x, scores, feature_names=names))
    return d, x


def test_two_apps_answer_predict_alike_on_a_gbt_forest(gbt_dir, tmp_path, monkeypatch):
    """One GBT directory served by both apps with SCORER_EXPLAIN=topk:
    scores within 1e-6, equal reason-code features (TreeSHAP; attributions
    within the kernel tolerance), the fused flush, and the served family."""
    d, x = gbt_dir
    monkeypatch.setenv("MODEL_PATH", os.path.join(d, "model.npz"))
    monkeypatch.setenv("MLFLOW_TRACKING_URI", f"file:{tmp_path}/mlruns")
    monkeypatch.setenv("SCORER_EXPLAIN", "topk")
    monkeypatch.setenv("SCORER_MAX_BATCH", "64")
    monkeypatch.setenv("DEVICE", "cpu")
    jax_app = jax_create_app(
        database_url=f"sqlite:///{tmp_path}/fraud.db",
        broker_url=f"sqlite:///{tmp_path}/taskq.db",
    )
    with JaxClient(jax_app) as jc, TestClient(create_app()) as tc:
        for i in range(N_ROWS):
            body = {"features": x[100 + i].tolist()}
            jr, tr = jc.post("/predict", json=body), tc.post("/predict", json=body)
            assert jr.status_code == tr.status_code == 200
            jb, tb = jr.json(), tr.json()
            assert tb["score"] == pytest.approx(jb["score"], abs=1e-6)
            assert tb["prediction"] == jb["prediction"]
            assert [r["feature"] for r in tb["reason_codes"]] == [
                r["feature"] for r in jb["reason_codes"]
            ]
            np.testing.assert_allclose(
                [r["attribution"] for r in tb["reason_codes"]],
                [r["attribution"] for r in jb["reason_codes"]], rtol=1e-4, atol=2e-5,
            )
        assert tc.get("/monitor/status").json()["drift"]["rows_seen"] == N_ROWS
        text = tc.get("/metrics").text
        assert 'scorer_served_family{family="gbt"} 1.0' in text
        assert 'scorer_flushes_total{path="fused",shard="0"}' in text


def test_app_without_profile_serves_unmonitored(model_dir, tmp_path, monkeypatch):
    d, x = model_dir
    bare = str(tmp_path / "bare")
    os.makedirs(bare)
    for f in ("model.npz", "feature_names.json"):
        shutil.copy(os.path.join(d, f), bare)
    monkeypatch.setenv("MODEL_PATH", os.path.join(bare, "model.npz"))
    monkeypatch.setenv("SCORER_MAX_BATCH", "16")
    monkeypatch.delenv("SCORER_EXPLAIN", raising=False)
    with TestClient(create_app(device="cpu")) as tc:
        r = tc.post("/predict", json={"features": x[0].tolist()})
        assert r.status_code == 200 and r.json()["reason_codes"] is None
        assert tc.get("/monitor/status").json()["enabled"] is False


def test_app_with_no_model_is_degraded(tmp_path, monkeypatch):
    monkeypatch.setenv("MODEL_PATH", str(tmp_path / "none" / "model.npz"))
    with TestClient(create_app(device="cpu")) as tc:
        assert tc.post("/predict", json={"features": [0.0] * 30}).status_code == 503
        assert tc.get("/health").json()["checks"]["model"] == "unavailable"


def _run_batcher(batcher, rows, explain=False):
    async def go():
        await batcher.start()
        try:
            fn = batcher.score_ex if explain else batcher.score
            return await asyncio.gather(*(fn(r) for r in rows))
        finally:
            await batcher.stop()

    return asyncio.run(go())


@pytest.mark.parametrize("return_wire, atol", [("float16", 1e-3), ("uint8", 0.5 / 255)])
def test_fused_split_and_narrow_wires_agree(model_dir, return_wire, atol):
    """The fused and the split flush give bitwise-equal f32 scores (one
    score body); narrow return wires decode within their lattice step."""
    d, x = model_dir
    model = FraudLogisticModel.load(d, device="cpu")
    profile = load_profile(d)
    rows = [x[i] for i in range(40)]
    out = {}
    for name, kw in (("fused", dict(fused=True)), ("split", dict(fused=False)),
                     ("narrow", dict(fused=True, return_wire=return_wire))):
        wt = Watchtower(profile, device="cpu")
        try:
            b = MicroBatcher(model.scorer, max_batch=16, max_wait_ms=5.0,
                             watchtower=wt, explain=False, **kw)
            out[name] = np.asarray(_run_batcher(b, rows))
            assert wt.drain()
            assert wt.drift.rows_seen == len(rows)
        finally:
            wt.close()
    np.testing.assert_array_equal(out["fused"], out["split"])
    np.testing.assert_allclose(out["narrow"], out["fused"], rtol=0, atol=atol)
    assert metrics.scorer_flushes.get("split", "0") > 0


def test_score_ex_returns_reason_codes(model_dir):
    d, x = model_dir
    model = FraudLogisticModel.load(d, device="cpu")
    wt = Watchtower(load_profile(d), device="cpu")
    try:
        b = MicroBatcher(model.scorer, max_batch=8, watchtower=wt,
                         explain=True, explain_k=4)
        res = _run_batcher(b, [x[0], x[1]], explain=True)
    finally:
        wt.close()
    phi, _ = model.explain_batch(x[:2])
    for (score, (idx, vals)), p in zip(res, phi):
        assert len(idx) == 4 and vals == sorted(vals, reverse=True)
        np.testing.assert_allclose(vals, p[idx], rtol=0, atol=1e-6)


def test_admission_bound_sheds():
    model = FraudLogisticModel.load(os.path.join(ROOT, "models"), device="cpu")
    b = MicroBatcher(model.scorer, max_batch=8, admit_max_rows=2)
    b._admit(2)
    with pytest.raises(AdmissionFull) as e:
        b._admit(1)
    assert e.value.queued_rows == 2 and e.value.retry_after_s > 0


def test_metrics_exposition_format():
    text = metrics.render().decode()
    assert "# TYPE scorer_microbatch_size histogram" in text
    assert 'scorer_microbatch_size_bucket{le="+Inf"}' in text
    assert "# TYPE predictions_submitted_total counter" in text
    c = metrics.Counter("test_torch_port_counter", "a test counter", ["k"])
    c.labels('a"b').inc(2)
    assert 'test_torch_port_counter_total{k="a\\"b"} 2.0' in metrics.render().decode()
    with pytest.raises(ValueError):
        c.labels("x").inc(-1)
