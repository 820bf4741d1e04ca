"""The explain half of the service, the port against the JAX package: the
same rows through the JAX app + JAX worker and through the port's app +
port worker (on the CPU) give the same ``GET /explain/{id}`` bodies, on the
logistic flagship and on a small GBT forest; a JAX app's tasks drained by a
port worker, and a port app's by a JAX worker, on one shared sqlite pair;
and ``POST /monitor/feedback`` — the JAX app's 422s word for word, 409
without a profile, 202 with the calibration window moved and the drift
window not."""

import os
import shutil

import numpy as np
import pytest
import torch

from fraud_detection_tpu.models.logistic import FraudLogisticModel as JaxModel
from fraud_detection_tpu.monitor.baseline import build_baseline_profile, save_profile
from fraud_detection_tpu.service.app import create_app as jax_create_app
from fraud_detection_tpu.service.http import TestClient as JaxClient
from fraud_detection_tpu.service.worker import XaiWorker as JaxWorker
from fraud_detection_tpu_torch.service.app import create_app
from fraud_detection_tpu_torch.service.http import TestClient
from fraud_detection_tpu_torch.service.worker import XaiWorker

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_ROWS = 24
#: (family) → tolerances of φ / prediction_score and of expected_value
TOLS = {
    "logistic": (dict(rtol=0, atol=1e-6), dict(rtol=0, atol=1e-5)),
    "gbt": (dict(rtol=1e-4, atol=2e-5), dict(rtol=1e-4, atol=2e-5)),
}


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """One environment for the module: explain on, a short warm-up ladder,
    the CPU, and the tracking store and default DB URLs in a temp dir."""
    tmp = tmp_path_factory.mktemp("explain_env")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MLFLOW_TRACKING_URI", f"file:{tmp}/mlruns")
        mp.setenv("SCORER_EXPLAIN", "topk")
        mp.setenv("SCORER_MAX_BATCH", "64")
        mp.setenv("DEVICE", "cpu")
        mp.setenv("DATABASE_URL", f"sqlite:///{tmp}/default_fraud.db")
        mp.setenv("CELERY_BROKER_URL", f"sqlite:///{tmp}/default_taskq.db")
        yield mp


@pytest.fixture(scope="module")
def served(tmp_path_factory, env):
    """family → (model dir with a drift baseline, rows): the committed
    flagship, and a GBT forest fitted by the JAX package on scaled CSV rows
    (scaler folded, 64-row background)."""
    from fraud_detection_tpu.models.gbt import FraudGBTModel as JaxGBT
    from fraud_detection_tpu.ops.gbt import GBTConfig, gbt_fit
    from fraud_detection_tpu.ops.scaler import scaler_fit, scaler_transform

    data = np.loadtxt(
        os.path.join(ROOT, "data", "creditcard.csv"), delimiter=",",
        skiprows=1, max_rows=2000, dtype=np.float32,
    )
    x = data[:, :30]
    lin = str(tmp_path_factory.mktemp("explain_lin") / "models")
    shutil.copytree(os.path.join(ROOT, "models"), lin)
    m = JaxModel.load(lin)
    names = m.feature_names
    save_profile(lin, build_baseline_profile(
        x, np.asarray(m.scorer.predict_proba(x)), feature_names=names))

    scaler = scaler_fit(x)
    xs = np.asarray(scaler_transform(scaler, x))
    w = np.random.default_rng(1).standard_normal(30).astype(np.float32)
    y = (xs @ w > 1.0).astype(np.int32)
    gbt = str(tmp_path_factory.mktemp("explain_gbt") / "models")
    g = JaxGBT(gbt_fit(xs, y, GBTConfig(n_trees=10, max_depth=4, n_bins=32)), names,
               scaler=scaler, background=x[:64])
    g.save(gbt)
    save_profile(gbt, build_baseline_profile(
        x, np.asarray(g.scorer.predict_proba(x)).reshape(-1), feature_names=names))
    return {"logistic": (lin, x[:N_ROWS]), "gbt": (gbt, x[100:100 + N_ROWS])}


_RUNS: dict = {}


def _run(app_pkg, worker_pkg, family, served, env, work):
    """Send the family's rows through ``app_pkg``'s /predict, drain the
    queue with ``worker_pkg``'s worker (plus one poison task, a row of the
    wrong width that may not retry), and read every /explain back through
    the same app. Cached per (app, worker, family) for the module."""
    key = (app_pkg, worker_pkg, family)
    if key in _RUNS:
        return _RUNS[key]
    model_dir, rows = served[family]
    env.setenv("MODEL_PATH", os.path.join(model_dir, "model.npz"))
    work = work / "-".join(key)
    work.mkdir()
    db_url, q_url = f"sqlite:///{work}/fraud.db", f"sqlite:///{work}/taskq.db"
    make_app, client_cls = (
        (jax_create_app, JaxClient) if app_pkg == "jax" else (create_app, TestClient)
    )
    with client_cls(make_app(database_url=db_url, broker_url=q_url)) as c:
        ids = []
        for row in rows:
            r = c.post("/predict", json={"features": row.tolist()})
            assert r.status_code == 200, r.json()
            assert r.json()["explanation_status"] == "queued"
            ids.append(r.json()["transaction_id"])
        pending = c.get(f"/explain/{ids[0]}")
        assert pending.status_code == 404
        c.app.state["db"].create_pending("poison", {"wrong": 1.0}, None)
        c.app.state["broker"].send_task(
            "xai_tasks.compute_shap", ["poison", {"wrong": 1.0}, None], max_retries=0
        )
        worker_cls = JaxWorker if worker_pkg == "jax" else XaiWorker
        worker = worker_cls(broker_url=q_url, database_url=db_url)
        try:
            handled = 0
            while n := worker.run_batch(64):
                handled += n
        finally:
            worker.broker.close()
            worker.db.close()
        assert handled == N_ROWS + 1
        assert c.app.state["broker"].depth() == 0
        bodies = [c.get(f"/explain/{t}") for t in ids]
        poison = c.get("/explain/poison")
        missing = c.get("/explain/no-such-transaction")
    out = {
        "bodies": [(r.status_code, r.json()) for r in bodies],
        "poison": (poison.status_code, poison.json()),
        "pending": (pending.status_code, pending.json()),
        "missing": (missing.status_code, missing.json()),
    }
    _RUNS[key] = out
    return out


def _assert_same_explanations(got, want, family):
    phi_tol, ev_tol = TOLS[family]
    assert got["pending"] == want["pending"]
    assert got["missing"] == want["missing"]
    assert got["poison"] == want["poison"]
    assert got["poison"][1]["status"] == "FAILED"
    assert "missing features" in got["poison"][1]["error"]
    for (gs, g), (ws, w) in zip(got["bodies"], want["bodies"], strict=True):
        assert gs == ws == 200
        assert set(g) == set(w)
        assert g["status"] == w["status"] == "COMPLETED"
        assert list(g["shap_values"]) == list(w["shap_values"])
        np.testing.assert_allclose(
            list(g["shap_values"].values()), list(w["shap_values"].values()), **phi_tol
        )
        np.testing.assert_allclose(g["prediction_score"], w["prediction_score"], **phi_tol)
        np.testing.assert_allclose(g["expected_value"], w["expected_value"], **ev_tol)


@pytest.mark.parametrize("family", ["logistic", "gbt"])
def test_port_app_and_worker_explain_as_the_jax_ones(family, served, env, tmp_path):
    want = _run("jax", "jax", family, served, env, tmp_path)
    got = _run("port", "port", family, served, env, tmp_path)
    _assert_same_explanations(got, want, family)


@pytest.mark.parametrize("family", ["logistic", "gbt"])
@pytest.mark.parametrize("app_pkg, worker_pkg", [("jax", "port"), ("port", "jax")])
def test_one_sqlite_pair_shared_across_the_packages(app_pkg, worker_pkg, family, served,
                                                    env, tmp_path):
    """A JAX app's tasks drained by a port worker, and a port app's by a JAX
    worker: every row COMPLETED, within the tolerances of the JAX pair."""
    want = _run("jax", "jax", family, served, env, tmp_path)
    got = _run(app_pkg, worker_pkg, family, served, env, tmp_path)
    _assert_same_explanations(got, want, family)


def test_enqueue_failure_answers_queue_failed_and_still_scores(served, env, tmp_path):
    """A broker that fails the enqueue: /predict still scores and answers
    ``"Queue failed"`` (the JAX app's answer), and /health reports the
    broker down."""
    model_dir, rows = served["logistic"]
    env.setenv("MODEL_PATH", os.path.join(model_dir, "model.npz"))
    app = create_app(database_url=f"sqlite:///{tmp_path}/f.db",
                     broker_url=f"sqlite:///{tmp_path}/q.db")
    with TestClient(app) as c:
        h = c.get("/health")
        assert h.status_code == 200 and h.json()["status"] == "healthy"
        c.app.state["broker"].close()
        r = c.post("/predict", json={"features": rows[0].tolist()})
        assert r.status_code == 200
        assert r.json()["explanation_status"] == "Queue failed"
        assert 0.0 <= r.json()["score"] <= 1.0
        h = c.get("/health")
        assert h.status_code == 503
        assert h.json()["checks"] == {"model": "ok", "database": "ok", "broker": "unavailable"}


@pytest.fixture(scope="module")
def feedback_clients(served, env, tmp_path_factory):
    """Both apps over the logistic directory (baseline profile beside it),
    each on its own sqlite pair."""
    model_dir, _ = served["logistic"]
    env.setenv("MODEL_PATH", os.path.join(model_dir, "model.npz"))
    tmp = tmp_path_factory.mktemp("feedback")
    jc = JaxClient(jax_create_app(database_url=f"sqlite:///{tmp}/jf.db",
                                  broker_url=f"sqlite:///{tmp}/jq.db"))
    tc = TestClient(create_app(database_url=f"sqlite:///{tmp}/tf.db",
                               broker_url=f"sqlite:///{tmp}/tq.db"))
    try:
        assert jc.get("/status").status_code == tc.get("/status").status_code == 200
        yield jc, tc
    finally:
        jc.close()
        tc.close()


_ROW = [0.1] * 30
BAD_FEEDBACK = {
    "labels_missing": {"features": [_ROW], "scores": [0.5]},
    "arity": {"features": [[0.1] * 7], "scores": [0.5], "labels": [1]},
    "score_out_of_range": {"features": [_ROW], "scores": [1.5], "labels": [1]},
    "label_not_binary": {"features": [_ROW], "scores": [0.5], "labels": [2]},
    "empty": {"features": [], "scores": [], "labels": []},
    "nested": {"features": [_ROW, [0.2] * 30], "scores": [[0.1, 0.2], [0.3, 0.4]],
               "labels": [[0, 1], [0, 0]]},
    "not_an_object": [1, 2, 3],
    "non_finite_row": {"features": [[1e39] * 30], "scores": [0.5], "labels": [1]},
    "null_score": {"features": [_ROW], "scores": [None], "labels": [1]},
    "row_not_a_list": {"features": [5], "scores": [0.5], "labels": [1]},
    "entity_ids_misaligned": {"features": [_ROW], "scores": [0.5], "labels": [1],
                              "entity_ids": ["a", "b"]},
    "timestamps_not_positive": {"features": [_ROW], "scores": [0.5], "labels": [1],
                                "timestamps": [-1.0]},
}


@pytest.mark.parametrize("case", sorted(BAD_FEEDBACK))
def test_feedback_rejects_what_the_jax_app_rejects(case, feedback_clients):
    jc, tc = feedback_clients
    jr = jc.post("/monitor/feedback", json=BAD_FEEDBACK[case])
    tr = tc.post("/monitor/feedback", json=BAD_FEEDBACK[case])
    assert jr.status_code == tr.status_code == 422
    assert tr.json() == jr.json()


def test_feedback_folds_labels_into_calibration_only(feedback_clients):
    """202 with ``persisted: true`` (the rows land in the durable lifecycle
    store, as in the JAX app); the port's n_labeled and ECE move as the JAX
    app's, and its drift window (rows seen, window rows) does not move."""
    jc, tc = feedback_clients
    rng = np.random.default_rng(7)
    feats = rng.standard_normal((64, 30)).astype(np.float32)
    scores = rng.random(64).astype(np.float32)
    labels = (rng.random(64) < scores).astype(np.float32)
    body = {"features": feats.tolist(), "scores": scores.tolist(), "labels": labels.tolist()}
    before = tc.get("/monitor/status").json()["drift"]
    jr, tr = jc.post("/monitor/feedback", json=body), tc.post("/monitor/feedback", json=body)
    assert jr.status_code == tr.status_code == 202
    assert tr.json() == jr.json() == {"queued": True, "rows": 64, "persisted": True}
    assert jc.app.state["watchtower"].drain(30.0)
    assert tc.app.state["watchtower"].drain(30.0)
    jd = jc.get("/monitor/status").json()["drift"]
    td = tc.get("/monitor/status").json()["drift"]
    assert td["n_labeled"] == pytest.approx(64.0, rel=1e-4)
    assert td["n_labeled"] == pytest.approx(jd["n_labeled"], rel=1e-6)
    assert td["ece"] == pytest.approx(jd["ece"], abs=1e-6)
    assert (td["rows_seen"], td["window_rows"]) == (before["rows_seen"], before["window_rows"])
    assert td["feature_psi_max"] == pytest.approx(before["feature_psi_max"], abs=0)


def test_feedback_is_409_without_a_profile(served, env, tmp_path):
    model_dir, _ = served["logistic"]
    bare = tmp_path / "bare"
    bare.mkdir()
    for f in ("model.npz", "feature_names.json"):
        shutil.copy(os.path.join(model_dir, f), bare)
    env.setenv("MODEL_PATH", str(bare / "model.npz"))
    body = {"features": [_ROW], "scores": [0.5], "labels": [1]}
    with JaxClient(jax_create_app(database_url=f"sqlite:///{tmp_path}/jf.db",
                                  broker_url=f"sqlite:///{tmp_path}/jq.db")) as jc, \
            TestClient(create_app(database_url=f"sqlite:///{tmp_path}/tf.db",
                                  broker_url=f"sqlite:///{tmp_path}/tq.db")) as tc:
        jr, tr = jc.post("/monitor/feedback", json=body), tc.post("/monitor/feedback", json=body)
        assert jr.status_code == tr.status_code == 409
        assert tr.json() == jr.json()
