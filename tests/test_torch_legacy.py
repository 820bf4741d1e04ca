"""The port's legacy app (``service/legacy.py``, the reference
``deploy.py``'s contract) against the JAX package's on the committed model:
``GET /`` banner, ``POST /predict`` answering ``{prediction,
fraud_probability, alert}`` with alert above 0.8 (dict, list and wrapped
forms), 500 ``{"error"}`` on any failure, and the production model loaded
at startup. The JAX cases are ``test_service_api.py``'s."""

import os

import numpy as np
import pytest
import torch

from fraud_detection_tpu.models.logistic import FraudLogisticModel as JaxModel
from fraud_detection_tpu.service import legacy as jax_legacy
from fraud_detection_tpu.service.http import TestClient as JaxClient
from fraud_detection_tpu_torch.models import FraudLogisticModel
from fraud_detection_tpu_torch.service import legacy
from fraud_detection_tpu_torch.service.http import TestClient

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = os.path.join(ROOT, "models")


@pytest.fixture(scope="module")
def rows():
    x = np.loadtxt(os.path.join(ROOT, "data", "creditcard.csv"), delimiter=",",
                   skiprows=1, max_rows=400, dtype=np.float32)
    return x[:, :30]


@pytest.fixture()
def clients():
    model = FraudLogisticModel.load(MODELS, device="cpu")
    jmodel = JaxModel.load(MODELS)
    tc = TestClient(legacy.create_app(model=model))
    jc = JaxClient(jax_legacy.create_app(model=jmodel))
    yield tc, jc, model
    tc.close()
    jc.close()


def test_index_banner_matches_jax(clients):
    tc, jc, _ = clients
    r, jr = tc.get("/"), jc.get("/")
    assert r.status_code == jr.status_code == 200
    assert r.json() == jr.json() and "live" in r.json()["msg"]


def test_predict_contract_matches_jax(clients, rows):
    """The same keys and label; the probability within JAX's rounding
    (both round to 4 places; the f32 scores agree within 1e-6); alert iff
    the probability is above 0.8."""
    tc, jc, model = clients
    names = model.feature_names
    # the highest-scoring rows too, so alert takes both values
    order = np.argsort(-model.scorer.predict_proba(rows))
    for i in list(order[:5]) + [0, 1, 2]:
        features = dict(zip(names, rows[i].tolist()))
        r, jr = tc.post("/predict", json=features), jc.post("/predict", json=features)
        assert r.status_code == jr.status_code == 200
        body, jbody = r.json(), jr.json()
        assert set(body) == set(jbody) == {"prediction", "fraud_probability", "alert"}
        assert body["prediction"] == jbody["prediction"]
        assert abs(body["fraud_probability"] - jbody["fraud_probability"]) <= 1e-4 + 1e-9
        assert body["alert"] == (body["fraud_probability"] > 0.8)
        _, p = model.score_one(features)
        assert body["fraud_probability"] == round(p, 4)


def test_predict_list_and_wrapped_forms(clients, rows):
    tc, jc, _ = clients
    for payload in (rows[3].tolist(), {"features": rows[3].tolist()}):
        r, jr = tc.post("/predict", json=payload), jc.post("/predict", json=payload)
        assert r.status_code == jr.status_code == 200
        assert r.json()["prediction"] == jr.json()["prediction"]


@pytest.mark.parametrize("payload", [{"Time": 1.0}, [0.1] * 7, "x", None])
def test_error_contract_matches_jax(clients, payload):
    tc, jc, _ = clients
    r, jr = tc.post("/predict", json=payload), jc.post("/predict", json=payload)
    assert r.status_code == jr.status_code == 500
    assert set(r.json()) == set(jr.json()) == {"error"}


def test_startup_loads_the_production_model(tmp_path, monkeypatch, rows):
    monkeypatch.setenv("MODEL_PATH", os.path.join(MODELS, "model.npz"))
    monkeypatch.setenv("MLFLOW_TRACKING_URI", f"file:{tmp_path}/mlruns")
    with TestClient(legacy.create_app(device="cpu")) as tc:
        r = tc.post("/predict", json={"features": rows[0].tolist()})
        assert r.status_code == 200
        assert tc.app.state["model"].device.type == "cpu"


def test_startup_without_a_model_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("MODEL_PATH", str(tmp_path / "none" / "model.npz"))
    monkeypatch.setenv("MLFLOW_TRACKING_URI", f"file:{tmp_path}/mlruns")
    app = legacy.create_app(device="cpu")
    with TestClient(app) as tc:
        with pytest.raises(RuntimeError):
            tc.get("/")
