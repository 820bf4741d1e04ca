"""The shadow challenger and the retrain trigger on the port
(``monitor/shadow.py``, the watchtower's binding, ``load_shadow_model``)
against the JAX package's ``ShadowScorer`` and ``Watchtower`` (its
``test_monitor.py`` cases): disagreement, mean |Δscore|, challenger score
PSI and reason divergence within 1e-6 of JAX's on the same rows; the
recommendation logic; the challenger resolved from ``@shadow`` only; and
one ``watchtower.trigger_retrain`` task a drift episode."""

import os
import shutil

import numpy as np
import pytest
import torch

from fraud_detection_tpu.models.logistic import FraudLogisticModel as JaxModel
from fraud_detection_tpu.monitor.baseline import build_baseline_profile as jax_profile
from fraud_detection_tpu.monitor.baseline import load_profile as jax_load_profile
from fraud_detection_tpu.monitor.baseline import save_profile
from fraud_detection_tpu.monitor.shadow import ShadowScorer as JaxShadow
from fraud_detection_tpu.monitor.watchtower import Thresholds as JaxThresholds
from fraud_detection_tpu.monitor.watchtower import _challenger_explainer as jax_explainer
from fraud_detection_tpu.monitor.watchtower import _recommend as jax_recommend
from fraud_detection_tpu.ops.logistic import LogisticParams as JaxParams
from fraud_detection_tpu_torch.models import load_any_model
from fraud_detection_tpu_torch.monitor import watchtower as port_wt
from fraud_detection_tpu_torch.monitor.baseline import load_profile
from fraud_detection_tpu_torch.monitor.drift import PSI_EPS
from fraud_detection_tpu_torch.monitor.shadow import ShadowScorer
from fraud_detection_tpu_torch.monitor.watchtower import (
    RETRAIN_TASK,
    Thresholds,
    Watchtower,
    _challenger_explainer,
    _recommend,
)
from fraud_detection_tpu_torch.service import metrics
from fraud_detection_tpu_torch.service.loading import load_shadow_model
from fraud_detection_tpu_torch.tracking import TrackingClient

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
THR = Thresholds(psi=0.2, ks=0.15, ece=0.1, disagree=0.05, min_rows=64)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """The committed champion with a baseline profile, and a challenger
    artifact (its coefficients scaled and shifted)."""
    root = tmp_path_factory.mktemp("shadow")
    champ = str(root / "champion")
    shutil.copytree(os.path.join(ROOT, "models"), champ)
    x = np.loadtxt(os.path.join(ROOT, "data", "creditcard.csv"), delimiter=",",
                   skiprows=1, max_rows=2048, dtype=np.float32)[:, :30]
    x = np.ascontiguousarray(x)
    jm = JaxModel.load(champ)
    scores = np.asarray(jm.scorer.predict_proba(x)).reshape(-1)
    save_profile(champ, jax_profile(x, scores, feature_names=jm.feature_names))
    coef = np.asarray(jm.params.coef, np.float32)
    params = JaxParams(coef=(coef * 0.7 + 0.05).astype(np.float32),
                       intercept=np.float32(np.asarray(jm.params.intercept) + 0.5))
    chal = str(root / "challenger")
    JaxModel(params, jm.scaler, jm.feature_names).save(chal, joblib_too=False)
    return champ, chal, x, scores


def _champion_reasons(champ_dir, x, k=3):
    m = load_any_model(champ_dir, device="cpu")
    phi, _ = m.explain_batch(x)
    return np.argsort(-phi, axis=1, kind="stable")[:, :k]


def test_shadow_statistics_match_jax(dirs):
    champ, chal, x, scores = dirs
    profile = load_profile(champ)
    jprofile = jax_load_profile(champ)
    port_ch = load_any_model(chal, device="cpu")
    jax_ch = JaxModel.load(chal)
    sh = ShadowScorer(port_ch.scorer, profile, sample_rate=1.0, halflife_rows=3000.0,
                      explainer=_challenger_explainer(port_ch))
    jsh = JaxShadow(jax_ch.scorer, jprofile, sample_rate=1.0, halflife_rows=3000.0,
                    explainer=jax_explainer(jax_ch))
    reasons = _champion_reasons(champ, x)
    for lo in range(0, 2048, 256):
        rows, champ_s = x[lo:lo + 256], scores[lo:lo + 256]
        assert sh.maybe_observe(rows, champ_s, reasons[lo:lo + 256])
        assert jsh.maybe_observe(rows, champ_s, reasons[lo:lo + 256])
    got, want = sh.stats(), jsh.stats()
    assert set(got) == set(want)
    for key in ("disagreement", "mean_abs_delta", "score_psi", "reason_divergence",
                "window_rows"):
        assert got[key] == pytest.approx(want[key], abs=1e-6), key
    assert got["batches_sampled"] == want["batches_sampled"] == 8
    assert 0.0 < got["reason_divergence"] < 1.0


def test_shadow_statistics_match_numpy(dirs):
    """An infinite half-life: the window is the plain sums, recomputed in
    numpy from the challenger's own scores."""
    champ, chal, x, scores = dirs
    profile = load_profile(champ)
    ch = load_any_model(chal, device="cpu")
    sh = ShadowScorer(ch.scorer, profile, sample_rate=1.0, halflife_rows=float("inf"))
    for lo in range(0, 1024, 128):
        sh.maybe_observe(x[lo:lo + 128], scores[lo:lo + 128])
    st = sh.stats()
    c = ch.scorer.predict_proba(x[:1024]).astype(np.float64)
    s = scores[:1024].astype(np.float64)
    assert st["disagreement"] == pytest.approx(np.mean((c >= 0.5) != (s >= 0.5)), abs=1e-6)
    assert st["mean_abs_delta"] == pytest.approx(np.mean(np.abs(c - s)), abs=1e-6)
    edges = np.asarray(profile.score_edges, np.float64)
    base = np.asarray(profile.score_counts, np.float64)
    cnt = np.bincount(np.searchsorted(edges, c, side="right"),
                      minlength=base.shape[0]).astype(np.float64)
    p = (cnt + PSI_EPS) / (cnt.sum() + PSI_EPS * base.shape[0])
    q = (base + PSI_EPS) / (base.sum() + PSI_EPS * base.shape[0])
    assert st["score_psi"] == pytest.approx(float(np.sum((p - q) * np.log(p / q))), abs=1e-6)
    assert st["reason_divergence"] is None


def test_shadow_sampling_and_halflife_match_jax(dirs):
    champ, chal, x, scores = dirs
    profile = load_profile(champ)
    ch = load_any_model(chal, device="cpu")
    sh = ShadowScorer(ch.scorer, profile, sample_rate=0.0, halflife_rows=float("inf"))
    assert not sh.maybe_observe(x[:64], scores[:64])
    assert sh.batches_sampled == 0 and sh.batches_seen == 1

    class _AlwaysSample:
        def random(self):
            return 0.0

    halflife, rate, n = 1000.0, 0.25, 128
    sh = ShadowScorer(ch.scorer, profile, sample_rate=rate, halflife_rows=halflife)
    sh._rng = _AlwaysSample()
    sh.maybe_observe(x[:n], scores[:n])
    sh.maybe_observe(x[:n], scores[:n])
    decay = 0.5 ** (n / (halflife * rate))
    assert sh.stats()["window_rows"] == pytest.approx(n * decay + n, rel=1e-9)


def _shadow(window_rows=1000.0, score_psi=0.01, disagreement=0.0):
    return {"window_rows": window_rows, "score_psi": score_psi,
            "disagreement": disagreement}


@pytest.mark.parametrize("warming, flags, shadow", [
    (True, {"score_psi": True}, None),
    (False, {}, None),
    (False, {"feature_psi": True}, None),
    (False, {"score_psi": True}, _shadow(score_psi=0.05)),
    (False, {"score_psi": True}, _shadow(score_psi=0.5)),
    (False, {"score_psi": True}, _shadow(window_rows=10)),
    (False, {}, _shadow(disagreement=0.2)),
    (False, {}, _shadow(disagreement=0.01)),
])
def test_recommendation_matches_jax(warming, flags, shadow):
    jthr = JaxThresholds(psi=0.2, ks=0.15, ece=0.1, disagree=0.05, min_rows=64)
    assert _recommend(warming, flags, shadow, THR) == \
        jax_recommend(warming, flags, shadow, jthr)


def test_watchtower_binds_the_shadow_on_its_ingest_thread(dirs):
    champ, chal, x, scores = dirs
    ch = load_any_model(chal, device="cpu")
    wt = Watchtower(load_profile(champ), challenger=ch, challenger_source="test:chal",
                    thresholds=THR, sample_rate=1.0, device="cpu")
    try:
        assert wt.wants_rows()
        before = metrics.watchtower_shadow_batches.get()
        for lo in range(0, 512, 128):
            assert wt.observe(x[lo:lo + 128], scores[lo:lo + 128])
        assert wt.drain(timeout=30.0)
        assert metrics.watchtower_shadow_batches.get() - before == 4
        st = wt.status()
        assert st["shadow"]["batches_sampled"] == 4
        assert st["challenger_source"] == "test:chal"
        assert metrics.watchtower_shadow_disagreement.get() == \
            pytest.approx(st["shadow"]["disagreement"])
    finally:
        wt.close()


def test_load_shadow_model_resolves_the_alias_only(dirs, tmp_path, monkeypatch):
    champ, chal, _, _ = dirs
    monkeypatch.setenv("MLFLOW_TRACKING_URI", f"file:{tmp_path}/mlruns")
    monkeypatch.setenv("FRAUD_REGISTRY_CACHE", str(tmp_path / "cache"))
    monkeypatch.setenv("MODEL_PATH", os.path.join(chal, "model.npz"))
    assert load_shadow_model(device="cpu") is None  # nothing on disk counts
    reg = TrackingClient().registry
    reg.set_alias("fraud", "shadow", reg.register("fraud", chal))
    model, source = load_shadow_model(device="cpu")
    assert source == "registry:models:/fraud@shadow"
    assert model.device.type == "cpu"


def test_build_watchtower_binds_the_registered_challenger(dirs, tmp_path, monkeypatch):
    champ, chal, _, _ = dirs
    monkeypatch.setenv("MLFLOW_TRACKING_URI", f"file:{tmp_path}/mlruns")
    monkeypatch.setenv("FRAUD_REGISTRY_CACHE", str(tmp_path / "cache"))
    reg = TrackingClient().registry
    reg.set_alias("fraud", "shadow", reg.register("fraud", chal))
    model = load_any_model(champ, device="cpu")
    wt = port_wt.build_watchtower(model, f"native:{champ}")
    try:
        assert wt.shadow is not None
        assert wt.challenger_source == "registry:models:/fraud@shadow"
    finally:
        wt.close()


def test_one_drift_episode_enqueues_one_retrain_task(dirs, monkeypatch):
    champ, _, x, scores = dirs
    monkeypatch.setenv("WATCHTOWER_RETRAIN_TRIGGER", "1")
    sent = []
    before = metrics.watchtower_retrain_triggers.get()
    wt = Watchtower(load_profile(champ), thresholds=THR, halflife_rows=2000.0,
                    retrain_sender=sent.append, device="cpu")
    xs, ss = x[::2], scores[::2]  # spread over the baseline's rows (Time grows)
    try:
        for lo in range(0, 1024, 256):
            wt.observe(xs[lo:lo + 256], ss[lo:lo + 256])
        assert wt.drain(timeout=30.0)
        assert wt.status()["recommendation"] == "none" and not sent
        for lo in range(0, 1024, 256):
            wt.observe(xs[lo:lo + 256] * 4.0 + 3.0, np.clip(ss[lo:lo + 256] + 0.4, 0, 1))
        assert wt.drain(timeout=30.0)
        st = wt.status()
        assert st["status"] == "drift" and st["recommendation"] == "retrain"
        wt.status()
        wt.status()  # latched: the same episode does not fire again
        assert len(sent) == 1 and "feature_psi_max" in sent[0]
        assert metrics.watchtower_retrain_triggers.get() - before == 1
    finally:
        wt.close()


def test_retrain_trigger_off_by_default_and_rearms(dirs, monkeypatch):
    champ, _, x, scores = dirs
    sent = []
    wt = Watchtower(load_profile(champ), thresholds=THR, halflife_rows=2000.0,
                    retrain_sender=sent.append, device="cpu")
    try:
        monkeypatch.delenv("WATCHTOWER_RETRAIN_TRIGGER", raising=False)
        wt._maybe_trigger_retrain("retrain", wt.drift.stats())
        assert not sent
        monkeypatch.setenv("WATCHTOWER_RETRAIN_TRIGGER", "1")
        d = wt.drift.stats()
        wt._maybe_trigger_retrain("retrain", d)
        wt._maybe_trigger_retrain("retrain", d)
        wt._maybe_trigger_retrain("none", d)  # episode over: re-armed
        wt._maybe_trigger_retrain("retrain", d)
        assert len(sent) == 2
    finally:
        wt.close()


def test_app_sends_the_retrain_task_to_the_broker(dirs, tmp_path, monkeypatch):
    """The served app's drift episode puts one RETRAIN_TASK on its broker
    (the worker runs it through the conductor)."""
    from fraud_detection_tpu_torch.service.app import create_app
    from fraud_detection_tpu_torch.service.http import TestClient
    from fraud_detection_tpu_torch.service.taskq import Broker

    champ, _, _, _ = dirs
    monkeypatch.setenv("MODEL_PATH", os.path.join(champ, "model.npz"))
    monkeypatch.setenv("MLFLOW_TRACKING_URI", f"file:{tmp_path}/mlruns")
    monkeypatch.setenv("SCORER_MAX_BATCH", "16")
    monkeypatch.setenv("WATCHTOWER_MIN_ROWS", "8")
    monkeypatch.setenv("WATCHTOWER_RETRAIN_TRIGGER", "1")
    monkeypatch.setenv("DEVICE", "cpu")
    broker_url = f"sqlite:///{tmp_path}/taskq.db"
    with TestClient(create_app(database_url=f"sqlite:///{tmp_path}/fraud.db",
                               broker_url=broker_url)) as tc:
        for i in range(12):
            assert tc.post("/predict", json={"features": [40.0 + i] * 30}).status_code == 200
        assert tc.app.state["watchtower"].drain(timeout=30.0)
        body = tc.get("/monitor/status").json()
        assert body["status"] == "drift" and body["shadow"] is None
        tc.get("/metrics")  # a scrape evaluates again: still one task
    broker = Broker(broker_url)
    try:
        names = [t.name for t in broker.claim_many("test", 1000)]
        assert names.count(RETRAIN_TASK) == 1 and len(names) == 13
    finally:
        broker.close()
