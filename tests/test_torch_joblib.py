"""The joblib interchange (the reference's ``logistic_model.joblib`` /
``scaler.joblib`` / ``columns.joblib`` layout) against the JAX package's:
the committed ``models/*.joblib`` load to bitwise the same params and score
within 1e-6 in both packages; each package reads what the other exports."""

import os
import shutil
import sys

import numpy as np
import pytest
import torch

from fraud_detection_tpu.ckpt.checkpoint import export_joblib_artifacts as jax_export
from fraud_detection_tpu.ckpt.checkpoint import import_joblib_artifacts as jax_import
from fraud_detection_tpu.models.logistic import FraudLogisticModel as JaxModel
from fraud_detection_tpu.ops.logistic import LogisticParams as JaxParams
from fraud_detection_tpu.ops.scaler import ScalerParams as JaxScaler
from fraud_detection_tpu_torch.ckpt.checkpoint import (
    export_joblib_artifacts,
    export_scaler_artifacts,
    import_joblib_artifacts,
)
from fraud_detection_tpu_torch.models import FraudLogisticModel

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = os.path.join(ROOT, "models")
COMMITTED = (os.path.join(MODELS, "logistic_model.joblib"),
             os.path.join(MODELS, "scaler.joblib"),
             os.path.join(MODELS, "feature_names.json"))


def _rows(n=256, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 30)).astype(np.float32)
    x[:, 0] = rng.uniform(0, 172800, n)
    x[:, 29] = rng.lognormal(3.0, 1.0, n)
    return x


def _same_params(port, jax_triple):
    params, scaler, names = port
    jparams, jscaler, jnames = jax_triple
    assert params.coef.numpy().tobytes() == np.asarray(jparams.coef).tobytes()
    assert params.intercept.numpy().tobytes() == np.asarray(jparams.intercept).tobytes()
    assert (scaler is None) == (jscaler is None)
    if scaler is not None:
        for f in ("mean", "scale", "var", "n_samples"):
            assert getattr(scaler, f).numpy().tobytes() == \
                np.asarray(getattr(jscaler, f), np.float32).tobytes()
    assert names == jnames


def test_committed_joblib_loads_bitwise_and_scores_alike():
    _same_params(import_joblib_artifacts(*COMMITTED), jax_import(*COMMITTED))
    port = FraudLogisticModel.load_joblib(*COMMITTED, device="cpu")
    jax = JaxModel.load_joblib(*COMMITTED)
    x = _rows()
    np.testing.assert_allclose(port.scorer.predict_proba(x),
                               np.asarray(jax.scorer.predict_proba(x)).reshape(-1),
                               rtol=0, atol=1e-6)
    assert port.feature_names == jax.feature_names


def test_port_export_jax_import(tmp_path):
    params, scaler, names = import_joblib_artifacts(*COMMITTED)
    export_joblib_artifacts(str(tmp_path), params, scaler, names)
    assert sorted(os.listdir(tmp_path)) == [
        "columns.joblib", "feature_names.json", "logistic_model.joblib", "scaler.joblib"]
    args = (str(tmp_path / "logistic_model.joblib"), str(tmp_path / "scaler.joblib"),
            str(tmp_path / "feature_names.json"))
    _same_params((params, scaler, names), jax_import(*args))
    import joblib

    assert joblib.load(tmp_path / "columns.joblib") == names
    # a real sklearn estimator: its own predict_proba agrees with the port's
    # scorer on the scaled rows
    sk, sks = joblib.load(args[0]), joblib.load(args[1])
    x = _rows(seed=1)
    port = FraudLogisticModel(params, scaler, names, device="cpu")
    np.testing.assert_allclose(sk.predict_proba(sks.transform(x))[:, 1],
                               port.scorer.predict_proba(x), rtol=0, atol=1e-6)


def test_jax_export_port_import(tmp_path):
    jparams, jscaler, names = jax_import(*COMMITTED)
    jscaler = JaxScaler(*(np.asarray(v, np.float32) * 1.5 for v in jscaler))
    jparams = JaxParams(coef=np.asarray(jparams.coef) * 0.5, intercept=jparams.intercept)
    jax_export(str(tmp_path), jparams, jscaler, names)
    got = import_joblib_artifacts(str(tmp_path / "logistic_model.joblib"),
                                  str(tmp_path / "scaler.joblib"),
                                  str(tmp_path / "feature_names.json"))
    _same_params(got, (jparams, jscaler, names))


def test_missing_scaler_is_refused_and_no_names_are_invented():
    with pytest.raises(FileNotFoundError, match="scaler"):
        import_joblib_artifacts(COMMITTED[0], "/nonexistent/scaler.joblib")
    m = FraudLogisticModel.load_joblib(COMMITTED[0], None, None, device="cpu")
    assert m.scaler is None and m.feature_names == [f"f{i}" for i in range(30)]


def test_save_writes_the_joblib_layout_where_sklearn_is_installed(tmp_path, monkeypatch):
    """``save(joblib_too=True)`` adds the reference layout, which the JAX
    package reads back; without sklearn it writes the native files only
    (the JAX package's ``except RuntimeError: pass``)."""
    m = FraudLogisticModel.load_joblib(*COMMITTED, device="cpu")
    m.save(str(tmp_path / "with"))
    assert {"logistic_model.joblib", "scaler.joblib", "columns.joblib"} <= \
        set(os.listdir(tmp_path / "with"))
    back = JaxModel.load_joblib(str(tmp_path / "with" / "logistic_model.joblib"),
                                str(tmp_path / "with" / "scaler.joblib"),
                                str(tmp_path / "with" / "feature_names.json"))
    assert np.asarray(back.params.coef).tobytes() == m.params.coef.numpy().tobytes()
    m.save(str(tmp_path / "native"), joblib_too=False)
    for mod in ("sklearn", "sklearn.linear_model", "sklearn.preprocessing"):
        monkeypatch.setitem(sys.modules, mod, None)
    m.save(str(tmp_path / "nosk"))
    assert sorted(os.listdir(tmp_path / "nosk")) == sorted(os.listdir(tmp_path / "native")) \
        == ["feature_names.json", "model.npz", "quant_calibration.npz"]
    with pytest.raises(RuntimeError, match="joblib/sklearn"):
        export_scaler_artifacts(str(tmp_path / "x"), m.scaler, m.feature_names)


def test_joblib_without_joblib_raises(monkeypatch):
    monkeypatch.setitem(sys.modules, "joblib", None)
    with pytest.raises(RuntimeError, match="joblib"):
        import_joblib_artifacts(*COMMITTED)


def test_scaler_artifacts_only(tmp_path):
    """What ``preprocess`` writes before any model exists."""
    params, scaler, names = import_joblib_artifacts(*COMMITTED)
    export_scaler_artifacts(str(tmp_path), scaler, names)
    assert sorted(os.listdir(tmp_path)) == [
        "columns.joblib", "feature_names.json", "scaler.joblib"]
    shutil.copy(COMMITTED[0], tmp_path / "logistic_model.joblib")
    _same_params(import_joblib_artifacts(str(tmp_path / "logistic_model.joblib"),
                                         str(tmp_path / "scaler.joblib"),
                                         str(tmp_path / "feature_names.json")),
                 jax_import(*COMMITTED))
