"""The port's production loader against the JAX package's: the registry
alias first, then the native directory beside ``MODEL_PATH``, then the
reference's joblib artifacts; ``REQUIRE_REGISTRY_MODEL=1`` refuses to fall
back; the source strings are the JAX package's in each case."""

import os
import shutil

import numpy as np
import pytest
import torch

from fraud_detection_tpu.service.loading import load_production_model as jax_load
from fraud_detection_tpu.service.loading import resolve_source_version as jax_version
from fraud_detection_tpu_torch.models import FraudGBTModel, FraudLogisticModel
from fraud_detection_tpu_torch.monitor.watchtower import resolve_profile_dir
from fraud_detection_tpu_torch.service.loading import (
    load_production_model,
    resolve_source_version,
)
from fraud_detection_tpu_torch.tracking import TrackingClient

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
X = np.random.default_rng(0).standard_normal((16, 30)).astype(np.float32) * 2


@pytest.fixture()
def env(tmp_path, monkeypatch):
    """An empty tracking store, the CPU, and ``MODEL_PATH``,
    ``SCALER_PATH`` and ``FEATURE_NAMES_PATH`` at a copy of the committed
    ``models/`` (native and joblib files both)."""
    models = tmp_path / "models"
    shutil.copytree(os.path.join(ROOT, "models"), models)
    monkeypatch.setenv("MLFLOW_TRACKING_URI", f"file:{tmp_path}/mlruns")
    monkeypatch.setenv("DEVICE", "cpu")
    monkeypatch.setenv("MODEL_PATH", str(models / "logistic_model.joblib"))
    monkeypatch.setenv("SCALER_PATH", str(models / "scaler.joblib"))
    monkeypatch.setenv("FEATURE_NAMES_PATH", str(models / "feature_names.json"))
    for knob in ("MLFLOW_MODEL_NAME", "MLFLOW_MODEL_STAGE", "REQUIRE_REGISTRY_MODEL"):
        monkeypatch.delenv(knob, raising=False)
    return monkeypatch, models


def _both():
    model, source = load_production_model(device="cpu")
    jmodel, jsource = jax_load()
    assert source == jsource
    np.testing.assert_allclose(
        model.scorer.predict_proba(X),
        np.asarray(jmodel.scorer.predict_proba(X)).reshape(-1), rtol=0, atol=1e-6)
    return model, source


def _register_forest(tmp_path, alias="prod"):
    """A small forest, registered under ``alias``; its directory."""
    from fraud_detection_tpu_torch.ops.gbt import GBTConfig, gbt_fit

    y = (X[:, 1] > 0).astype(np.int32)
    forest = gbt_fit(X, y, GBTConfig(n_trees=3, max_depth=2, n_bins=8), device="cpu")
    art = str(tmp_path / "forest")
    names = [f"f{i}" for i in range(30)]
    FraudGBTModel(forest, names, background=X[:4], device="cpu").save(art)
    reg = TrackingClient().registry
    reg.set_alias("fraud", alias, reg.register("fraud", art))
    return art


def test_registry_comes_first(env, tmp_path):
    _register_forest(tmp_path)
    model, source = _both()
    assert source == "registry:models:/fraud@prod"
    assert isinstance(model, FraudGBTModel)
    assert resolve_source_version(source) == jax_version(source) == 1


def test_native_directory_when_the_registry_is_empty(env):
    _, models = env
    model, source = _both()
    assert source == f"native:{models}"
    assert isinstance(model, FraudLogisticModel)
    assert resolve_source_version(source) is None
    assert resolve_profile_dir(source) == str(models)


def test_joblib_when_there_is_no_model_npz(env):
    _, models = env
    os.remove(models / "model.npz")
    model, source = _both()
    assert source == f"joblib:{models / 'logistic_model.joblib'}"
    assert model.feature_names[0] == "Time" and model.scaler is not None
    assert resolve_source_version(source) is None
    assert resolve_profile_dir(source) == str(models)


def test_joblib_without_a_scaler_file(env):
    """A missing ``SCALER_PATH`` loads the estimator unscaled, as in JAX."""
    mp, models = env
    os.remove(models / "model.npz")
    mp.setenv("SCALER_PATH", str(models / "absent.joblib"))
    model, source = _both()
    assert source.startswith("joblib:") and model.scaler is None


def test_nothing_loadable_raises(env, tmp_path):
    mp, _ = env
    mp.setenv("MODEL_PATH", str(tmp_path / "none" / "model.npz"))
    with pytest.raises(RuntimeError, match="no model available"):
        load_production_model(device="cpu")


def test_require_registry_model_refuses_to_fall_back(env, tmp_path):
    mp, _ = env
    mp.setenv("REQUIRE_REGISTRY_MODEL", "1")
    with pytest.raises(RuntimeError, match="REQUIRE_REGISTRY_MODEL"):
        load_production_model(device="cpu")
    with pytest.raises(RuntimeError, match="REQUIRE_REGISTRY_MODEL"):
        jax_load()
    _register_forest(tmp_path)
    assert _both()[1] == "registry:models:/fraud@prod"


def test_stage_and_name_select_the_alias(env, tmp_path):
    """``MLFLOW_MODEL_STAGE`` names the alias; another alias does not
    count."""
    mp, models = env
    _register_forest(tmp_path, alias="staging")
    assert _both()[1] == f"native:{models}"
    mp.setenv("MLFLOW_MODEL_STAGE", "staging")
    assert _both()[1] == "registry:models:/fraud@staging"
    assert resolve_profile_dir("registry:models:/fraud@staging").endswith(
        os.path.join("versions", "1"))
    assert resolve_profile_dir("registry:models:/fraud@prod") is None
    assert resolve_source_version("registry:models:/fraud/3") == 3
