"""The port's offline tools against the JAX package's on the same inputs:
preprocess, evaluate, explain, predict_single, validate_auc and eda, on a
3,000-row synthetic set and one small port fit per family, which both
packages load through the shared artifact layout. Everything on the CPU."""

import csv
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from fraud_detection_tpu.eda import eda as jax_eda
from fraud_detection_tpu.evaluate import evaluate as jax_evaluate
from fraud_detection_tpu.explain import explain as jax_explain
from fraud_detection_tpu.predict_single import FraudDetector as JaxDetector
from fraud_detection_tpu.preprocess import preprocess as jax_preprocess
from fraud_detection_tpu.tracking import TrackingClient as JaxTrackingClient
from fraud_detection_tpu.validate_auc import validate_auc as jax_validate_auc
from fraud_detection_tpu_torch import eda as eda_mod
from fraud_detection_tpu_torch import evaluate as evaluate_mod
from fraud_detection_tpu_torch import explain as explain_mod
from fraud_detection_tpu_torch import predict_single as predict_mod
from fraud_detection_tpu_torch import preprocess as preprocess_mod
from fraud_detection_tpu_torch import validate_auc as validate_mod
from fraud_detection_tpu_torch.data.synthetic import generate_synthetic_data
from fraud_detection_tpu_torch.ops.gbt import GBTConfig
from fraud_detection_tpu_torch.predict_single import _DEMO_ROW, FraudDetector
from fraud_detection_tpu_torch.tracking import TrackingClient
from fraud_detection_tpu_torch.train import train

torch.set_num_threads(1)

#: φ tolerances against the JAX package, by family
PHI_TOLS = {"logistic": dict(rtol=0, atol=1e-6), "gbt": dict(rtol=1e-4, atol=2e-5)}


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """The CPU, a tracking store and registry cache in a temp dir, and the
    gate threshold of a small synthetic fit."""
    tmp = tmp_path_factory.mktemp("tools_env")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DEVICE", "cpu")
        mp.setenv("MLFLOW_TRACKING_URI", f"file:{tmp}/mlruns")
        mp.setenv("FRAUD_REGISTRY_CACHE", str(tmp / "cache"))
        mp.setenv("MLFLOW_AUC_THRESHOLD", "0.70")
        for knob in ("MLFLOW_MODEL_NAME", "MLFLOW_MODEL_STAGE", "MLFLOW_EXPERIMENT",
                     "REQUIRE_REGISTRY_MODEL"):
            mp.delenv(knob, raising=False)
        yield mp


@pytest.fixture(scope="module")
def fits(tmp_path_factory, env):
    """A 3,000-row synthetic CSV (a 0.8 σ fraud shift: at the default 1.5 σ
    every model scores AUC 1.0 and the comparison says nothing) and one port
    fit per family on it: family → model directory."""
    tmp = tmp_path_factory.mktemp("tools_fits")
    path = str(tmp / "synth.csv")
    generate_synthetic_data(path, n_samples=3000, fraud_ratio=0.05, seed=3,
                            shift_scale=0.8)
    dirs = {f: str(tmp / f) for f in ("logistic", "gbt")}
    train(data_csv=path, n_folds=2, register=False, out_dir=dirs["logistic"],
          device="cpu")
    train(data_csv=path, n_folds=2, register=False, out_dir=dirs["gbt"], device="cpu",
          model_family="gbt", gbt_config=GBTConfig(n_trees=12, max_depth=3, n_bins=32))
    return path, dirs


def _top(res):
    return list(res["mean_abs_shap"])


# ---------------------------------------------------------------------------
# preprocess
# ---------------------------------------------------------------------------


def test_preprocess_matches_jax(fits, tmp_path):
    """``y_test`` and the feature list equal the JAX package's; ``X_test``
    is within 2e-6 of it (both standardise in float32; the scaler's sums run
    in another order, so a value may differ in its last bits); SMOTE
    balances the classes to the same count."""
    path, _ = fits
    got = preprocess_mod.preprocess(path, str(tmp_path / "p.npz"), str(tmp_path / "pm"),
                                    device="cpu")
    want = jax_preprocess(path, str(tmp_path / "j.npz"), str(tmp_path / "jm"))
    assert {k: v for k, v in got.items() if k != "out"} == \
        {k: v for k, v in want.items() if k != "out"}
    p, j = np.load(tmp_path / "p.npz"), np.load(tmp_path / "j.npz")
    assert set(p.files) == set(j.files) == {"X_res", "y_res", "X_test", "y_test"}
    assert p["y_test"].tobytes() == j["y_test"].tobytes()
    assert p["X_test"].dtype == j["X_test"].dtype == np.float32
    np.testing.assert_allclose(p["X_test"], j["X_test"], rtol=1e-6, atol=2e-6)
    assert (p["y_res"] == 1).sum() == (p["y_res"] == 0).sum() == (j["y_res"] == 1).sum()
    assert p["X_res"].shape == j["X_res"].shape
    for name in ("feature_names.json", "columns.joblib", "scaler.joblib"):
        assert os.path.exists(tmp_path / "pm" / name)
    assert json.loads((tmp_path / "pm" / "feature_names.json").read_text()) == \
        json.loads((tmp_path / "jm" / "feature_names.json").read_text())


def test_preprocess_without_joblib_writes_the_feature_list(fits, tmp_path, monkeypatch):
    """Without joblib the scaler artifacts are skipped and
    ``feature_names.json`` still lands."""
    path, _ = fits
    monkeypatch.setitem(sys.modules, "joblib", None)
    preprocess_mod.preprocess(path, str(tmp_path / "p.npz"), str(tmp_path / "pm"),
                              device="cpu")
    assert sorted(os.listdir(tmp_path / "pm")) == ["feature_names.json"]


# ---------------------------------------------------------------------------
# evaluate
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", ["logistic", "gbt"])
def test_evaluate_matches_jax(fits, tmp_path, family):
    """The confusion matrix equals the JAX package's, the report and the AUC
    are within 1e-6, and the same plot files are written."""
    path, dirs = fits
    got = evaluate_mod.evaluate(path, dirs[family], str(tmp_path / "p"), device="cpu")
    want = jax_evaluate(path, dirs[family], str(tmp_path / "j"))
    assert got["confusion_matrix"] == want["confusion_matrix"]
    assert abs(got["auc"] - want["auc"]) <= 1e-6
    assert 0.7 < got["auc"] < 1.0
    for cls in ("0", "1", "macro avg", "weighted avg"):
        for key, v in want["report"][cls].items():
            assert got["report"][cls][key] == pytest.approx(v, abs=1e-6)
    assert got["report"]["accuracy"] == pytest.approx(want["report"]["accuracy"], abs=1e-6)
    assert sorted(os.listdir(tmp_path / "p")) == sorted(os.listdir(tmp_path / "j")) == [
        "confusion_matrix.png", "roc_curve.png"]


def test_evaluate_reads_the_joblib_layout(fits, tmp_path):
    """A directory with only the reference's joblib files is evaluated
    through them, with the native directory's result."""
    path, dirs = fits
    d = tmp_path / "joblib_only"
    d.mkdir()
    for name in ("logistic_model.joblib", "scaler.joblib", "feature_names.json"):
        shutil.copy(os.path.join(dirs["logistic"], name), d / name)
    native = evaluate_mod.evaluate(path, dirs["logistic"], None, device="cpu")
    got = evaluate_mod.evaluate(path, str(d), None, device="cpu")
    assert got["confusion_matrix"] == native["confusion_matrix"]
    assert abs(got["auc"] - native["auc"]) <= 1e-6


# ---------------------------------------------------------------------------
# explain
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", ["logistic", "gbt"])
def test_explain_matches_jax(fits, tmp_path, family):
    """The top-10 names equal the JAX package's, the mean |φ| within 1e-6
    (logistic, the closed form) or rtol 1e-4 / atol 2e-5 (GBT, TreeSHAP);
    the same plot files; φ additive to the model's margin."""
    path, dirs = fits
    got = explain_mod.explain(path, dirs[family], str(tmp_path / "p"), device="cpu")
    want = jax_explain(path, dirs[family], str(tmp_path / "j"))
    assert got["n_rows"] == want["n_rows"] == 600
    assert _top(got) == _top(want)
    np.testing.assert_allclose(list(got["mean_abs_shap"].values()),
                               list(want["mean_abs_shap"].values()), **PHI_TOLS[family])
    assert sorted(os.listdir(tmp_path / "p")) == sorted(os.listdir(tmp_path / "j"))
    assert got["phi"].shape == (600, 30)


def test_explain_max_rows(fits):
    path, dirs = fits
    got = explain_mod.explain(path, dirs["gbt"], None, max_rows=50, device="cpu")
    assert got["n_rows"] == 50 and got["phi"].shape == (50, 30)


# ---------------------------------------------------------------------------
# predict_single
# ---------------------------------------------------------------------------


def test_predict_single_matches_jax(fits, env):
    """Through each package's production loader (the native directory here):
    the same label, P within 1e-6, and a pandas Series or one-row
    DataFrame scores as the dict does."""
    import pandas as pd

    _, dirs = fits
    env.setenv("MODEL_PATH", os.path.join(dirs["logistic"], "model.npz"))
    det, jdet = FraudDetector(), JaxDetector()
    for row in (_DEMO_ROW, {k: v * 0.1 for k, v in _DEMO_ROW.items()}):
        assert det.predict(row) == jdet.predict(row)
        assert abs(det.predict_proba(row) - jdet.predict_proba(row)) <= 1e-6
    series = pd.Series(_DEMO_ROW)
    frame = pd.DataFrame([_DEMO_ROW])
    assert det.predict_proba(series) == det.predict_proba(frame) == \
        det.predict_proba(_DEMO_ROW)
    assert det.predict(list(_DEMO_ROW.values())) == det.predict(_DEMO_ROW)


def test_predict_single_cli(fits, env, capsys):
    _, dirs = fits
    env.setenv("MODEL_PATH", os.path.join(dirs["logistic"], "model.npz"))
    predict_mod.main([])
    out = capsys.readouterr().out
    p = FraudDetector().predict_proba(_DEMO_ROW)
    assert out.startswith("prediction: ") and f"P(fraud) = {p:.6f}" in out


# ---------------------------------------------------------------------------
# validate_auc
# ---------------------------------------------------------------------------


def _registered(store, model_dir):
    reg = TrackingClient(f"file:{store}").registry
    reg.set_alias("fraud", "prod", reg.register("fraud", model_dir))


@pytest.mark.parametrize("family", ["logistic", "gbt"])
def test_validate_auc_matches_jax(fits, tmp_path, env, family):
    """The registered ``@prod`` through each package's gate: the AUC within
    1e-6, the same pass flag, and runs with the same logged params and
    tags."""
    _, dirs = fits
    store = tmp_path / "mlruns"
    env.setenv("MLFLOW_TRACKING_URI", f"file:{store}")
    _registered(store, dirs[family])
    auc, passed = validate_mod.validate_auc(n_samples=2000, device="cpu")
    jauc, jpassed = jax_validate_auc(n_samples=2000)
    assert abs(auc - jauc) <= 1e-6 and passed == jpassed
    client = JaxTrackingClient(f"file:{store}")
    runs = [client.get_run("model-validation", r)
            for r in client.list_runs("model-validation")]
    assert len(runs) == 2
    assert runs[0].params == runs[1].params == {"model_uri": "models:/fraud@prod"}
    assert runs[0].tags == runs[1].tags == {"validation_pass": str(passed)}
    assert sorted(r.latest_metric("auc_score") for r in runs) == \
        pytest.approx(sorted([auc, jauc]), abs=1e-6)


def test_validate_auc_cli_exits_1_below_the_threshold(fits, tmp_path, env, capsys):
    _, dirs = fits
    store = tmp_path / "mlruns"
    env.setenv("MLFLOW_TRACKING_URI", f"file:{store}")
    _registered(store, dirs["logistic"])
    validate_mod.main(["--threshold", "0.5", "--samples", "1000"])
    assert capsys.readouterr().out.strip().endswith("pass=True")
    with pytest.raises(SystemExit) as e:
        validate_mod.main(["--threshold", "1.01", "--samples", "1000"])
    assert e.value.code == 1
    assert capsys.readouterr().out.strip().endswith("pass=False")


def test_validate_auc_without_a_registered_model_raises(env, tmp_path):
    env.setenv("MLFLOW_TRACKING_URI", f"file:{tmp_path}/empty")
    with pytest.raises(FileNotFoundError):
        validate_mod.validate_auc(device="cpu")


# ---------------------------------------------------------------------------
# eda
# ---------------------------------------------------------------------------


def _read_csv(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], np.asarray(rows[1:], np.float64)


def test_eda_matches_jax(fits, tmp_path):
    """The same counts, the same header and row count; the raw columns and
    the labels parse back to the JAX package's values exactly, the two
    scaled columns within 2e-6 relative (the one-column scalers' float32
    sums run in another order)."""
    path, _ = fits
    got = eda_mod.eda(path, str(tmp_path / "p"), str(tmp_path / "p.csv"), device="cpu")
    want = jax_eda(path, str(tmp_path / "j"), str(tmp_path / "j.csv"))
    assert got == want
    header, vals = _read_csv(tmp_path / "p.csv")
    jheader, jvals = _read_csv(tmp_path / "j.csv")
    assert header == jheader
    assert header[-3:] == ["scaled_amount", "scaled_time", "Class"]
    assert vals.shape == jvals.shape == (3000, 31)
    p32, j32 = vals.astype(np.float32), jvals.astype(np.float32)
    exact = [i for i, h in enumerate(header) if not h.startswith("scaled_")]
    assert p32[:, exact].tobytes() == j32[:, exact].tobytes()
    np.testing.assert_allclose(p32[:, -3:-1], j32[:, -3:-1], rtol=2e-6, atol=2e-6)
    assert sorted(os.listdir(tmp_path / "p")) == sorted(os.listdir(tmp_path / "j"))


def test_eda_cli_without_plots(fits, tmp_path, monkeypatch, capsys):
    path, _ = fits
    monkeypatch.chdir(tmp_path)
    eda_mod.main(["--data", path, "--no-plots"])
    assert os.listdir(tmp_path) == ["data"]
    assert "wrote data/processed_data.csv" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# plots without matplotlib
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tool", ["evaluate", "explain", "eda"])
def test_plots_without_matplotlib_raise_before_any_work(fits, tmp_path, monkeypatch, tool):
    """Asked for plots where matplotlib is absent, a tool raises
    ImportError naming it and writes nothing; ``plots_dir=None`` runs."""
    path, dirs = fits
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    calls = {
        "evaluate": lambda plots: evaluate_mod.evaluate(path, dirs["logistic"], plots,
                                                        device="cpu"),
        "explain": lambda plots: explain_mod.explain(path, dirs["logistic"], plots,
                                                     device="cpu"),
        "eda": lambda plots: eda_mod.eda(path, plots, str(tmp_path / "out.csv"),
                                         device="cpu"),
    }
    with pytest.raises(ImportError, match="matplotlib"):
        calls[tool](str(tmp_path / "plots"))
    assert os.listdir(tmp_path) == []
    calls[tool](None)
    assert "plots" not in os.listdir(tmp_path)


@pytest.mark.parametrize("tool", ["evaluate", "explain"])
def test_cli_no_plots(fits, tmp_path, tool, capsys):
    path, dirs = fits
    mod = {"evaluate": evaluate_mod, "explain": explain_mod}[tool]
    mod.main(["--data", path, "--model-dir", dirs["gbt"], "--no-plots",
              "--plots-dir", str(tmp_path / "plots")])
    assert not os.path.exists(tmp_path / "plots")
    assert capsys.readouterr().out


def test_preprocess_cli(fits, tmp_path, capsys):
    path, _ = fits
    preprocess_mod.main(["--data", path, "--out", str(tmp_path / "p.npz"),
                         "--models-dir", str(tmp_path / "m")])
    assert "'n_test': 600" in capsys.readouterr().out
    assert os.path.exists(tmp_path / "p.npz")
