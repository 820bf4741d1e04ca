"""The port's training path against the JAX package on the same numpy
inputs: AUC, both solvers, the SGD checkpointer, the int8-calibration
sidecar, ``train()`` end to end, and artifacts carried across in both
directions."""

import importlib.util
import json
import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from fraud_detection_tpu.ckpt.train_state import SGDCheckpointer as JaxCheckpointer
from fraud_detection_tpu.data.synthetic import generate_synthetic_data
from fraud_detection_tpu.models.logistic import FraudLogisticModel as JaxModel
from fraud_detection_tpu.ops.logistic import logistic_fit_lbfgs as jax_lbfgs
from fraud_detection_tpu.ops.logistic import logistic_fit_sgd as jax_sgd
from fraud_detection_tpu.ops.metrics import auc_roc as jax_auc
from fraud_detection_tpu.ops.quant import derive_calibration as jax_derive_calibration
from fraud_detection_tpu.ops.scaler import scaler_fit as jax_scaler_fit
from fraud_detection_tpu.parallel.mesh import DATA_AXIS
from fraud_detection_tpu.train import train as jax_train
from fraud_detection_tpu_torch import convert
from fraud_detection_tpu_torch.ckpt.train_state import SGDCheckpointer
from fraud_detection_tpu_torch.models import FraudLogisticModel, load_any_model
from fraud_detection_tpu_torch.ops.logistic import (
    _resolve_sample_weight,
    logistic_fit_lbfgs,
    logistic_fit_sgd,
    predict_logits,
    predict_proba,
)
from fraud_detection_tpu_torch.ops.metrics import auc_roc
from fraud_detection_tpu_torch.ops.quant import (
    derive_calibration,
    load_calibration,
    save_calibration,
)
from fraud_detection_tpu_torch.ops.scaler import scaler_fit
from fraud_detection_tpu_torch.train import main, train

torch.set_num_threads(1)

#: the reference's joblib layout, which a logistic save adds where joblib and
#: sklearn are installed (as the JAX package's does)
JOBLIB_FILES = (
    ["columns.joblib", "logistic_model.joblib", "scaler.joblib"]
    if importlib.util.find_spec("sklearn") and importlib.util.find_spec("joblib")
    else []
)


@pytest.fixture(scope="module")
def data():
    """Kaggle-shaped, imbalanced, standardized: 3000 rows × 30, ~3% positive."""
    rng = np.random.default_rng(21)
    n, d = 3000, 30
    x = rng.standard_normal((n, d)).astype(np.float32)
    w = rng.standard_normal(d).astype(np.float32)
    y = (rng.random(n) < 1 / (1 + np.exp(-(x @ w - 4.5)))).astype(np.int32)
    return x, y


def _one_device_mesh():
    return Mesh(np.array(jax.devices()[:1]), (DATA_AXIS,))


# ---------------------------------------------------------------------------
# AUC
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ties", [False, True])
def test_auc_matches_jax(data, ties):
    """|Δ| ≤ 1e-6: the same Mann–Whitney sums in float32."""
    _, y = data
    s = np.random.default_rng(2).random(y.shape[0]).astype(np.float32)
    if ties:
        s = np.round(s * 20) / 20  # many tied scores across classes
    got = float(auc_roc(torch.from_numpy(s), y))
    want = float(jax_auc(s, y))
    assert abs(got - want) <= 1e-6
    assert float(auc_roc(s, y, n_valid=2000)) == pytest.approx(
        float(jax_auc(s, y, n_valid=2000)), abs=1e-6
    )


def test_auc_one_class_raises():
    with pytest.raises(ValueError, match="one class"):
        auc_roc(np.array([0.1, 0.9], np.float32), np.array([1, 1]))
    with pytest.raises(ValueError, match="one class"):
        auc_roc(np.array([0.1, 0.9, 0.5], np.float32), np.array([0, 0, 1]), n_valid=2)


# ---------------------------------------------------------------------------
# solvers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("class_weight", [None, "balanced", {0: 1.0, 1: 3.0}])
def test_sample_weights_match_jax_formula(data, class_weight):
    from fraud_detection_tpu.ops.logistic import _resolve_sample_weight as jax_sw

    _, y = data
    got = _resolve_sample_weight(y, None, class_weight)
    np.testing.assert_array_equal(got, jax_sw(y, None, class_weight))


@pytest.mark.parametrize("class_weight", [None, "balanced"])
def test_lbfgs_optimum_matches_jax(data, class_weight):
    """Strictly convex objective, and both fits stop on max|grad| ≤ tol, so
    both line searches reach the same optimum: coef gap ≤ 1e-5·max|coef|
    (measured 2.1e-7 and 2.0e-7 of it since the float64 loss sum; 1.1e-4
    and 5.4e-5 before it), intercept likewise, AUC gap ≤ 1e-3."""
    x, y = data
    info = {}
    got = logistic_fit_lbfgs(x, y, max_iter=200, class_weight=class_weight, info=info)
    want = jax_lbfgs(x, y, max_iter=200, class_weight=class_weight)
    wc, wb = np.asarray(want.coef), float(want.intercept)
    scale = np.abs(wc).max()
    gap = np.abs(got.coef.numpy() - wc).max()
    print(f"lbfgs coef gap {gap:.3e} (max|coef| {scale:.3f}), "
          f"intercept gap {abs(float(got.intercept) - wb):.3e}, iters {info}")
    assert gap <= 1e-5 * scale
    assert abs(float(got.intercept) - wb) <= 1e-5 * max(scale, abs(wb))
    auc_p = float(auc_roc(predict_proba(got, torch.from_numpy(x)), y))
    auc_j = float(jax_auc(np.asarray(x @ wc + wb), y))
    assert abs(auc_p - auc_j) <= 1e-3
    assert info["n_iter"] >= 1 and info["n_evals"] >= info["n_iter"]


def test_lbfgs_warm_start_from_the_optimum_stays_there(data):
    x, y = data
    p = logistic_fit_lbfgs(x, y, max_iter=200)
    q = logistic_fit_lbfgs(x, y, max_iter=200, warm_start=p)
    assert np.abs(q.coef.numpy() - p.coef.numpy()).max() <= 1e-3


def test_sgd_matches_jax_on_a_one_device_mesh(data):
    """The same epoch scan, permutation stream and cosine lr: only float
    reassociation differs (coef max|Δ| ≤ 1e-4)."""
    x, y = data
    kw = dict(epochs=3, batch_size=512, lr=0.5, seed=3, class_weight="balanced")
    got = logistic_fit_sgd(x, y, **kw)
    want = jax_sgd(x, y, mesh=_one_device_mesh(), **kw)
    gap = np.abs(got.coef.numpy() - np.asarray(want.coef)).max()
    print(f"sgd coef gap {gap:.3e}")
    assert gap <= 1e-4
    assert abs(float(got.intercept) - float(want.intercept)) <= 1e-4


class _Preempted(Exception):
    pass


def test_sgd_resume_is_bitwise_and_reads_jax_checkpoints(data, tmp_path):
    x, y = data
    kw = dict(epochs=4, batch_size=700, lr=0.5, seed=9)
    full = logistic_fit_sgd(x, y, **kw)

    def interrupted(ck, fit, **extra):
        def cb(epoch, *a):
            ck.epoch_callback(epoch, *a)
            if epoch == 1:
                raise _Preempted()
        with pytest.raises(_Preempted):
            fit(x, y, epoch_callback=cb, **kw, **extra)
        return ck.latest()

    # interrupted after epoch 1 and resumed in the port: bitwise equal
    ck = SGDCheckpointer(str(tmp_path / "port"))
    state = interrupted(ck, logistic_fit_sgd)
    assert state["epoch"] == 1 and state["fingerprint"]["ndev"] == 1
    resumed = logistic_fit_sgd(x, y, resume=state, **kw)
    assert torch.equal(resumed.coef, full.coef)
    assert torch.equal(resumed.intercept, full.intercept)

    # a checkpoint the JAX package wrote (one-device mesh) resumes in the
    # port: same files, keys and fingerprint; the remaining epochs differ
    # from the port's own run only by float reassociation
    jck = JaxCheckpointer(str(tmp_path / "jax"))
    interrupted(jck, jax_sgd, mesh=_one_device_mesh())
    jstate = SGDCheckpointer(str(tmp_path / "jax")).latest()
    assert jstate["fingerprint"] == state["fingerprint"]
    from_jax = logistic_fit_sgd(x, y, resume=jstate, **kw)
    assert np.abs(from_jax.coef.numpy() - full.coef.numpy()).max() <= 1e-4

    with pytest.raises(ValueError, match="does not match this fit"):
        logistic_fit_sgd(x, y, resume=state, **dict(kw, lr=0.25))


def test_checkpointer_retention_and_clear(tmp_path):
    ck = SGDCheckpointer(str(tmp_path), keep=2)
    rng = np.random.default_rng(0)
    p = convert.params_from_jax_arrays({"coef": np.ones(3), "intercept": 0.5})
    for e in range(4):
        ck.epoch_callback(e, p, p, rng, {"n": 1})
    assert sorted(os.listdir(tmp_path)) == ["sgd_epoch_00002.npz", "sgd_epoch_00003.npz"]
    assert ck.latest()["epoch"] == 3
    # the JAX package reads the port's files
    assert JaxCheckpointer(str(tmp_path)).latest()["rng_state"] == rng.bit_generator.state
    ck.clear()
    assert ck.latest() is None


# ---------------------------------------------------------------------------
# the int8-calibration sidecar
# ---------------------------------------------------------------------------


def test_calibration_is_bitwise_the_jax_derivation(data, tmp_path):
    x, _ = data
    x = x * np.linspace(0.5, 40.0, 30, dtype=np.float32) + 3.0
    port_scaler = scaler_fit(x)
    jax_scaler = jax_scaler_fit(x)
    got = derive_calibration(port_scaler)
    # the JAX derivation of the same scaler stats
    want = jax_derive_calibration(
        type("S", (), {"mean": port_scaler.mean.numpy(), "scale": port_scaler.scale.numpy()})
    )
    assert got.scale.tobytes() == want.scale.tobytes()
    assert got.sigma_range == want.sigma_range == 8.0
    near = jax_derive_calibration(jax_scaler)
    np.testing.assert_allclose(got.scale, near.scale, rtol=1e-5)
    save_calibration(str(tmp_path), got)
    back = load_calibration(str(tmp_path))
    assert back.scale.tobytes() == got.scale.tobytes()
    from fraud_detection_tpu.ops.quant import load_calibration as jax_load_cal

    assert jax_load_cal(str(tmp_path)).scale.tobytes() == got.scale.tobytes()
    cal = convert.calibration_from_arrays({"scale": want.scale, "sigma_range": 8.0})
    assert cal.scale.tobytes() == want.scale.tobytes()


def test_model_save_stamps_the_calibration(data, tmp_path):
    x, y = data
    scaler = scaler_fit(x * 3.0 + 1.0)
    params = logistic_fit_lbfgs(x, y, max_iter=50)
    FraudLogisticModel(params, scaler, [f"f{i}" for i in range(30)], device="cpu").save(
        str(tmp_path)
    )
    assert sorted(os.listdir(tmp_path)) == sorted([
        "feature_names.json", "model.npz", "quant_calibration.npz", *JOBLIB_FILES,
    ])
    cal = load_calibration(str(tmp_path))
    assert cal.scale.tobytes() == derive_calibration(scaler).scale.tobytes()
    # the JAX model reads it as its own stamped calibration
    assert JaxModel.load(str(tmp_path)).calibration.scale.tobytes() == cal.scale.tobytes()


# ---------------------------------------------------------------------------
# train() end to end, against the JAX trainer on the same CSV
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def synth_csv(tmp_path_factory):
    """A weak fraud signal (shift 0.35 σ, test AUC ~0.89): at the default
    1.5 σ both packages score AUC 1.0 and the comparison says nothing."""
    d = tmp_path_factory.mktemp("synth")
    path = str(d / "synth.csv")
    generate_synthetic_data(path, n_samples=3000, fraud_ratio=0.03, seed=0,
                            shift_scale=0.35)
    return path


@pytest.fixture(scope="module")
def gbt_csv(tmp_path_factory):
    """A stronger signal (shift 0.8 σ) for the forests: at 0.35 σ a small
    forest's test AUC (~0.7) moves by a few hundredths with the SMOTE draws."""
    path = str(tmp_path_factory.mktemp("synth_gbt") / "synth.csv")
    generate_synthetic_data(path, n_samples=3000, fraud_ratio=0.03, seed=0,
                            shift_scale=0.8)
    return path


def _run(fn, tmp, name, monkeypatch, **kw):
    monkeypatch.setenv("MLFLOW_TRACKING_URI", f"file:{tmp}/{name}/mlruns")
    monkeypatch.setenv("MLFLOW_AUC_THRESHOLD", "0.70")
    out = str(tmp / name / "models")
    return fn(n_folds=3, out_dir=out, **kw), out


@pytest.mark.parametrize("use_smote, tol", [(True, 0.01), (False, 1e-3)])
def test_train_matches_jax_train(synth_csv, tmp_path, monkeypatch, use_smote, tol):
    """With SMOTE the two packages draw different synthetic rows (threefry
    against a torch generator), so test AUC and CV mean agree within 0.01;
    without SMOTE the same rows reach the same convex optimum: within 1e-3."""
    got, out = _run(train, tmp_path, "port", monkeypatch, data_csv=synth_csv,
                    use_smote=use_smote, device="cpu")
    want, jout = _run(jax_train, tmp_path, "jax", monkeypatch, data_csv=synth_csv,
                      use_smote=use_smote)
    print(f"smote={use_smote}: port test {got['test_auc']:.6f} cv "
          f"{got['cv_auc_mean']:.6f}; jax test {want['test_auc']:.6f} cv "
          f"{want['cv_auc_mean']:.6f}")
    assert abs(got["test_auc"] - want["test_auc"]) <= tol
    assert abs(got["cv_auc_mean"] - want["cv_auc_mean"]) <= tol
    assert got["registered_version"] == want["registered_version"] == 1
    assert len(got["lbfgs_iters"]) == 4
    assert {"load", "scaler", "final_fit", "baseline", "save"} <= set(got["stages"])
    assert ("fold0_knn" in got["stages"]) == use_smote
    assert sorted(os.listdir(out)) == sorted([
        "feature_names.json", "model.npz", "monitor_profile.npz",
        "quant_calibration.npz", *JOBLIB_FILES,
    ])

    # the port-trained artifact scores within 1e-6 in the JAX package, and
    # the JAX-trained one within 1e-6 in the port
    rows = np.random.default_rng(0).standard_normal((64, 30)).astype(np.float32) * 3
    port_model = load_any_model(out, device="cpu")
    jax_model = JaxModel.load(out)
    np.testing.assert_allclose(
        np.asarray(jax_model.scorer.predict_proba(rows)).reshape(-1),
        port_model.scorer.predict_proba(rows), rtol=0, atol=1e-6,
    )
    assert jax_model.calibration.scale.tobytes() == load_calibration(out).scale.tobytes()
    from_jax = load_any_model(jout, device="cpu")
    np.testing.assert_allclose(
        from_jax.scorer.predict_proba(rows),
        np.asarray(JaxModel.load(jout).scorer.predict_proba(rows)).reshape(-1),
        rtol=0, atol=1e-6,
    )


def test_train_registry_and_gate(synth_csv, tmp_path, monkeypatch):
    """Version 1 on a fresh registry with the alias resolving to the run's
    artifact (the lineage naming no parent), version 2 on a second run with
    parent 1, and no version below the gate — the registered_version
    semantics of tests/test_train.py."""
    from fraud_detection_tpu_torch.tracking import TrackingClient

    first, _ = _run(train, tmp_path, "r", monkeypatch, data_csv=synth_csv, device="cpu")
    second, _ = _run(train, tmp_path, "r", monkeypatch, data_csv=synth_csv, device="cpu",
                     seed=7)
    assert (first["registered_version"], second["registered_version"]) == (1, 2)
    reg = TrackingClient(f"file:{tmp_path}/r/mlruns").registry
    art = reg.resolve("models:/fraud@prod")
    assert art == reg.artifact_dir("fraud", 2)
    assert reg.get_meta("fraud", 2)["lineage"]["parent_version"] == 1
    assert reg.get_meta("fraud", 1)["lineage"]["parent_version"] is None
    assert sorted(os.listdir(art)) == sorted([
        "feature_names.json", "meta.json", "model.npz", "monitor_profile.npz",
        "quant_calibration.npz", *JOBLIB_FILES,
    ])
    served = load_any_model(art, device="cpu")
    x = np.zeros((2, 30), np.float32)
    np.testing.assert_allclose(
        np.asarray(JaxModel.load(art).predict_proba(x)), served.predict_proba(x),
        rtol=1e-5,
    )
    monkeypatch.setenv("MLFLOW_AUC_THRESHOLD", "1.01")  # unreachable
    below = train(data_csv=synth_csv, n_folds=2, out_dir=str(tmp_path / "m"),
                  device="cpu")
    assert below["registered_version"] is None


def test_train_sgd_with_checkpoints_then_clears(synth_csv, tmp_path, monkeypatch):
    ck = tmp_path / "ck"
    got, _ = _run(train, tmp_path, "sgd", monkeypatch, data_csv=synth_csv,
                  device="cpu", solver="sgd", use_smote=False,
                  checkpoint_dir=str(ck))
    assert got["test_auc"] > 0.80 and got["lbfgs_iters"] == []
    assert os.listdir(ck) == []


@pytest.mark.parametrize("use_smote, tol", [(True, 0.01), (False, 1e-3)])
def test_train_gbt_matches_jax_train(gbt_csv, tmp_path, monkeypatch, use_smote, tol):
    """``train(model_family="gbt")`` with a small GBTConfig against the JAX
    trainer: test AUC and CV mean within 1e-3 without SMOTE (the JAX fit is
    sharded over the suite's 8 virtual devices, so its histogram sums
    reassociate) and within 0.01 with SMOTE (other synthetic rows). The
    artifacts load across in both directions and score within 1e-6."""
    from fraud_detection_tpu.models.gbt import FraudGBTModel as JaxGBT
    from fraud_detection_tpu.ops.gbt import GBTConfig as JaxGBTConfig
    from fraud_detection_tpu_torch.models import FraudGBTModel
    from fraud_detection_tpu_torch.ops.gbt import GBTConfig

    kw = dict(n_trees=12, max_depth=4, n_bins=32)
    got, out = _run(train, tmp_path, "port", monkeypatch, data_csv=gbt_csv,
                    use_smote=use_smote, device="cpu", model_family="gbt",
                    gbt_config=GBTConfig(**kw))
    want, jout = _run(jax_train, tmp_path, "jax", monkeypatch, data_csv=gbt_csv,
                      use_smote=use_smote, model_family="gbt",
                      gbt_config=JaxGBTConfig(**kw))
    print(f"gbt smote={use_smote}: port test {got['test_auc']:.6f} cv "
          f"{got['cv_auc_mean']:.6f}; jax test {want['test_auc']:.6f} cv "
          f"{want['cv_auc_mean']:.6f}")
    assert abs(got["test_auc"] - want["test_auc"]) <= tol
    assert abs(got["cv_auc_mean"] - want["cv_auc_mean"]) <= tol
    assert got["registered_version"] == want["registered_version"] == 1
    assert got["lbfgs_iters"] == []
    assert {"fold0_fit", "final_fit", "save"} <= set(got["stages"])
    assert ("final_knn" in got["stages"]) == use_smote
    assert sorted(os.listdir(out)) == [
        "feature_names.json", "model.npz", "monitor_profile.npz",
        "quant_calibration.npz",
    ]
    rows = np.random.default_rng(0).standard_normal((64, 30)).astype(np.float32) * 3
    port_model = load_any_model(out, device="cpu")
    assert isinstance(port_model, FraudGBTModel)
    assert port_model.background.shape == (128, 30)
    np.testing.assert_allclose(
        np.asarray(JaxGBT.load(out).scorer.predict_proba(rows)).reshape(-1),
        port_model.scorer.predict_proba(rows), rtol=0, atol=1e-6,
    )
    np.testing.assert_allclose(
        load_any_model(jout, device="cpu").scorer.predict_proba(rows),
        np.asarray(JaxGBT.load(jout).scorer.predict_proba(rows)).reshape(-1),
        rtol=0, atol=1e-6,
    )


def test_main_trains_gbt(synth_csv, tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("DEVICE", "cpu")
    monkeypatch.setenv("MLFLOW_TRACKING_URI", f"file:{tmp_path}/mlruns")
    monkeypatch.setattr(
        "fraud_detection_tpu_torch.train.GBTConfig",
        lambda: __import__("fraud_detection_tpu_torch.ops.gbt", fromlist=["GBTConfig"])
        .GBTConfig(n_trees=3, max_depth=2, n_bins=16),
    )
    main(["--data", synth_csv, "--model", "gbt", "--folds", "2", "--no-register",
          "--out-dir", str(tmp_path / "m")])
    assert "test_auc" in capsys.readouterr().out
    with np.load(tmp_path / "m" / "model.npz") as z:
        assert z["gbt_split_feature"].shape == (3, 3)


def test_main_refuses_unported_families(synth_csv, tmp_path, monkeypatch, capsys):
    """``--ledger`` trains the ledger-widened family and ``--wide`` the wide
    family (runs on the synthetic CSV, each sidecar stamped), as does
    ``WIDE_ENABLED``; ``--profile-dir`` (no longer refused) runs the
    trainer inside a device trace and writes its ``trace.json``."""
    monkeypatch.setenv("DEVICE", "cpu")
    monkeypatch.setenv("MLFLOW_TRACKING_URI", f"file:{tmp_path}/mlruns")
    monkeypatch.setenv("LEDGER_SLOTS", "64")
    main(["--data", synth_csv, "--ledger", "--folds", "2", "--no-register",
          "--out-dir", str(tmp_path / "m")])
    assert "test_auc" in capsys.readouterr().out
    with np.load(tmp_path / "m" / "ledger_state.npz") as z:
        assert int(z["slots"]) == 64 and z["acc"].shape == (64, 3)
    assert len(FraudLogisticModel.load(str(tmp_path / "m"), device="cpu").feature_names) == 34
    monkeypatch.setenv("WIDE_BUCKETS", "1024")
    main(["--data", synth_csv, "--wide", "--no-register", "--out-dir", str(tmp_path / "w")])
    assert "test_auc" in capsys.readouterr().out
    with np.load(tmp_path / "w" / "wide_params.npz") as z:
        assert int(z["log2_buckets"]) == 10 and z["table"].shape == (1024,)
    wide = load_any_model(str(tmp_path / "w"), device="cpu")
    assert wide.scorer.family == "wide" and len(wide.feature_names) == 34
    main(["--data", synth_csv, "--folds", "2", "--no-register", "--out-dir",
          str(tmp_path / "p"), "--profile-dir", str(tmp_path / "trace")])
    assert "test_auc" in capsys.readouterr().out
    with open(tmp_path / "trace" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
    monkeypatch.setenv("WIDE_ENABLED", "1")
    m = train(data_csv=synth_csv, register=False, out_dir=str(tmp_path / "e"), device="cpu")
    assert "cv_auc_mean" not in m and os.path.exists(tmp_path / "e" / "wide_params.npz")


def test_predict_helpers_and_convert_round_trip(data):
    x, y = data
    p = logistic_fit_lbfgs(x, y, max_iter=30)
    xt = torch.from_numpy(x[:5])
    np.testing.assert_allclose(
        predict_proba(p, xt).numpy(), 1 / (1 + np.exp(-predict_logits(p, xt).numpy())),
        rtol=1e-6,
    )
    s = jax_scaler_fit(x)
    ps = convert.scaler_from_arrays({f: np.asarray(getattr(s, f)) for f in s._fields})
    np.testing.assert_array_equal(ps.mean.numpy(), np.asarray(s.mean))
    np.testing.assert_array_equal(ps.var.numpy(), np.asarray(s.var))
    jp = jax_lbfgs(x, y, max_iter=30)
    pp = convert.params_from_jax_arrays({"coef": np.asarray(jp.coef),
                                         "intercept": np.asarray(jp.intercept)})
    np.testing.assert_array_equal(pp.coef.numpy(), np.asarray(jp.coef))
