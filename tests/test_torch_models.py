"""The port's artifacts, model and scorer against the JAX package's, on the
committed flagship artifact ``models/model.npz`` (Kaggle width, d = 30) and
real rows of ``data/creditcard.csv``."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from fraud_detection_tpu.ckpt.checkpoint import load_artifacts as jax_load_artifacts
from fraud_detection_tpu.models.logistic import FraudLogisticModel as JaxModel
from fraud_detection_tpu.ops.scaler import scaler_transform as jax_scaler_transform
from fraud_detection_tpu_torch.ckpt.checkpoint import artifact_kind, load_artifacts
from fraud_detection_tpu_torch.convert import logistic_from_arrays
from fraud_detection_tpu_torch.models import FraudLogisticModel, load_any_model
from fraud_detection_tpu_torch.ops.logistic import LogisticParams
from fraud_detection_tpu_torch.ops.scaler import scaler_transform
from fraud_detection_tpu_torch.ops.scorer import BatchScorer, StagingPool, _bucket

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = os.path.join(ROOT, "models")


@pytest.fixture(scope="module")
def rows():
    data = np.loadtxt(
        os.path.join(ROOT, "data", "creditcard.csv"), delimiter=",",
        skiprows=1, max_rows=1500, dtype=np.float32,
    )
    return data[:, :30]


@pytest.fixture(scope="module")
def jax_model():
    return JaxModel.load(MODELS)


def test_flagship_scores_match_jax(rows, jax_model):
    """Tolerance 1e-6: both fold the scaler in f32 and sum x·w′ in f32 in
    different orders; the sigmoid's slope is at most 1/4."""
    port = FraudLogisticModel.load(MODELS, device="cpu")
    assert port.feature_names == jax_model.feature_names
    got = port.scorer.predict_proba(rows)
    want = np.asarray(jax_model.scorer.predict_proba(rows))
    assert got.shape == (rows.shape[0],)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        port.predict_proba(rows[:10]), np.asarray(jax_model.predict_proba(rows[:10])),
        rtol=0, atol=1e-6,
    )
    assert port.score_one(rows[0].tolist())[0] == jax_model.score_one(rows[0].tolist())[0]


def test_converted_model_matches_jax(rows, jax_model):
    """convert.logistic_from_arrays from np.asarray of the JAX params —
    NamedTuple field names and model.npz keys both."""
    p, s = jax_model.params, jax_model.scaler
    by_fields = {
        "coef": np.asarray(p.coef), "intercept": np.asarray(p.intercept),
        **{f: np.asarray(getattr(s, f)) for f in s._fields},
    }
    with np.load(os.path.join(MODELS, "model.npz")) as z:
        by_keys = {k: z[k] for k in z.files}
    want = np.asarray(jax_model.scorer.predict_proba(rows))
    for arrays in (by_fields, by_keys):
        m = logistic_from_arrays(arrays, jax_model.feature_names, device="cpu")
        np.testing.assert_allclose(m.scorer.predict_proba(rows), want, rtol=0, atol=1e-6)


def test_explain_batch_matches_jax(rows, jax_model):
    port = FraudLogisticModel.load(MODELS, device="cpu")
    phi, ev = port.explain_batch(rows[:64])
    jphi, jev = jax_model.explain_batch(rows[:64])
    np.testing.assert_allclose(phi, jphi, rtol=1e-6, atol=1e-6)
    assert ev == pytest.approx(jev, abs=1e-5)


def test_scaler_transform_matches_jax(rows, jax_model):
    port = FraudLogisticModel.load(MODELS, device="cpu")
    got = scaler_transform(port.scaler, torch.from_numpy(rows)).numpy()
    want = np.asarray(jax_scaler_transform(jax_model.scaler, rows))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_artifacts_interchange(tmp_path, rows):
    """The port writes model.npz in the JAX layout and reads the JAX one."""
    port = FraudLogisticModel.load(MODELS, device="cpu")
    out = str(tmp_path / "m")
    port.save(out)
    params, scaler, names = jax_load_artifacts(out)
    ref_p, ref_s, ref_n = load_artifacts(MODELS)
    np.testing.assert_array_equal(np.asarray(params.coef), ref_p.coef.numpy())
    np.testing.assert_array_equal(np.asarray(scaler.scale), ref_s.scale.numpy())
    assert names == ref_n
    np.testing.assert_array_equal(
        JaxModel.load(out).scorer.predict_proba(rows[:32]),
        JaxModel.load(MODELS).scorer.predict_proba(rows[:32]),
    )
    assert artifact_kind(out) == "logistic"
    assert artifact_kind(str(tmp_path / "none")) == "absent"


@pytest.mark.parametrize("sidecar", [None, "ledger_state.npz", "wide_params.npz"])
def test_unported_families_raise(tmp_path, sidecar):
    d = str(tmp_path / "m")
    if sidecar is None:  # a GBT forest
        os.makedirs(d)
        np.savez(os.path.join(d, "model.npz"), gbt_leaf_value=np.zeros(3, np.float32))
        with open(os.path.join(d, "feature_names.json"), "w") as f:
            json.dump(["a"], f)
    else:
        shutil.copytree(MODELS, d)
        np.savez(os.path.join(d, sidecar), x=np.zeros(1))
    with pytest.raises(NotImplementedError, match="not ported"):
        load_any_model(d, device="cpu")


@pytest.mark.parametrize("wire", ["bfloat16", "int8"])
def test_narrow_wires_raise_not_implemented(wire):
    params = LogisticParams(torch.zeros(4), torch.tensor(0.0))
    with pytest.raises(NotImplementedError, match="queue 8"):
        BatchScorer(params, io_dtype=wire, device="cpu")


def test_buckets_and_staging_pool_reuse():
    assert [_bucket(n) for n in (1, 8, 9, 1000, 1024, 1025)] == [
        8, 8, 16, 1024, 1024, 2048,
    ]
    pool = StagingPool(30)
    slot = pool.acquire(64)
    pool.release(slot)
    assert pool.acquire(64) is slot
    slot.ensure_explain(3)
    slot.ensure_explain(3)
    assert pool.allocations == 2  # the slot + its explain buffers, once


def test_device_resolution(monkeypatch):
    from fraud_detection_tpu_torch import config
    from fraud_detection_tpu_torch.device import resolve_device

    monkeypatch.delenv("DEVICE", raising=False)
    assert config.device_backend() == "cuda"
    assert resolve_device("cpu") == torch.device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="DEVICE=cpu"):
            resolve_device()
        with pytest.raises(RuntimeError, match="cuda"):
            FraudLogisticModel.load(MODELS)
