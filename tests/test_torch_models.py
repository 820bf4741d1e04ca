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
def test_unported_families_raise(tmp_path, sidecar, rows, request):
    """No sidecar raises any more. A ledger sidecar beside a logistic model
    loads the ledger-widened family, a wide sidecar the wide family (both
    written by the JAX package), whose base rows score as in the JAX
    package; (None) a GBT forest carrying a ledger sidecar loads as the
    forest it is, as the JAX loader does."""
    from fraud_detection_tpu.ledger.state import LEDGER_FEATURE_NAMES, LedgerSpec, init_state
    from fraud_detection_tpu.ledger.state import save_ledger as jax_save_ledger
    from fraud_detection_tpu.models import load_any_model as jax_load_any_model
    from fraud_detection_tpu.ops.logistic import LogisticParams as JaxParams
    from fraud_detection_tpu.ops.scaler import scaler_fit as jax_scaler_fit

    d = str(tmp_path / "m")
    spec = LedgerSpec(n_base=30, slots=64, halflife_s=600.0, amount_col=-1,
                      null_features=np.asarray([1.0, 40.0, 3.0, 0.1], np.float32))
    if sidecar is None:  # a GBT forest carrying a ledger sidecar
        shutil.copytree(request.getfixturevalue("gbt_dirs"), d)
        jax_save_ledger(d, spec, init_state(64))
    elif sidecar == "ledger_state.npz":  # a widened logistic model, by JAX
        rng = np.random.default_rng(7)
        xw = np.concatenate([rows[:512], np.abs(rng.standard_normal((512, 4)))], axis=1)
        names = JaxModel.load(MODELS).feature_names + list(LEDGER_FEATURE_NAMES)
        params = JaxParams(coef=rng.standard_normal(34).astype(np.float32) * 0.2,
                           intercept=np.float32(-0.4))
        JaxModel(params, jax_scaler_fit(xw.astype(np.float32)), names,
                 ledger_spec=spec).save(d)
    else:  # a wide logistic model, by JAX
        from fraud_detection_tpu.ops.crosses import CrossSpec, widen_scaler

        rng = np.random.default_rng(8)
        cspec = CrossSpec(n_base=30, log2_buckets=10, amount_col=29)
        names = JaxModel.load(MODELS).feature_names + list(cspec.cross_names)
        params = JaxParams(coef=np.concatenate([rng.standard_normal(30).astype(np.float32) * 0.2,
                                                np.ones(4, np.float32)]),
                           intercept=np.float32(-0.4))
        JaxModel(params, widen_scaler(jax_scaler_fit(rows[:512]), 4), names, wide_spec=cspec,
                 wide_table=(rng.standard_normal(1024) * 0.3).astype(np.float32)).save(d)
    port, jm = load_any_model(d, device="cpu"), jax_load_any_model(d)
    assert type(port).__name__ == type(jm).__name__
    if sidecar is None:
        assert getattr(port, "ledger_spec", None) is None
    elif sidecar == "wide_params.npz":
        assert port.scorer.family == jm.scorer.family == "wide"
        assert port.wide_spec == tuple(jm.wide_spec) and port.scorer.staging_features == 30
        np.testing.assert_array_equal(port.wide_table, jm.wide_table)
    else:
        assert port.ledger_spec.n_features == 34 and port.scorer.staging_features == 30
    np.testing.assert_allclose(
        port.scorer.predict_proba(rows[:64]),
        np.asarray(jm.scorer.predict_proba(rows[:64])).reshape(-1), rtol=0, atol=1e-6,
    )


@pytest.fixture(scope="module")
def gbt_dirs(tmp_path_factory, rows):
    """One forest, fitted by the JAX package on scaled rows, saved by the
    JAX model wrapper (scaler folded, calibration stamped, background)."""
    from fraud_detection_tpu.models.gbt import FraudGBTModel as JaxGBT
    from fraud_detection_tpu.ops.gbt import GBTConfig, gbt_fit
    from fraud_detection_tpu.ops.scaler import scaler_fit as jax_scaler_fit

    rng = np.random.default_rng(3)
    x = rows[:1200]
    scaler = jax_scaler_fit(x)
    xs = np.asarray(jax_scaler_transform(scaler, x))
    y = (xs @ rng.standard_normal(30).astype(np.float32) > 1.5).astype(np.int32)
    forest = gbt_fit(xs, y, GBTConfig(n_trees=12, max_depth=4, n_bins=32))
    names = JaxModel.load(MODELS).feature_names
    d = str(tmp_path_factory.mktemp("gbt") / "jax")
    JaxGBT(forest, names, scaler=scaler, background=x[:64]).save(d)
    return d


def test_gbt_artifacts_load_across_in_both_directions(gbt_dirs, rows, tmp_path):
    """A forest the JAX package wrote scores within 1e-6 in the port (and
    explains within TreeSHAP's kernel tolerance); the port's re-save loads
    in the JAX package with the same arrays and scores."""
    from fraud_detection_tpu.models.gbt import FraudGBTModel as JaxGBT
    from fraud_detection_tpu_torch.models import FraudGBTModel

    jdir = gbt_dirs
    port = load_any_model(jdir, device="cpu")
    assert isinstance(port, FraudGBTModel) and artifact_kind(jdir) == "gbt"
    jm = JaxGBT.load(jdir)
    x = rows[1200:1500]
    np.testing.assert_allclose(
        port.scorer.predict_proba(x), np.asarray(jm.scorer.predict_proba(x)).reshape(-1),
        rtol=0, atol=1e-6,
    )
    assert port.calibration.scale.tobytes() == jm.calibration.scale.tobytes()
    phi, ev = port.explain_batch(x[:16])
    jphi, jev = jm.explain_batch(x[:16])
    np.testing.assert_allclose(phi, jphi, rtol=1e-4, atol=2e-5)
    assert ev == pytest.approx(jev, abs=1e-6)

    out = str(tmp_path / "port")
    port.save(out)
    with np.load(os.path.join(jdir, "model.npz")) as a, np.load(os.path.join(out, "model.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].tobytes() == b[k].tobytes() and a[k].dtype == b[k].dtype, k
    back = JaxGBT.load(out)
    np.testing.assert_allclose(
        np.asarray(back.scorer.predict_proba(x)).reshape(-1), port.scorer.predict_proba(x),
        rtol=0, atol=1e-6,
    )
    assert sorted(os.listdir(out)) == ["feature_names.json", "model.npz", "quant_calibration.npz"]


@pytest.mark.parametrize("wire", ["bfloat16", "int8"])
def test_narrow_wires_build_and_int8_needs_a_calibration(wire):
    """The narrow wires are served now (no ``NotImplementedError``): bf16
    builds from the weights alone; int8 needs a calibration or, for the
    linear family, a scaler to derive one from, and raises ``ValueError``
    (JAX's message) without; an unknown wire raises ``ValueError``."""
    from fraud_detection_tpu_torch.ops.gbt import GBTModel
    from fraud_detection_tpu_torch.ops.quant import QuantCalibration
    from fraud_detection_tpu_torch.ops.scorer import GBTBatchScorer

    params = LogisticParams(torch.zeros(4), torch.tensor(0.0))
    forest = GBTModel(torch.zeros((1, 1), dtype=torch.int32), torch.zeros((1, 1), dtype=torch.int32),
                      torch.zeros((1, 2)), torch.zeros((4, 3)), torch.tensor(0.0))
    cal = QuantCalibration(scale=np.full(4, 0.5, np.float32))
    if wire == "int8":
        with pytest.raises(ValueError, match="stamped QuantCalibration or scaler"):
            BatchScorer(params, io_dtype=wire, device="cpu")
        with pytest.raises(ValueError, match="needs a stamped"):
            GBTBatchScorer(forest, io_dtype=wire)
    lin = BatchScorer(params, io_dtype=wire, calibration=cal, device="cpu")
    gbt = GBTBatchScorer(forest, io_dtype=wire, calibration=cal)
    for scorer in (lin, gbt):
        assert scorer.io_dtype == wire
        assert (scorer.fused_spec().dequant_scale is not None) == (wire == "int8")
        assert scorer.predict_proba(np.ones((3, 4), np.float32)).shape == (3,)
    for bad in ("float16", "uint8"):
        with pytest.raises(ValueError, match="float32|bfloat16|int8"):
            BatchScorer(params, io_dtype=bad, device="cpu")
        with pytest.raises(ValueError, match="float32|bfloat16|int8"):
            GBTBatchScorer(forest, io_dtype=bad)


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
