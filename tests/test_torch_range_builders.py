"""The range's builders on the port against the JAX package's, on the CPU,
from the same seeds:

- ``build_model``: the rows and the ground truth bitwise; the L-BFGS
  champion's coefficients and intercept within 1e-6 · max(1, max|coef|) of
  JAX's (both solvers stop on max|grad| ≤ 1e-5, the port's loss summed in
  float64; ≤ 1.1e-7 of it measured; 1.97e-4 at seed 2027 before the float64
  sum); on ``x_base[:1024]`` one champion's scores within 1e-6 through
  either package, the two fits' scores no further apart than their
  parameter gap explains, the port's within 1e-6 of float64 on its own
  parameters;
- ``build_gbt_model``: the same forest split for split (feature and bin of
  every node, the folded bin edges within 1e-6), leaves within 1e-5, served
  on the int8 wire; scores on ``x_base[:1024]`` within 1e-5;
- ``build_ledger_model``: the same spec (slots, ``log2_slots``,
  ``row_keys("mule-1")``, the null features within 1e-5), the replayed
  table within 1e-5 (fingerprints equal), the widened champion's
  coefficients within 1e-4;
- ``build_lifecycle_env``: the champion registered at ``@prod`` v1, the
  base CSV byte for byte JAX's.
"""

import numpy as np
import pytest
import torch

from fraud_detection_tpu.range import scenarios as jsc
from fraud_detection_tpu_torch.models.logistic import FraudLogisticModel
from fraud_detection_tpu_torch.ops.logistic import LogisticParams
from fraud_detection_tpu_torch.ops.scaler import ScalerParams
from fraud_detection_tpu_torch.range import scenarios as tsc

torch.set_num_threads(1)


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@pytest.mark.parametrize("seed", [7, 2026, 2027])
def test_build_model_matches_jax(seed):
    """Both L-BFGS solvers stop on max|grad| ≤ 1e-5 (the port's loss
    summed in float64): coefficients within 1e-6 · max(1, max|coef|); one
    champion's scores within 1e-6 through either package; the two fits'
    scores no further apart than their parameter gap explains
    (0.25 · (|Δb| + |x|·|Δw|) a row, + 2e-6), and the port's within 1e-6 of
    float64 on its own parameters."""
    j = jsc.build_model(seed=seed)
    t = tsc.build_model(seed=seed, device="cpu")
    assert t.x_base.tobytes() == j.x_base.tobytes()
    assert t.y_base.tobytes() == j.y_base.tobytes()
    assert t.w_true.tobytes() == j.w_true.tobytes()
    tc, jc = _np(t.model.params.coef), _np(j.model.params.coef)
    bound = 1e-6 * max(1.0, float(np.abs(jc).max()))
    gap = float(np.abs(tc - jc).max())
    print(f"seed {seed}: coef gap {gap:.3e}, bound {bound:.3e}")
    assert gap <= bound
    assert abs(float(_np(t.model.params.intercept)) - float(_np(j.model.params.intercept))) <= bound
    x = j.x_base[:1024]
    pj = np.asarray(j.model.scorer.predict_proba(x))
    # the same champion served by both packages: within 1e-6
    same = FraudLogisticModel(
        LogisticParams(coef=torch.from_numpy(jc.copy()),
                       intercept=torch.tensor(float(_np(j.model.params.intercept)))),
        ScalerParams(**{f: torch.from_numpy(np.asarray(getattr(j.model.scaler, f)).copy())
                        for f in ("mean", "scale", "var", "n_samples")}),
        tsc.KAGGLE, device="cpu")
    np.testing.assert_allclose(same.scorer.predict_proba(x), pj, rtol=0, atol=1e-6)
    # the two fits: the scores differ by no more than the fit gap explains
    pt = t.model.scorer.predict_proba(x)
    sc = t.model.scaler
    xs = (x.astype(np.float64) - _np(sc.mean)) / _np(sc.scale)
    db = abs(float(_np(t.model.params.intercept)) - float(_np(j.model.params.intercept)))
    explained = 0.25 * (db + np.abs(xs) @ np.abs(tc - jc).astype(np.float64))
    assert np.all(np.abs(pt.astype(np.float64) - pj) <= explained + 2e-6)
    print(f"seed {seed}: score gap {np.abs(pt - pj).max():.3e}")
    z = xs @ tc.astype(np.float64) + float(_np(t.model.params.intercept))
    np.testing.assert_allclose(pt, 1.0 / (1.0 + np.exp(-z)), rtol=0, atol=1e-6)
    assert t.profile.feature_names == tuple(j.profile.feature_names)
    assert t.profile.n_rows == j.profile.n_rows


def test_build_gbt_model_matches_jax():
    j = jsc.build_gbt_model(seed=2027)
    t = tsc.build_gbt_model(seed=2027, device="cpu")
    assert t.model.scorer.io_dtype == "int8" == j.model.scorer.io_dtype
    jm, tm = j.model.model, t.model.model
    np.testing.assert_array_equal(_np(tm.split_feature), _np(jm.split_feature))
    np.testing.assert_array_equal(_np(tm.split_bin), _np(jm.split_bin))
    np.testing.assert_allclose(_np(tm.leaf_value), _np(jm.leaf_value), rtol=0, atol=1e-5)
    np.testing.assert_allclose(_np(tm.bin_edges), _np(jm.bin_edges), rtol=1e-6, atol=1e-6)
    x = j.x_base[:1024]
    np.testing.assert_allclose(t.model.scorer.predict_proba(x),
                               np.asarray(j.model.scorer.predict_proba(x)), rtol=0, atol=1e-5)


def test_build_ledger_model_matches_jax():
    j, jspec, jstate, jt = jsc.build_ledger_model(seed=2026)
    t, tspec, tstate, tt = tsc.build_ledger_model(seed=2026, device="cpu")
    assert jt == tt
    assert (tspec.slots, tspec.log2_slots, tspec.n_base, tspec.amount_col) == (
        jspec.slots, jspec.log2_slots, jspec.n_base, jspec.amount_col)
    assert tspec.row_keys("mule-1") == tuple(jspec.row_keys("mule-1"))
    np.testing.assert_allclose(tspec.null_features, np.asarray(jspec.null_features),
                               rtol=1e-5, atol=1e-5)
    for name in ("count", "amount_sum", "amount_sumsq", "last_ts"):
        np.testing.assert_allclose(np.asarray(getattr(tstate, name)),
                                   np.asarray(getattr(jstate, name)), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(tstate.fingerprint),
                                  np.asarray(jstate.fingerprint))
    np.testing.assert_allclose(_np(t.model.params.coef), _np(j.model.params.coef),
                               rtol=0, atol=1e-4)
    assert t.model.feature_names == list(j.model.feature_names)


def test_build_lifecycle_env_matches_jax(tmp_path):
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    je = jsc.build_lifecycle_env(str(tmp_path / "j"), seed=7)
    te = tsc.build_lifecycle_env(str(tmp_path / "t"), seed=7, device="cpu")
    try:
        assert te["v1"] == je["v1"] == 1
        assert te["registry"].get_version_by_alias("fraud", "prod") == 1
        with open(tmp_path / "j" / "base.csv", "rb") as a, open(tmp_path / "t" / "base.csv", "rb") as b:
            assert a.read() == b.read()
        assert te["store"].get_state("fraud")["state"] == je["store"].get_state("fraud")["state"]
    finally:
        je["store"].close()
        te["store"].close()
