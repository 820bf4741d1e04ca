"""The port's confusion matrix, classification report and ROC points
against the JAX package's on seeded inputs: with ``n_valid`` padding, with
tied scores, and with one class only."""

import numpy as np
import pytest
import torch

from fraud_detection_tpu.ops import metrics as jax_metrics
from fraud_detection_tpu_torch.ops import metrics

torch.set_num_threads(1)


def _inputs(seed: int, n: int = 997, ties: bool = False, one_class: bool = False):
    rng = np.random.default_rng(seed)
    scores = rng.random(n).astype(np.float32)
    if ties:  # a coarse grid: many rows share a score, some sit on 0.5
        scores = np.round(scores * 8) / 8
    labels = (rng.random(n) < 0.2).astype(np.int32)
    if one_class:
        labels[:] = 0
    return scores, labels


CASES = [dict(seed=s, ties=t, one_class=o) for s in (0, 1, 2)
         for t, o in ((False, False), (True, False), (False, True))]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("n_valid", [None, 900])
def test_confusion_matrix_and_report_match_jax(case, n_valid):
    """Counts are exact in float32, so the matrix is bitwise the JAX
    package's, and the report (host arithmetic on it) equal."""
    scores, labels = _inputs(**case)
    pred = (scores >= 0.5).astype(np.int32)
    got = metrics.confusion_matrix(labels, pred, n_valid)
    want = np.asarray(jax_metrics.confusion_matrix(labels, pred, n_valid))
    assert got.dtype == torch.float32
    assert got.numpy().tobytes() == want.tobytes()
    assert metrics.binary_classification_report(labels, pred, n_valid) == \
        jax_metrics.binary_classification_report(labels, pred, n_valid)
    # a boolean prediction and a tensor pair give the same matrix
    same = metrics.confusion_matrix(torch.from_numpy(labels), torch.from_numpy(pred > 0),
                                    n_valid)
    assert torch.equal(same, got)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("num", [2, 50, 200, 400])
def test_roc_curve_points_match_jax(case, num):
    """The same ``>=`` rule on a linspace grid from 1 to 0: the grids within
    one float32 ulp of each other, and fpr/tpr bitwise where no score lies
    on a grid point, NaN tpr alike when there is no positive."""
    scores, labels = _inputs(**case)
    fpr, tpr, thr = metrics.roc_curve_points(scores, labels, num)
    jfpr, jtpr, jthr = (np.asarray(a) for a in jax_metrics.roc_curve_points(scores, labels, num))
    np.testing.assert_allclose(thr.numpy(), jthr, rtol=0, atol=6e-8)
    assert thr[0] == 1.0 and thr[-1] == 0.0 and thr.shape == (num,)
    on_grid = np.isin(scores, np.concatenate([thr.numpy(), jthr]))
    if not on_grid.any():
        assert fpr.numpy().tobytes() == jfpr.tobytes()
        assert tpr.numpy().tobytes() == jtpr.tobytes()
    else:  # the rows on a grid point may fall either side of it
        np.testing.assert_allclose(fpr.numpy(), jfpr, rtol=0,
                                   atol=on_grid.sum() / len(scores))
    assert np.isnan(tpr.numpy()).all() == np.isnan(jtpr).all() == case["one_class"]


def test_metrics_keep_the_inputs_device():
    scores, labels = _inputs(0)
    s, y = torch.from_numpy(scores), torch.from_numpy(labels)
    assert metrics.confusion_matrix(y, s > 0.5).device == s.device
    assert all(t.device == s.device for t in metrics.roc_curve_points(s, y))
