"""Shared estimator surface for the fraud model families (the reference
clients' ``predict``/``predict_proba`` plus the explanation path).
Subclasses provide a ``_scorer`` (the :class:`~fraud_detection_tpu_torch.
ops.scorer._BucketedScorer` protocol) and the family's SHAP."""

from __future__ import annotations

import numpy as np


class FraudModelBase:
    feature_names: list[str]
    _scorer = None  # set by subclass __init__

    @property
    def scorer(self):
        return self._scorer

    def predict_proba(self, x: np.ndarray) -> np.ndarray:
        """(n, 2) array [P(0), P(1)] like sklearn."""
        p1 = self._scorer.predict_proba(x)
        return np.stack([1.0 - p1, p1], axis=1)

    def predict(self, x: np.ndarray, threshold: float = 0.5) -> np.ndarray:
        return self._scorer.predict(x, threshold)

    def score_one(self, features: dict | list) -> tuple[int, float]:
        """Validate + order one row by feature name, return (label, P(1))."""
        row = self.prepare_row(features)
        p = float(self._scorer.predict_proba(row[None, :])[0])
        return int(p >= 0.5), p

    def prepare_row(self, features: dict | list) -> np.ndarray:
        """Reorder dict input to training feature order; validate arity."""
        if isinstance(features, dict):
            missing = [n for n in self.feature_names if n not in features]
            if missing:
                raise ValueError(f"missing features: {missing[:5]}")
            vals = [float(features[n]) for n in self.feature_names]
        else:
            vals = [float(v) for v in features]
            if len(vals) != len(self.feature_names):
                raise ValueError(
                    f"expected {len(self.feature_names)} features, got {len(vals)}"
                )
        return np.asarray(vals, dtype=np.float32)

    def raw_explainer(self):
        """The family's explainer over *raw* inputs, built once and cached."""
        raise NotImplementedError

    def explain_one(self, row: np.ndarray) -> tuple[np.ndarray, float]:
        """((d,) φ, expected_value) in margin space — the SHAP worker's
        surface."""
        phi, ev = self.explain_batch(np.asarray(row, np.float32)[None, :])
        return phi[0], ev

    def explain_batch(self, x: np.ndarray) -> tuple[np.ndarray, float]:
        """((n, d) φ, expected_value) in margin space."""
        raise NotImplementedError
