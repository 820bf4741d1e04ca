"""StandardScaler + LogisticRegression, and its exact interventional SHAP
against the scaler's mean, in float64."""

from __future__ import annotations

import numpy as np


def logistic_margin(w: dict, x: np.ndarray) -> np.ndarray:
    z = (np.asarray(x, np.float64) - w["mean"]) / w["scale"]
    return z @ w["coef"] + float(w["intercept"])


def logistic_shap(w: dict, x: np.ndarray) -> np.ndarray:
    """φ_j = coef_j · (x_j − μ_j) / σ_j: the scaled feature's share of the
    margin against a background at the mean."""
    return (np.asarray(x, np.float64) - w["mean"]) / w["scale"] * w["coef"]
