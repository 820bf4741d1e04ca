"""The plain reference the benchmark judges the program by: NumPy for the
served scorers (:mod:`.logistic`, :mod:`.forest`) and plain PyTorch in
float64 for the booster (:mod:`.booster`). It imports neither JAX nor the
program, and reads the program's outputs only to judge them."""

from __future__ import annotations

import numpy as np


def score(cfg: dict, weights: dict, x: np.ndarray) -> np.ndarray:
    """P(fraud) (n,) float64 of raw rows under the configuration's family."""
    if cfg["family"] == "gbt":
        from portbench.reference.forest import forest_margin

        margin = forest_margin(weights, x)
    else:
        from portbench.reference.logistic import logistic_margin

        margin = logistic_margin(weights, x)
    return 1.0 / (1.0 + np.exp(-margin))


def explain(cfg: dict, weights: dict, x: np.ndarray) -> np.ndarray:
    """SHAP values (n, d) float64 in margin space."""
    if cfg["family"] == "gbt":
        from portbench.reference.forest import forest_shap

        return forest_shap(weights, x)
    from portbench.reference.logistic import logistic_shap

    return logistic_shap(weights, x)


def topk(phi: np.ndarray, k: int) -> np.ndarray:
    """Indices (n, k) of the k highest signed attributions, ties to the
    lower feature index."""
    return np.argsort(-phi, axis=1, kind="stable")[:, :k]
