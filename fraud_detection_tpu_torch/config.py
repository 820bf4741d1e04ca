"""Environment-variable configuration for the port's serving and training
slices.

Its own copy of only the knobs these slices read, with the defaults of
``fraud_detection_tpu/config.py`` — except ``DEVICE``, which defaults to
``cuda`` (the port's target). All lookups are lazy (read at call time), so
tests can monkeypatch the environment.
"""

from __future__ import annotations

import os


def _get(name: str, default: str) -> str:
    return os.environ.get(name, default)


def _get_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return int(v) if v else default


def _get_float(name: str, default: float) -> float:
    v = os.environ.get(name)
    return float(v) if v else default


def env_flag(name: str) -> bool | None:
    """Tri-state boolean env flag: ``None`` when unset, else falsy only for
    the conventional off tokens."""
    v = os.environ.get(name)
    if v is None:
        return None
    return v.lower() not in ("0", "false", "no", "off")


def device_backend() -> str:
    """``DEVICE`` — ``cuda`` (default) or ``cpu``."""
    return _get("DEVICE", "cuda")


def data_csv() -> str:
    """``DATA_CSV`` — the training CSV (Kaggle credit-card schema)."""
    return _get("DATA_CSV", "data/creditcard.csv")


def tracking_uri() -> str:
    """``MLFLOW_TRACKING_URI`` — ``file:<dir>`` (or a bare path) selects the
    file tracking store and registry."""
    return _get("MLFLOW_TRACKING_URI", "file:./mlruns")


def experiment_name() -> str:
    return _get("MLFLOW_EXPERIMENT", "fraud-detection")


def model_name() -> str:
    return _get("MLFLOW_MODEL_NAME", "fraud")


def auc_threshold() -> float:
    """``MLFLOW_AUC_THRESHOLD`` — the registry's promotion gate on test AUC."""
    return _get_float("MLFLOW_AUC_THRESHOLD", 0.95)


def model_stage() -> str:
    """``MLFLOW_MODEL_STAGE`` — the alias a gated model is registered under."""
    return _get("MLFLOW_MODEL_STAGE", "prod")


def quant_sigma_range() -> float:
    """``QUANT_SIGMA_RANGE`` — symmetric range (in training sigmas) the int8
    wire's per-feature lattice spans when calibration is derived from the
    scaler profile."""
    return _get_float("QUANT_SIGMA_RANGE", 8.0)


def model_path() -> str:
    """``MODEL_PATH`` — the served artifact; its directory holds
    ``model.npz`` + ``feature_names.json`` (+ ``monitor_profile.npz``)."""
    return _get("MODEL_PATH", "models/logistic_model.joblib")


def scorer_max_batch() -> int:
    return _get_int("SCORER_MAX_BATCH", 1024)


def scorer_max_wait_ms() -> float:
    return _get_float("SCORER_MAX_WAIT_MS", 2.0)


def scorer_fused_flush() -> bool:
    """``SCORER_FUSED_FLUSH`` (default on): score and fold the drift window
    in one flush; ``0`` restores the split path (score, then the
    watchtower's ingest thread folds the window) for A/B measurement."""
    return env_flag("SCORER_FUSED_FLUSH") is not False


def scorer_return_wire() -> str:
    """``SCORER_RETURN_WIRE`` — d2h score wire of the fused flush
    (``float32`` | ``float16`` | ``uint8``). Default ``float32``."""
    return _get("SCORER_RETURN_WIRE", "float32").lower()


def scorer_explain() -> str:
    """``SCORER_EXPLAIN`` — ``off`` | ``topk``: per-row top-k SHAP reason
    codes (linear SHAP or TreeSHAP, by the served family) computed inside
    the fused flush. Default ``off``."""
    return _get("SCORER_EXPLAIN", "off").lower()


def scorer_explain_k() -> int:
    """``SCORER_EXPLAIN_K`` — reason codes per row (clamped to the feature
    count). Default 3."""
    return _get_int("SCORER_EXPLAIN_K", 3)


def explain_background_seed() -> int:
    """``EXPLAIN_BG_SEED`` — numpy seed of the TreeSHAP explainer's
    background subsample (ops/tree_shap.build_tree_explainer): the same
    model, background and seed give the same ``bg_table``. Default 0."""
    return _get_int("EXPLAIN_BG_SEED", 0)


def watchtower_halflife_rows() -> float:
    """Exponential drift-window half-life in rows."""
    return _get_float("WATCHTOWER_HALFLIFE_ROWS", 100_000.0)


def watchtower_min_rows() -> int:
    """Window row floor below which the watchtower reports ``warming``."""
    return _get_int("WATCHTOWER_MIN_ROWS", 512)
