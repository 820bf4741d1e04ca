"""Environment-variable configuration for the port's serving slice.

Its own copy of only the knobs this slice reads, with the defaults of
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
    """``SCORER_EXPLAIN`` — ``off`` | ``topk``: per-row top-k linear-SHAP
    reason codes computed inside the fused flush. Default ``off``."""
    return _get("SCORER_EXPLAIN", "off").lower()


def scorer_explain_k() -> int:
    """``SCORER_EXPLAIN_K`` — reason codes per row (clamped to the feature
    count). Default 3."""
    return _get_int("SCORER_EXPLAIN_K", 3)


def watchtower_halflife_rows() -> float:
    """Exponential drift-window half-life in rows."""
    return _get_float("WATCHTOWER_HALFLIFE_ROWS", 100_000.0)


def watchtower_min_rows() -> int:
    """Window row floor below which the watchtower reports ``warming``."""
    return _get_int("WATCHTOWER_MIN_ROWS", 512)
