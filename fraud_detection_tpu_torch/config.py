"""Environment-variable configuration for the port's serving, explain,
training and offline-tool slices.

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


def native_csv() -> bool:
    """``NATIVE_CSV`` — parse CSVs with the port's C++ reader
    (``data/native.py``); only ``0`` chooses ``np.loadtxt``. Default on."""
    return _get("NATIVE_CSV", "1") != "0"


def tracking_uri() -> str:
    """``MLFLOW_TRACKING_URI`` — ``file:<dir>`` (or a bare path) selects the
    file tracking store and registry, ``http(s)://host:port`` a tracking
    server."""
    return _get("MLFLOW_TRACKING_URI", "file:./mlruns")


def registry_cache() -> str:
    """``FRAUD_REGISTRY_CACHE`` — where the HTTP registry client unpacks the
    versions it downloads. Default ``~/.cache/fraud-detection-tpu/registry``
    (the JAX package's, so both share one cache)."""
    return _get(
        "FRAUD_REGISTRY_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "fraud-detection-tpu", "registry"),
    )


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
    ``model.npz`` + ``feature_names.json`` (+ ``monitor_profile.npz``).
    Without ``model.npz`` there, the path itself is read as the reference's
    joblib estimator."""
    return _get("MODEL_PATH", "models/logistic_model.joblib")


def feature_names_path() -> str:
    """``FEATURE_NAMES_PATH`` — the feature order of a joblib artifact."""
    return _get("FEATURE_NAMES_PATH", "models/feature_names.json")


def scaler_path() -> str:
    """``SCALER_PATH`` — the joblib ``StandardScaler`` of a joblib
    artifact."""
    return _get("SCALER_PATH", "models/scaler.joblib")


def require_registry_model() -> bool:
    """``REQUIRE_REGISTRY_MODEL=1`` disables the local-artifact fallback:
    serving fails loudly (degraded /health) when the registry has no model.
    Default off: the registry first, then the local artifacts."""
    return _get("REQUIRE_REGISTRY_MODEL", "0").lower() in ("1", "true", "yes")


def synthetic_samples() -> int:
    """``CI_SYNTHETIC_SAMPLES``, else ``TEST_SYNTHETIC_SAMPLES`` — the row
    count of a generated synthetic CSV when the caller gives none. Default
    500."""
    return int(
        os.environ.get(
            "CI_SYNTHETIC_SAMPLES", os.environ.get("TEST_SYNTHETIC_SAMPLES", 500)
        )
    )


def scorer_max_batch() -> int:
    return _get_int("SCORER_MAX_BATCH", 1024)


def scorer_max_wait_ms() -> float:
    return _get_float("SCORER_MAX_WAIT_MS", 2.0)


def scorer_fused_flush() -> bool:
    """``SCORER_FUSED_FLUSH`` (default on): score and fold the drift window
    in one flush; ``0`` restores the split path (score, then the
    watchtower's ingest thread folds the window) for A/B measurement."""
    return env_flag("SCORER_FUSED_FLUSH") is not False


def scorer_max_inflight() -> int:
    """``SCORER_MAX_INFLIGHT`` — flushes the micro-batcher runs at once.
    Default 4."""
    return _get_int("SCORER_MAX_INFLIGHT", 4)


def scorer_adaptive_wait() -> bool:
    """``SCORER_ADAPTIVE_WAIT=1``: scale the micro-batcher's collection
    deadline with an arrival-rate EWMA (rows, not requests): a lone request
    flushes at once, traffic that would fill ``SCORER_MAX_BATCH`` within
    the window waits all of ``SCORER_MAX_WAIT_MS``. Default off: the fixed
    deadline."""
    return env_flag("SCORER_ADAPTIVE_WAIT") is True


def scorer_admit_max_rows() -> int:
    """``SCORER_ADMIT_MAX_ROWS`` — rows waiting in the micro-batcher's
    admission queue, at most; at the bound ``/predict`` answers 429 with
    ``Retry-After``. 0 disables the bound. Default 65536."""
    return _get_int("SCORER_ADMIT_MAX_ROWS", 65536)


def scorer_admit_retry_after_s() -> float:
    """``SCORER_ADMIT_RETRY_AFTER_S`` — the retry hint a shed admission
    carries. Default 1 s."""
    return _get_float("SCORER_ADMIT_RETRY_AFTER_S", 1.0)


def scorer_wire() -> str:
    """``SCORER_WIRE`` — the h2d wire serving scorers are built with
    (``float32`` | ``bfloat16`` | ``int8``). ``int8`` ships per-feature
    quantization codes (30 B a row against 120), calibrated by the stamped
    ``quant_calibration.npz`` beside the model, else derived from the
    scaler. Default ``float32``."""
    return _get("SCORER_WIRE", "float32").lower()


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


def watchtower_enabled() -> bool | None:
    """Tri-state ``WATCHTOWER_ENABLED``: unset = monitor when the served
    model's artifacts carry a baseline profile, 0 = off, 1 = on (a WARNING
    when no profile is found)."""
    return env_flag("WATCHTOWER_ENABLED")


def watchtower_psi_threshold() -> float:
    """PSI above this flags drift. Default 0.2."""
    return _get_float("WATCHTOWER_PSI_THRESHOLD", 0.2)


def watchtower_ks_threshold() -> float:
    """KS above this flags drift. Default 0.15."""
    return _get_float("WATCHTOWER_KS_THRESHOLD", 0.15)


def watchtower_ece_threshold() -> float:
    """Windowed expected calibration error ceiling, judged once enough
    labeled feedback rows arrived. Default 0.1."""
    return _get_float("WATCHTOWER_ECE_THRESHOLD", 0.1)


def watchtower_disagree_threshold() -> float:
    """Champion/challenger decision-disagreement rate above which promotion
    is advised against. Default 0.05."""
    return _get_float("WATCHTOWER_DISAGREE_THRESHOLD", 0.05)


def watchtower_halflife_rows() -> float:
    """Exponential drift-window half-life in rows."""
    return _get_float("WATCHTOWER_HALFLIFE_ROWS", 100_000.0)


def watchtower_min_rows() -> int:
    """Window row floor below which the watchtower reports ``warming``."""
    return _get_int("WATCHTOWER_MIN_ROWS", 512)


def shadow_stage() -> str:
    """``MLFLOW_SHADOW_STAGE`` — the registry alias the shadow challenger
    resolves from (``models:/{name}@{shadow_stage}``). Default ``shadow``."""
    return _get("MLFLOW_SHADOW_STAGE", "shadow")


def watchtower_shadow_sample() -> float:
    """``WATCHTOWER_SHADOW_SAMPLE`` — the fraction of scored batches the
    challenger re-scores (0..1). Default 0.25."""
    return _get_float("WATCHTOWER_SHADOW_SAMPLE", 0.25)


def watchtower_retrain_trigger() -> bool:
    """``WATCHTOWER_RETRAIN_TRIGGER=1`` lets a drift episode enqueue one
    ``watchtower.trigger_retrain`` task. Default off."""
    return env_flag("WATCHTOWER_RETRAIN_TRIGGER") is True


def spyglass_enabled() -> bool:
    """``SPYGLASS_ENABLED=0`` turns off the per-request stage timelines,
    the flush's one fence and the flight recorder. Default on."""
    return env_flag("SPYGLASS_ENABLED") is not False


def flightrecorder_capacity() -> int:
    """``FLIGHTRECORDER_CAPACITY`` — requests the flight recorder keeps; 0
    disables it. Default 512."""
    return _get_int("FLIGHTRECORDER_CAPACITY", 512)


def ingest_port() -> int:
    """``INGEST_PORT`` — TCP port of the binary ingest lane
    (``service/binlane.py``); 0 (default) starts none. ``POST
    /ingest/batch`` serves frames either way."""
    return _get_int("INGEST_PORT", 0)


def ingest_host() -> str:
    """``INGEST_HOST`` — bind address of the binary ingest lane."""
    return _get("INGEST_HOST", "0.0.0.0")


def ingest_max_rows() -> int:
    """``INGEST_MAX_ROWS`` — rows a frame may carry; 0 (default) =
    ``SCORER_MAX_BATCH``. Clamped to the micro-batcher's ``max_batch``."""
    return _get_int("INGEST_MAX_ROWS", 0)


def ingest_max_frame() -> int:
    """``INGEST_MAX_FRAME_BYTES`` — the largest frame payload a connection
    may announce; a larger length prefix is answered with an error frame
    and the connection closed. Default 8 MiB."""
    return _get_int("INGEST_MAX_FRAME_BYTES", 8 << 20)


def ingest_stall_timeout_s() -> float:
    """``INGEST_STALL_TIMEOUT_S`` — per-receive progress timeout on ingest
    connections: idle between frames re-arms, a peer stalling inside a
    frame is dropped. Default 30 s."""
    return _get_float("INGEST_STALL_TIMEOUT_S", 30.0)


def database_url() -> str:
    """``DATABASE_URL`` — the results DB the API and the SHAP worker share.
    Only ``sqlite:///`` is served by the port today."""
    return _get("DATABASE_URL", "sqlite:///fraud.db")


def broker_url() -> str:
    """``CELERY_BROKER_URL`` — the task queue between the API and the SHAP
    worker. Only ``sqlite:///`` is served by the port today."""
    return _get("CELERY_BROKER_URL", "sqlite:///taskq.db")


def worker_metrics_port() -> int:
    """``WORKER_METRICS_PORT`` — the SHAP worker's ``/metrics`` port (0
    serves none)."""
    return _get_int("WORKER_METRICS_PORT", 8001)


# the ledger: per-entity velocity state on the device (ledger/)


def ledger_enabled() -> bool:
    """``LEDGER_ENABLED=1`` — train-side opt-in: ``train`` replays the
    rows through the ledger body, fits on base + K velocity features and
    stamps ``ledger_state.npz`` beside the weights. Serving needs no flag:
    it widens whenever the loaded artifact carries that sidecar."""
    return env_flag("LEDGER_ENABLED") is True


def ledger_slots() -> int:
    """``LEDGER_SLOTS`` — entity table size (power-of-two hash buckets);
    colliding entities share a slot's aggregates. Default 8192."""
    return _get_int("LEDGER_SLOTS", 8192)


def ledger_halflife_s() -> float:
    """``LEDGER_HALFLIFE_S`` — exponential decay half-life (seconds) of the
    per-entity aggregates. Default 3600."""
    return _get_float("LEDGER_HALFLIFE_S", 3600.0)


def ledger_amount_col() -> int:
    """``LEDGER_AMOUNT_COL`` — index of the transaction-amount column in
    the base row (-1: the Kaggle schema's trailing ``Amount``)."""
    return _get_int("LEDGER_AMOUNT_COL", -1)


def ledger_synth_events_per_entity() -> int:
    """``LEDGER_SYNTH_EVENTS`` — average events per synthesized pseudo-
    entity when the training CSV carries no entity ids. Default 50."""
    return _get_int("LEDGER_SYNTH_EVENTS", 50)
