"""Environment-variable configuration for the port's serving, explain,
training, offline-tool and telemetry slices.

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
    """``DATABASE_URL`` — the results DB the API and the SHAP worker share:
    ``sqlite:///``, ``fraud://``, ``sentinel://`` or ``postgresql://``."""
    return _get("DATABASE_URL", "sqlite:///fraud.db")


def broker_url() -> str:
    """``CELERY_BROKER_URL`` — the task queue between the API and the SHAP
    worker, on the same schemes as ``DATABASE_URL``."""
    return _get("CELERY_BROKER_URL", "sqlite:///taskq.db")


def store_token() -> str:
    """``FRAUD_STORE_TOKEN`` — the shared secret of the network store tier
    (store servers, sentinels and their clients): when set, every frame
    carries it and a server rejects a peer without it. Empty (the default)
    leaves the tier unauthenticated (loopback and development only)."""
    return _get("FRAUD_STORE_TOKEN", "")


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


# the wide family: hashed entity crosses (ops/crosses)


def wide_buckets() -> int:
    """``WIDE_BUCKETS`` — width of the hashed-cross weight table the wide
    family learns; a power of two (raises otherwise). Default 2¹⁴ =
    16384."""
    buckets = _get_int("WIDE_BUCKETS", 1 << 14)
    if buckets < 2 or buckets & (buckets - 1):
        raise ValueError(f"WIDE_BUCKETS must be a power of two, got {buckets}")
    return buckets


def wide_enabled() -> bool:
    """``WIDE_ENABLED=1`` — train-side opt-in: ``train`` fits the wide
    family (hashed feature crosses over fields the wire already carries)
    and stamps ``wide_params.npz`` beside the weights. Serving needs no
    flag: it widens whenever the loaded artifact carries that sidecar."""
    return env_flag("WIDE_ENABLED") is True


# the serving mesh: sharded flushes and the shard front (mesh/)


def mesh_shards() -> int:
    """``MESH_SHARDS`` — replica shards behind the shard front (each one
    micro-batcher; all share the model slot, so a hot swap lands on every
    shard between flushes). 0/1 (default): one batcher, no front."""
    return _get_int("MESH_SHARDS", 0)


def mesh_flush_devices() -> int:
    """``MESH_FLUSH_DEVICES`` — the serving mesh's data axis: the fused
    flush splits its bucket over that many shards, each with its own drift
    window and ledger sub-table, all on the serving device
    (``mesh/shardflush``). 0 (default): the single-window flush. Floored
    to a power of two and clamped to ``MAX_FLUSH_SHARDS`` (8)."""
    return _get_int("MESH_FLUSH_DEVICES", 0)


def mesh_model_devices() -> int:
    """``MESH_MODEL_DEVICES`` — the model axis of the serving mesh and of
    the wide family's training grid (``mesh/retrain.wide_training_mesh``).
    0/1 (default): none. Above 1, a power of two: the wide family's cross
    table column-shards over that many model shards of the one device, the
    narrow and ledger families split their rows over the whole ``data ×
    model`` grid, and the data axis is clamped so the grid stays within 8
    shards."""
    return _get_int("MESH_MODEL_DEVICES", 0)


def distributed_env() -> dict | None:
    """The process group's coordinates, as ``torchrun`` sets them (the
    port's counterpart of the JAX package's ``JAX_COORDINATOR_ADDRESS``,
    ``JAX_NUM_PROCESSES`` and ``JAX_PROCESS_ID``): ``MASTER_ADDR`` (unset:
    ``None``, one process), ``MASTER_PORT`` (default 29500), ``WORLD_SIZE``
    (default 1), ``RANK`` (default 0), ``LOCAL_RANK`` (default ``RANK``) and
    ``LOCAL_WORLD_SIZE`` (default ``WORLD_SIZE``: every rank on this host).
    Read by ``parallel.mesh.initialize_distributed``."""
    addr = os.environ.get("MASTER_ADDR")
    if not addr:
        return None
    world = _get_int("WORLD_SIZE", 1)
    rank = _get_int("RANK", 0)
    return {
        "master_addr": addr,
        "master_port": _get_int("MASTER_PORT", 29500),
        "world_size": world,
        "rank": rank,
        "local_rank": _get_int("LOCAL_RANK", rank),
        "local_world_size": _get_int("LOCAL_WORLD_SIZE", world),
    }


def mesh_shard_max_errors() -> int:
    """``MESH_SHARD_MAX_ERRORS`` — consecutive scoring failures after which
    the front marks a shard dead and sheds its load. Default 3."""
    return _get_int("MESH_SHARD_MAX_ERRORS", 3)


def mesh_shard_reopen_s() -> float:
    """``MESH_SHARD_REOPEN_S`` — seconds a dead shard rests before the front
    may half-open-probe it when no shard is healthy (one request; a failure
    re-kills it, a success revives it). Default 5.0."""
    return _get_float("MESH_SHARD_REOPEN_S", 5.0)


# the lifeboat: the ledger's write-ahead journal, snapshots and warm restart
# (lifeboat/)


def lifeboat_dir() -> str:
    """``LIFEBOAT_DIR`` — the directory of snapshot generations and entity
    journals. Empty (the default) disables the lifeboat: the ledger's table
    then lives only on the device, and a crash loses everything folded in
    since the train-time stamp."""
    return _get("LIFEBOAT_DIR", "")


def lifeboat_snapshot_s() -> float:
    """``LIFEBOAT_SNAPSHOT_S`` — seconds between snapshot generations
    (taken off the hot path by the maintenance thread). Default 300."""
    return _get_float("LIFEBOAT_SNAPSHOT_S", 300.0)


def lifeboat_snapshot_flushes() -> int:
    """``LIFEBOAT_SNAPSHOT_FLUSHES`` — also snapshot after this many
    journaled flushes (0, the default: by time only). Bounds the journal
    tail a restart replays."""
    return _get_int("LIFEBOAT_SNAPSHOT_FLUSHES", 0)


def lifeboat_keep() -> int:
    """``LIFEBOAT_KEEP`` — snapshot generations kept; a torn newest file
    falls back one generation. At least 1. Default 3."""
    return max(_get_int("LIFEBOAT_KEEP", 3), 1)


def lifeboat_fsync_s() -> float:
    """``LIFEBOAT_FSYNC_S`` — the journal's fsync cadence: rows appended in
    this window are what a crash can lose (``lifeboat_journal_lag_rows``).
    0 fsyncs every append. Default 0.5."""
    return _get_float("LIFEBOAT_FSYNC_S", 0.5)


# the lifecycle loop: durable feedback, retrain → gate → @shadow, promotion,
# the hot swap (lifecycle/)


def mesh_retrain() -> bool:
    """``MESH_RETRAIN=1`` — the conductor's retrain refines the fit with the
    cross-replica-sharded weight update (``mesh/retrain.mesh_sgd_fit``:
    each data shard owns 1/N of the coefficients and their momentum,
    warm-started from the champion, ``max(max_iter // 20, 3)`` epochs)
    instead of L-BFGS. Default off."""
    return env_flag("MESH_RETRAIN") is True


_warned_local_lifecycle_db = False


def lifecycle_db_url(broker: str | None = None) -> str:
    """``LIFECYCLE_DB_URL`` — the database holding the conductor's feedback
    and state tables; when unset, the broker's database (``broker`` when
    the caller holds an explicit URL, else ``CELERY_BROKER_URL``) where that
    is a SQL backend (``sqlite:///``, ``postgresql://``), so lifecycle state
    lives beside the queue. A ``fraud://``/``sentinel://`` broker has no
    SQL surface: the store falls back to the process-local
    ``sqlite:///lifecycle.db``, with a warning once a process, because a
    local file carries neither feedback nor the retrain/promotion latch
    across replicas, and a fleet of ``LONGHAUL_HOSTS > 1`` refuses to start
    on it."""
    global _warned_local_lifecycle_db
    explicit = os.environ.get("LIFECYCLE_DB_URL")
    if explicit:
        return explicit
    broker = broker or broker_url()
    if broker.startswith(("sqlite", "postgresql://", "postgres://")):
        return broker
    if longhaul_hosts() > 1:
        # a multi-host fleet splitting its feedback store is an outage,
        # not a warning: every host would race the retrain/promotion latch
        # in its own file and the fleet would promote N champions
        raise RuntimeError(
            "LONGHAUL_HOSTS>1 but LIFECYCLE_DB_URL is unset and broker "
            f"{broker!r} has no SQL surface: the process-local "
            "sqlite:///lifecycle.db fallback cannot carry feedback or the "
            "retrain/promotion latch across hosts. Set LIFECYCLE_DB_URL "
            "to a shared database (see README 'longhaul')."
        )
    if not _warned_local_lifecycle_db:
        _warned_local_lifecycle_db = True
        import logging

        logging.getLogger("fraud_detection_tpu_torch.config").warning(
            "LIFECYCLE_DB_URL is not set and broker %r has no SQL surface: "
            "lifecycle state falls back to the PROCESS-LOCAL "
            "sqlite:///lifecycle.db, which does not span replicas. Set "
            "LIFECYCLE_DB_URL to a shared database.", broker,
        )
    return "sqlite:///lifecycle.db"


def conductor_auto_promote() -> bool:
    """``CONDUCTOR_AUTO_PROMOTE=1`` lets the watchtower's
    ``promote_challenger`` / ``rollback_challenger`` recommendations enqueue
    the conductor's tasks (one an episode). Default off: alias flips move
    real traffic."""
    return env_flag("CONDUCTOR_AUTO_PROMOTE") is True


def conductor_gate_auc_margin() -> float:
    """``CONDUCTOR_GATE_AUC_MARGIN`` — ε in the gate's ``AUC ≥ champion AUC
    − ε``. Default 0.005."""
    return _get_float("CONDUCTOR_GATE_AUC_MARGIN", 0.005)


def conductor_gate_ece_bound() -> float:
    """``CONDUCTOR_GATE_ECE_BOUND`` — the challenger's expected calibration
    error ceiling on the labeled slices. Default 0.1."""
    return _get_float("CONDUCTOR_GATE_ECE_BOUND", 0.1)


def conductor_gate_psi_bound() -> float:
    """``CONDUCTOR_GATE_PSI_BOUND`` — ceiling on PSI(challenger scores ‖
    champion scores) over the holdout. Default 0.25."""
    return _get_float("CONDUCTOR_GATE_PSI_BOUND", 0.25)


def conductor_feedback_window() -> int:
    """``CONDUCTOR_FEEDBACK_WINDOW`` — rows kept in the recent labeled
    window. Default 50,000."""
    return _get_int("CONDUCTOR_FEEDBACK_WINDOW", 50_000)


def conductor_reservoir_size() -> int:
    """``CONDUCTOR_RESERVOIR_SIZE`` — the uniform-over-history reservoir's
    size. Default 10,000."""
    return _get_int("CONDUCTOR_RESERVOIR_SIZE", 10_000)


def conductor_min_eval_rows() -> int:
    """``CONDUCTOR_MIN_EVAL_ROWS`` — labeled-window rows below which the gate
    skips the recent slice. Default 256."""
    return _get_int("CONDUCTOR_MIN_EVAL_ROWS", 256)


def lifecycle_reload_interval() -> float:
    """``LIFECYCLE_RELOAD_INTERVAL_S`` — seconds between the serving
    reloader's registry alias polls; 0 disables polling (``POST
    /admin/reload`` still works). Default 15."""
    return _get_float("LIFECYCLE_RELOAD_INTERVAL_S", 15.0)


def lifecycle_retrain_stale_after() -> float:
    """``LIFECYCLE_RETRAIN_STALE_AFTER_S`` — seconds without a heartbeat
    after which a RETRAINING episode counts as a dead worker's and resume()
    may reclaim it; the owner beats every third of this. Default 900."""
    return _get_float("LIFECYCLE_RETRAIN_STALE_AFTER_S", 900.0)


def admin_token() -> str:
    """``ADMIN_TOKEN`` — the shared secret of ``POST /admin/reload`` and
    ``POST /admin/profile``: when set, a request carries it as ``Authorization: Bearer <token>`` or
    ``X-Admin-Token``; empty (the default) leaves the endpoint open
    (loopback and development only)."""
    return _get("ADMIN_TOKEN", "")


# ---------------------------------------------------------------------------
# telemetry: tracing, the profiler, the compile sentinel, the SLO engine and
# the roofline (telemetry/, service/tracing.py)
# ---------------------------------------------------------------------------

def otel_endpoint() -> str:
    """``OTEL_EXPORTER_OTLP_ENDPOINT`` — the OTLP HTTP collector spans go
    to; empty (the default) leaves tracing off."""
    return _get("OTEL_EXPORTER_OTLP_ENDPOINT", "")


def otel_service_name() -> str:
    return _get("OTEL_SERVICE_NAME", "fraud-api")


def device_profile_dir() -> str:
    """Where ``POST /admin/profile`` writes trace captures."""
    return _get("DEVICE_PROFILE_DIR", "device_traces")


def device_profile_default_s() -> float:
    return _get_float("DEVICE_PROFILE_DEFAULT_S", 5.0)


def device_profile_max_s() -> float:
    """The ceiling of one on-demand capture window: a forgotten profile
    must not trace the device for hours."""
    return _get_float("DEVICE_PROFILE_MAX_S", 60.0)


def recompile_storm_window_s() -> float:
    """Sliding window of the compile sentinel's jump detector."""
    return _get_float("RECOMPILE_STORM_WINDOW_S", 600.0)


def recompile_storm_threshold() -> int:
    """Unexpected compiles (on the port: kernel-library builds and loads)
    within the window that flag a storm. Default 8."""
    return _get_int("RECOMPILE_STORM_THRESHOLD", 8)


def slo_enabled() -> bool:
    """``SLO_ENABLED=0`` turns off the host-side SLO engine (per-lane
    availability and latency objectives over sliding windows,
    ``slo_burn_rate``/``slo_error_budget_remaining`` and ``/slo/status``).
    Default on."""
    return env_flag("SLO_ENABLED") is not False


def slo_availability_objective(series: str | None = None) -> float:
    """``SLO_AVAILABILITY_OBJECTIVE`` — the fraction of requests answered
    without a shed, outage or internal error; a per-series override wins:
    ``SLO_AVAILABILITY_OBJECTIVE_JSON``/``_MSGPACK``/``_BINARY``/``_SHARD``
    (the shard override applies to every shard). Default 0.999."""
    if series is not None:
        key = series.upper().rstrip("0123456789")
        v = os.environ.get(f"SLO_AVAILABILITY_OBJECTIVE_{key}")
        if v:
            return float(v)
    return _get_float("SLO_AVAILABILITY_OBJECTIVE", 0.999)


def slo_latency_objective(series: str | None = None) -> float:
    """``SLO_LATENCY_OBJECTIVE`` — the fraction of requests completing under
    ``SLO_LATENCY_P99_MS``, with the availability objective's per-series
    overrides. Default 0.99."""
    if series is not None:
        key = series.upper().rstrip("0123456789")
        v = os.environ.get(f"SLO_LATENCY_OBJECTIVE_{key}")
        if v:
            return float(v)
    return _get_float("SLO_LATENCY_OBJECTIVE", 0.99)


def slo_latency_threshold_s() -> float:
    """``SLO_LATENCY_P99_MS`` — the latency a request must beat to count as
    good for the latency objective, in seconds. Default 250 ms."""
    return _get_float("SLO_LATENCY_P99_MS", 250.0) / 1000.0


def slo_fast_burn() -> float:
    """``SLO_FAST_BURN`` — the burn-rate multiple over which the fast-burn
    alert pages. Default 14.4."""
    return _get_float("SLO_FAST_BURN", 14.4)


def slo_slow_burn() -> float:
    """``SLO_SLOW_BURN`` — the burn-rate multiple over which the slow-burn
    alert warns. Default 6."""
    return _get_float("SLO_SLOW_BURN", 6.0)


def roofline_enabled() -> bool:
    """``ROOFLINE_ENABLED=0`` turns off the live roofline layer: the
    per-program costs and ``device_utilization_fraction``. Default on."""
    return env_flag("ROOFLINE_ENABLED") is not False


def device_peak_flops() -> float:
    """``DEVICE_PEAK_FLOPS`` — the peak f32 FLOP/s the utilization gauges
    divide by. 0 (the default) measures it once at warm-up with a matmul
    probe on the card (telemetry/roofline ``ensure_peak``)."""
    return _get_float("DEVICE_PEAK_FLOPS", 0.0)


def device_peak_bytes_per_s() -> float:
    """``DEVICE_PEAK_BYTES_PER_S`` — the device-memory rate (bytes/s) the
    roofline audit divides by. 0 (the default) measures it once with a
    streaming probe (telemetry/roofline ``ensure_membw``)."""
    return _get_float("DEVICE_PEAK_BYTES_PER_S", 0.0)


# the longhaul fleet: the multi-host serving mesh (longhaul/)


def longhaul_hosts() -> int:
    """``LONGHAUL_HOSTS`` — the fleet's host segments, the outer modulus of
    the two-level placement (``slot mod LONGHAUL_HOSTS`` names the owning
    host). 1 (the default) is a single host. Fixed for the life of a fleet:
    changing it remaps every entity's owner."""
    return _get_int("LONGHAUL_HOSTS", 1)


def longhaul_directory() -> str:
    """``LONGHAUL_DIRECTORY`` — ``host:port`` of the membership directory
    every host joins and heartbeats."""
    return os.environ.get("LONGHAUL_DIRECTORY", "127.0.0.1:7300")


def longhaul_host_id() -> str:
    """``LONGHAUL_HOST_ID`` — this process's member identity (its rank is
    sticky per host id across rejoins)."""
    return os.environ.get("LONGHAUL_HOST_ID", "host-0")


def longhaul_data_dir() -> str:
    """``LONGHAUL_DATA_DIR`` — the root under which each host keeps its
    lifeboat directory, ``<root>/<host_id>``. On a shared filesystem the
    inheritor replays a dead peer's generation from ``<root>/<peer_id>``."""
    return os.environ.get("LONGHAUL_DATA_DIR", "longhaul-data")


def longhaul_heartbeat_s() -> float:
    """``LONGHAUL_HEARTBEAT_S`` — seconds between a member's heartbeats."""
    return _get_float("LONGHAUL_HEARTBEAT_S", 1.0)


def longhaul_dead_after_s() -> float:
    """``LONGHAUL_DEAD_AFTER_S`` — heartbeat silence after which the
    directory marks a member dead and bumps the epoch. Keep it at least
    three heartbeats."""
    return _get_float("LONGHAUL_DEAD_AFTER_S", 3.0)


def longhaul_retry_after_s() -> float:
    """``LONGHAUL_RETRY_AFTER_S`` — the Retry-After (seconds) of the
    front's 503 while a segment's owner inherits or no host is healthy."""
    return _get_float("LONGHAUL_RETRY_AFTER_S", 1.0)


def longhaul_probation_s() -> float:
    """``LONGHAUL_PROBATION_S`` — seconds a dead host handle waits before
    the front risks one probe on it."""
    return _get_float("LONGHAUL_PROBATION_S", 2.0)
