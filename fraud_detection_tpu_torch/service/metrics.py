"""Prometheus metrics — a small stdlib text exposition.

The series the port's slices touch, under the JAX package's names, labels
and buckets (dashboards and alert rules read them): the API counters and
latency histograms, the micro-batcher's flush-path counters and fusion
gauges (the wide family's among them), the watchtower's drift and shadow
series, the ledger's, the ingest lanes', the request stages', the lifecycle
loop's, and the SHAP worker's and task queue's series. Counters
export ``<name>_total``; histograms export ``_bucket``/``_sum``/``_count``.
No ``prometheus_client``: the exposition format (text 0.0.4) is written
here.
"""

from __future__ import annotations

import math
import threading
import time

CONTENT_TYPE_LATEST = "text/plain; version=0.0.4; charset=utf-8"

_DEFAULT_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.075, 0.1, 0.25, 0.5, 0.75, 1.0, 2.5, 5.0,
    7.5, 10.0,
)


def _fmt(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return repr(float(v))


def _escape(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n").replace('"', r"\"")


class _Child:
    """One labelled series: a value (counter/gauge) or bucket counts."""

    def __init__(self, metric: "_Metric"):
        self._metric = metric
        self._lock = threading.Lock()
        self.value = 0.0
        if metric.kind == "histogram":
            self.buckets = [0] * len(metric.buckets)
            self.count = 0

    def inc(self, amount: float = 1.0) -> None:
        if self._metric.kind == "counter" and amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self.value += amount

    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)

    def observe(self, value: float) -> None:
        with self._lock:
            self.value += value
            self.count += 1
            for i, le in enumerate(self._metric.buckets):
                if value <= le:
                    self.buckets[i] += 1


class _Metric:
    def __init__(self, kind, name, documentation, labelnames=(), buckets=None):
        self.kind = kind
        self.name = name
        self.documentation = documentation
        self.labelnames = tuple(labelnames)
        if kind == "histogram":
            self.buckets = tuple(buckets or _DEFAULT_BUCKETS) + (math.inf,)
        self._children: dict[tuple[str, ...], _Child] = {}
        self._lock = threading.Lock()
        if not self.labelnames:
            self._children[()] = _Child(self)
        REGISTRY.append(self)

    def labels(self, *values) -> _Child:
        if len(values) != len(self.labelnames):
            raise ValueError(f"{self.name} takes labels {self.labelnames}")
        key = tuple(str(v) for v in values)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = _Child(self)
        return child

    # unlabelled convenience, like prometheus_client
    def inc(self, amount: float = 1.0) -> None:
        self._children[()].inc(amount)

    def set(self, value: float) -> None:
        self._children[()].set(value)

    def observe(self, value: float) -> None:
        self._children[()].observe(value)

    def clear(self) -> None:
        """Drop every labelled series (an unlabelled metric keeps its one)."""
        if self.labelnames:
            with self._lock:
                self._children.clear()

    def get(self, *values) -> float:
        """Current value of one series (0.0 when never written)."""
        child = self._children.get(tuple(str(v) for v in values))
        return 0.0 if child is None else child.value

    def render(self) -> list[str]:
        lines = [
            f"# HELP {self.name}"
            f"{'_total' if self.kind == 'counter' else ''} {self.documentation}",
            f"# TYPE {self.name}"
            f"{'_total' if self.kind == 'counter' else ''} {self.kind}",
        ]
        with self._lock:
            children = list(self._children.items())
        for key, child in children:
            pairs = [f'{n}="{_escape(v)}"' for n, v in zip(self.labelnames, key)]

            def lbl(extra=()):
                allp = pairs + list(extra)
                return "{" + ",".join(allp) + "}" if allp else ""

            with child._lock:
                if self.kind == "histogram":
                    for le, c in zip(self.buckets, child.buckets):
                        le_s = f'le="{_fmt(le)}"'
                        lines.append(f"{self.name}_bucket{lbl([le_s])} {_fmt(c)}")
                    lines.append(f"{self.name}_count{lbl()} {_fmt(child.count)}")
                    lines.append(f"{self.name}_sum{lbl()} {_fmt(child.value)}")
                elif self.kind == "counter":
                    lines.append(f"{self.name}_total{lbl()} {_fmt(child.value)}")
                else:
                    lines.append(f"{self.name}{lbl()} {_fmt(child.value)}")
        return lines


REGISTRY: list[_Metric] = []


def Counter(name, documentation, labelnames=()):  # noqa: N802 — prometheus idiom
    return _Metric("counter", name, documentation, labelnames)


def Gauge(name, documentation, labelnames=()):  # noqa: N802
    return _Metric("gauge", name, documentation, labelnames)


def Histogram(name, documentation, labelnames=(), buckets=None):  # noqa: N802
    return _Metric("histogram", name, documentation, labelnames, buckets)


# API-side
predictions_submitted = Counter(
    "predictions_submitted", "Transactions submitted for prediction"
)
inference_duration = Histogram(
    "api_inference_duration_seconds", "Model inference latency"
)
http_requests = Counter(
    "http_requests", "HTTP requests", ["method", "handler", "status"]
)
http_request_duration = Histogram(
    "http_request_duration_seconds", "HTTP request latency",
    ["method", "handler"],
)
db_latency = Histogram(
    "api_db_latency_seconds", "Database call latency"
)
model_loaded = Gauge(
    "model_loaded",
    "1 when a servable model is loaded (ModelUnavailable alert signal)",
)

# Worker-side (xai_tasks.py:48-50)
xai_task_duration = Histogram(
    "xai_task_duration_seconds", "XAI task latency"
)
xai_task_success = Counter("xai_task_success", "Successful XAI tasks")
xai_task_failures = Counter("xai_task_failures", "Failed XAI tasks")
xai_explain_consistency_failures = Counter(
    "xai_explain_consistency_failures",
    "Worker full-vector SHAP backfills that disagreed with the serve-time "
    "top-k reason codes riding the task payload (lantern consistency "
    "check) — nonzero means the fused explain leg and the async explainer "
    "have drifted apart (stale swap, wire corruption)",
)
queue_depth = Gauge(
    "xai_queue_depth", "Queued XAI tasks (KEDA scaling signal)"
)
# At-least-once delivery: incremented by the broker in the process that
# made the claim
taskq_redeliveries = Counter(
    "taskq_redeliveries",
    "Task deliveries beyond the first: a visibility-timeout expiry handed "
    "the task to another worker, or a nacked task was retried",
)
taskq_expired_claims = Counter(
    "taskq_expired_claims",
    "Claims whose visibility window lapsed before ack/nack (worker death "
    "or stall mid-task) — the acks-late redelivery trigger",
)

# Micro-batcher
microbatch_size = Histogram(
    "scorer_microbatch_size", "Rows per device dispatch",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024),
)
scorer_device_calls_per_flush = Gauge(
    "scorer_device_calls_per_flush",
    "Flush calls this shard's last flush issued (1 = fused path, score and "
    "drift fold in one flush; 2 = split score + drift-window update)",
    ["shard"],
)
scorer_flushes = Counter(
    "scorer_flushes",
    "Micro-batch flushes by path and shard: fused = score + drift fold in "
    "one flush; split = score, then the watchtower's drift update; solo = "
    "score-only (no watchtower)",
    ["path", "shard"],
)
scorer_wire_fused = Gauge(
    "scorer_wire_fused",
    "1 while the served wire format runs the fused single-dispatch flush; "
    "0 when the wire format opted out of fusion and flushes silently "
    "demoted to the split two-dispatch path (WireFormatUnfused alert "
    "input — a config change must never quietly double device dispatches)",
)
scorer_explain_fused = Gauge(
    "scorer_explain_fused",
    "1 while serve-time reason codes (SCORER_EXPLAIN=topk) ride the fused "
    "flush; 0 when they demoted. Stays 1 when explanation is off",
)
scorer_wide_fused = Gauge(
    "scorer_wide_fused",
    "1 while the served WIDE family's hashed-cross contributions ride the "
    "fused flush; 0 when a wide champion serves through the split/solo "
    "path — its crosses are then dropped and every row scores base-only "
    "through the null fold (WideFlushUnfused alert input). Stays 1 when "
    "the served family is not wide",
)
wide_model_shards = Gauge(
    "wide_model_shards",
    "Model-axis size the wide family's cross-weight table is split over "
    "(1 = the single-device gather; 0 when the served family is not wide)",
)
wide_bucket_occupancy = Gauge(
    "wide_bucket_occupancy",
    "Fraction of non-zero learned cross weights in each model-axis column "
    "slice of the served wide table (refreshed when the served table "
    "changes; WideShardSkew alert input)",
    ["model_shard"],
)
scorer_explained_rows = Counter(
    "scorer_explained_rows",
    "Scored rows whose response carried fused top-k reason codes",
)
scorer_served_family = Gauge(
    "scorer_served_family",
    "1 for the model family the micro-batcher is currently flushing "
    "(linear or gbt), 0 for a family it flushed before",
    ["family"],
)
scorer_queue_depth = Gauge(
    "scorer_queue_depth",
    "Queue items waiting in this shard's micro-batcher at the last "
    "collection cycle",
    ["shard"],
)
scorer_effective_wait = Gauge(
    "scorer_effective_wait_seconds",
    "Collection deadline this shard's micro-batcher is currently applying "
    "(= SCORER_MAX_WAIT_MS unless SCORER_ADAPTIVE_WAIT scales it down)",
    ["shard"],
)
scorer_admission_queue_rows = Gauge(
    "scorer_admission_queue_rows",
    "Rows admitted but not yet collected into a flush (bounded admission)",
    ["shard"],
)

# Watchtower
watchtower_feature_psi_max = Gauge(
    "watchtower_feature_psi_max",
    "Max per-feature PSI of the live window vs the training baseline",
)
watchtower_feature_ks_max = Gauge(
    "watchtower_feature_ks_max",
    "Max per-feature KS statistic vs the training baseline",
)
watchtower_score_psi = Gauge(
    "watchtower_score_psi",
    "PSI of the live score distribution vs the training baseline",
)
watchtower_score_ks = Gauge(
    "watchtower_score_ks",
    "KS statistic of the live score distribution vs the training baseline",
)
watchtower_ece = Gauge(
    "watchtower_ece",
    "Windowed expected calibration error over labeled feedback rows",
)
watchtower_window_rows = Gauge(
    "watchtower_window_rows", "Decayed row count in the drift window"
)
watchtower_drift_detected = Gauge(
    "watchtower_drift_detected",
    "1 while any drift flag (feature/score/calibration) is raised",
)
watchtower_recommendation = Gauge(
    "watchtower_recommendation",
    "1 for the currently recommended action, 0 otherwise", ["action"],
)
watchtower_batches_observed = Counter(
    "watchtower_batches_observed", "Scored batches folded into the drift window"
)
watchtower_batches_dropped = Counter(
    "watchtower_batches_dropped",
    "Scored batches dropped by the watchtower backlog bound",
)

watchtower_shadow_disagreement = Gauge(
    "watchtower_shadow_disagreement",
    "Champion/challenger decision disagreement rate in the shadow window",
)
watchtower_shadow_score_psi = Gauge(
    "watchtower_shadow_score_psi",
    "PSI of the challenger score distribution vs the training baseline",
)
watchtower_shadow_reason_divergence = Gauge(
    "watchtower_shadow_reason_divergence",
    "Mean (1 - Jaccard) between the champion's serve-time top-k reason-code "
    "indices and the challenger's top-k on sampled batches",
)
watchtower_shadow_batches = Counter(
    "watchtower_shadow_batches", "Batches re-scored by the shadow challenger"
)
watchtower_retrain_triggers = Counter(
    "watchtower_retrain_triggers", "Retrain-trigger tasks enqueued by watchtower"
)
retrain_requests = Counter(
    "watchtower_retrain_requests", "Retrain-trigger tasks processed by workers"
)

# the lifecycle loop: retrain → gate → promotion and the hot swap
# (lifecycle/). These names are the alerting contract.
lifecycle_model_swaps = Counter(
    "lifecycle_model_swaps",
    "Hot model swaps applied by the serving reloader (no restart)",
)
lifecycle_active_model_version = Gauge(
    "lifecycle_active_model_version",
    "Registry version of the champion currently being served (0 = unversioned)",
)
lifecycle_state = Gauge(
    "lifecycle_state",
    "1 for the conductor state machine's current state, 0 otherwise",
    ["state"],
)
lifecycle_retrains = Counter(
    "lifecycle_retrains",
    "Conductor retrain executions by outcome (gated/gate_failed/failed/skipped)",
    ["outcome"],
)
lifecycle_retrain_duration = Histogram(
    "lifecycle_retrain_duration_seconds",
    "Wall time of a conductor retrain (fit + gate evaluation)",
    buckets=(1, 5, 15, 30, 60, 120, 300, 600, 1800, 3600),
)
lifecycle_promotions = Counter(
    "lifecycle_promotions",
    "Challenger promotions completed (alias flipped to the challenger)",
)
lifecycle_rollbacks = Counter(
    "lifecycle_rollbacks",
    "Rollbacks completed (challenger dropped or prior champion restored)",
)
lifecycle_feedback_rows = Gauge(
    "lifecycle_feedback_rows",
    "Durable labeled-feedback rows by pool (window/reservoir)",
    ["pool"],
)

# the ledger: the per-entity table of a widened family (ledger/)
ledger_slot_occupancy = Gauge(
    "ledger_slot_occupancy",
    "Fraction of entity-table slots holding live (undecayed) evidence; "
    "raise LEDGER_SLOTS before this saturates",
)
ledger_active = Gauge(
    "ledger_active",
    "1 while the served model is ledger-widened and the entity table is "
    "bound to the fused flush; 0 for a stateless family",
)
ledger_hash_collisions = Counter(
    "ledger_hash_collisions",
    "Rows that wrote into a live slot owned by a different entity "
    "fingerprint (the aggregates are shared; sustained growth means "
    "LEDGER_SLOTS is undersized)",
)
ledger_evictions = Counter(
    "ledger_evictions",
    "Slot takeovers: a new entity claimed a slot whose previous owner's "
    "evidence had decayed below noise",
)
ledger_null_entity_rows = Counter(
    "ledger_null_entity_rows",
    "Scored rows that carried no entity_id: they score through the null "
    "slot (the training rows' mean velocity features folded into the "
    "intercept)",
)

# the lifeboat (lifeboat/): the series monitoring/prometheus/rules/
# lifeboat-alerts.yml reads, under the JAX package's names
lifeboat_snapshot_age = Gauge(
    "lifeboat_snapshot_age_seconds",
    "Seconds since the last snapshot generation landed (refreshed by the "
    "lifeboat's maintenance thread); the SnapshotStale alert input",
)
lifeboat_journal_lag_rows = Gauge(
    "lifeboat_journal_lag_rows",
    "Entity rows appended to the journal but not yet fsynced: the rows a "
    "crash now would lose (bounded by LIFEBOAT_FSYNC_S); the "
    "JournalLagGrowing alert input",
)
lifeboat_recovery_duration = Gauge(
    "lifeboat_recovery_duration_seconds",
    "Wall time of the last warm restart (snapshot load and journal replay "
    "through the ledger's read-update body)",
)
lifeboat_replayed_rows = Counter(
    "lifeboat_replayed_rows",
    "Journal rows replayed through the ledger's read-update body by warm "
    "restarts",
)
lifeboat_torn_tail_rows = Counter(
    "lifeboat_torn_tail_rows",
    "Journal rows lost to CRC-failed or truncated records (the torn tail a "
    "crash leaves, or mid-file damage, logged loudly)",
)

# the ingest lanes: json (/predict), msgpack and binary (/ingest/batch and
# the socket lane)
ingest_requests = Counter(
    "ingest_requests",
    "Scoring requests accepted per ingest lane (one /predict call or one "
    "batch frame each)", ["lane"],
)
ingest_rows = Counter(
    "ingest_rows", "Rows admitted to the scorer per ingest lane", ["lane"]
)
ingest_shed = Counter(
    "ingest_shed",
    "Requests shed at the admission bound (HTTP 429 + Retry-After, or a "
    "binary busy frame)", ["lane"],
)
ingest_frame_errors = Counter(
    "ingest_frame_errors",
    "Malformed binary ingest frames rejected (bad magic/layout, size "
    "overflow, non-finite features) or connections dropped mid-frame",
    ["kind"],
)

# spyglass: a scored request's six stages inside the micro-batcher, and the
# lanes' parse and admit stages
request_stage_duration = Histogram(
    "request_stage_duration_seconds",
    "Per-stage latency of a scored request inside the micro-batcher "
    "(enqueue/flush_wait/pad_bucket/device_compute/d2h/respond)",
    ["stage"],
    buckets=(
        5e-05, 0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
        0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
    ),
)


def render() -> bytes:
    lines: list[str] = []
    for metric in REGISTRY:
        lines.extend(metric.render())
    return ("\n".join(lines) + "\n").encode()


class _Timer:
    def __init__(self, hist: _Metric):
        self.hist = hist

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.hist.observe(time.perf_counter() - self.t0)
        return False


def timed(hist: _Metric) -> _Timer:
    return _Timer(hist)
