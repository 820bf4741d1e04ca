"""Prometheus metrics — a small stdlib text exposition.

The series the port's slices touch, under the JAX package's names, labels
and buckets (dashboards and alert rules read them): the API counters and
latency histograms, the micro-batcher's flush-path counters and fusion
gauges (the wide family's among them), the watchtower's drift and shadow
series, the ledger's, the ingest lanes', the request stages', the lifecycle
loop's, the SHAP worker's and task queue's series, and the telemetry
layer's (the compile sentinel's ``xla_*``, the device-memory, profiler,
SLO and roofline series) and the longhaul fleet's ``longhaul_*``. Counters
export ``<name>_total``; histograms export ``_bucket``/``_sum``/``_count``.
No ``prometheus_client``: the exposition format (text 0.0.4) and its HTTP
endpoint (:func:`start_http_server`) are written here. A store server keeps
its ``fraud_store_*`` gauges in a registry of its own
(``netserver.store_metrics``).
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
    """One labelled series: a value (counter/gauge) or bucket counts. A
    gauge's value may instead be read from a function at scrape time
    (:meth:`_Metric.set_function`)."""

    def __init__(self, metric: "_Metric"):
        self._metric = metric
        self._lock = threading.Lock()
        self.value = 0.0
        self.fn = None
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
    def __init__(self, kind, name, documentation, labelnames=(), buckets=None,
                 registry=None):
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
        (REGISTRY if registry is None else registry).append(self)

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

    def set_function(self, fn) -> None:
        """An unlabelled gauge whose value is ``fn()`` at every read (the
        prometheus_client idiom for a value another object owns)."""
        self._children[()].fn = fn

    def remove(self, *values) -> None:
        """Drop one labelled series (``KeyError`` when it was never
        written), as prometheus_client's ``remove``."""
        with self._lock:
            del self._children[tuple(str(v) for v in values)]

    def clear(self) -> None:
        """Drop every labelled series (an unlabelled metric keeps its one)."""
        if self.labelnames:
            with self._lock:
                self._children.clear()

    def get(self, *values) -> float:
        """Current value of one series (0.0 when never written)."""
        child = self._children.get(tuple(str(v) for v in values))
        if child is None:
            return 0.0
        return float(child.fn()) if child.fn is not None else child.value

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
                    value = child.value if child.fn is None else float(child.fn())
                    lines.append(f"{self.name}{lbl()} {_fmt(value)}")
        return lines


REGISTRY: list[_Metric] = []


def Counter(name, documentation, labelnames=(), registry=None):  # noqa: N802 — prometheus idiom
    return _Metric("counter", name, documentation, labelnames, registry=registry)


def Gauge(name, documentation, labelnames=(), registry=None):  # noqa: N802
    return _Metric("gauge", name, documentation, labelnames, registry=registry)


def Histogram(name, documentation, labelnames=(), buckets=None,  # noqa: N802
              registry=None):
    return _Metric("histogram", name, documentation, labelnames, buckets, registry)


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


def drop_shard_gauges(shard: str) -> None:
    """Drop one shard's per-shard scorer GAUGE series when it dies or
    drains: its last queue-depth, wait and dispatch samples must not read
    as live. Counters stay (their rates go quiet on their own); the shard's
    micro-batcher rebinds its gauges on revive
    (``MicroBatcher.rebind_shard_gauges``)."""
    for g in (scorer_queue_depth, scorer_effective_wait,
              scorer_device_calls_per_flush, scorer_admission_queue_rows):
        try:
            g.remove(shard)
        except KeyError:
            pass  # never written for this shard yet


# the serving mesh (mesh/): the shard front's routing health, the inputs of
# monitoring/prometheus/rules/mesh-alerts.yml (ShardDown, ShardLoadSkew)
mesh_shards = Gauge(
    "mesh_shards",
    "Replica shards configured in the serving mesh's shard front",
)
mesh_shards_healthy = Gauge(
    "mesh_shards_healthy",
    "Shards currently accepting traffic (healthy, not draining/dead)",
)
mesh_shard_healthy = Gauge(
    "mesh_shard_healthy",
    "1 while this shard accepts traffic (ShardDown alert input)",
    ["shard"],
)
mesh_shard_inflight = Gauge(
    "mesh_shard_inflight",
    "Rows currently in flight on this shard's micro-batcher",
    ["shard"],
)
mesh_shard_rows = Counter(
    "mesh_shard_rows",
    "Rows scored by this shard (ShardLoadSkew reads the per-shard rates)",
    ["shard"],
)
mesh_shard_errors = Counter(
    "mesh_shard_errors",
    "Scoring failures on this shard (consecutive failures mark it dead)",
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

# the compile sentinel, device memory and the on-demand profiler
# (telemetry/): the xla_* and device_* names are the alerting contract of
# monitoring/prometheus/rules/telemetry-alerts.yml. On the port a "compile"
# is a kernel library built by nvcc or loaded into the process
# (telemetry/compile_sentinel)
xla_compiles = Counter(
    "xla_compiles",
    "XLA executable-cache misses per instrumented jitted entrypoint "
    "(_unattributed = backend compiles outside any instrumented call)",
    ["entrypoint"],
)
xla_compile_duration = Histogram(
    "xla_compile_duration_seconds",
    "Backend compile time attributed to the instrumented entrypoint",
    ["entrypoint"],
    buckets=(0.01, 0.05, 0.1, 0.5, 1, 5, 15, 30, 60, 120),
)
xla_recompile_storm = Gauge(
    "xla_recompile_storm",
    "1 while an entrypoint's unexpected-compile rate exceeds the storm "
    "threshold (RecompileStorm alert input; warmups never count)",
    ["entrypoint"],
)
device_memory_bytes_in_use = Gauge(
    "device_memory_bytes_in_use",
    "Accelerator memory in use, summed over local devices (0 when the "
    "backend reports no memory stats)",
)
device_memory_bytes_limit = Gauge(
    "device_memory_bytes_limit",
    "Accelerator memory capacity, summed over local devices",
)
device_memory_peak_bytes_in_use = Gauge(
    "device_memory_peak_bytes_in_use",
    "High-water mark of accelerator memory in use",
)
device_profiles = Counter(
    "device_profiles",
    "On-demand device trace captures completed (POST /admin/profile)",
)
device_profile_active = Gauge(
    "device_profile_active",
    "1 while an on-demand device trace capture is running",
)

# the SLO engine (telemetry/slo) and the live roofline gauges
# (telemetry/roofline): the slo_* and device_utilization names are the
# alerting contract of monitoring/prometheus/rules/slo-alerts.yml. The
# ``slo`` label is "<kind>:<series>", kind availability or latency, series
# a lane (json, msgpack, binary) or shard<N>
slo_burn_rate = Gauge(
    "slo_burn_rate",
    "Error-budget burn-rate multiple over each sliding window (bad-rate / "
    "allowed-rate; 1.0 = spending budget exactly at the sustainable pace). "
    "The multi-window multi-burn-rate alerts AND two windows so a blip "
    "cannot page and a slow leak cannot hide",
    ["slo", "window"],
)
slo_error_budget_remaining = Gauge(
    "slo_error_budget_remaining",
    "Fraction of the error budget left over the longest (6h) window "
    "(1 = untouched, 0 = spent, negative = overdrawn) — the panopticon "
    "budget gauge /slo/status reads",
    ["slo"],
)
slo_requests = Counter(
    "slo_requests",
    "Requests observed by the SLO engine per series and verdict "
    "(good|bad for availability; fast|slow for the latency objective)",
    ["slo", "verdict"],
)
device_utilization_fraction = Gauge(
    "device_utilization_fraction",
    "Achieved / peak FLOP-rate of each fused serving program over its "
    "recent flushes (XLA cost_analysis flops for the dispatched bucket ÷ "
    "measured device_compute stage time ÷ device peak) — the live roofline "
    "signal; the bench-time CPU-floor constants made continuous. "
    "DeviceUtilizationCollapse fires when a serving entrypoint's "
    "utilization collapses under live traffic",
    ["entrypoint"],
)
device_peak_flops_estimate = Gauge(
    "device_peak_flops_estimate",
    "Peak f32 FLOP/s the utilization gauges divide by: DEVICE_PEAK_FLOPS "
    "when pinned, else the warmup matmul probe's achieved rate",
)
device_program_flops = Gauge(
    "device_program_flops",
    "XLA cost_analysis flops of the LAST bucket each fused entrypoint "
    "dispatched (the roofline numerator; bytes ride the status endpoint)",
    ["entrypoint"],
)


# the longhaul fleet (longhaul/): the inputs of
# monitoring/prometheus/rules/longhaul-alerts.yml (HostDown,
# MembershipFlapping, FailoverStuck, FleetBudgetExhausted). Per-host gauges
# carry the ``host`` label; drop_host_gauges() drops them on leave or death
# and the directory rebinds ``longhaul_host_up`` on (re)join.
longhaul_membership_epoch = Gauge(
    "longhaul_membership_epoch",
    "Current membership epoch — the fleet's fence token; bumps on every "
    "join/death/leave/rejoin (MembershipFlapping alert input: a churning "
    "epoch means a host is oscillating through the failure detector)",
)
longhaul_hosts_live = Gauge(
    "longhaul_hosts_live",
    "Live members in the current membership view",
)
longhaul_host_up = Gauge(
    "longhaul_host_up",
    "1 while this member is live in the membership view, 0 once marked "
    "dead (HostDown alert input)",
    ["host"],
)
longhaul_host_heartbeat_age = Gauge(
    "longhaul_host_heartbeat_age_seconds",
    "Seconds since this member's last heartbeat reached the directory",
    ["host"],
)
longhaul_routed_rows = Counter(
    "longhaul_routed_rows",
    "Rows the front routed to each owning host, by request format "
    "(json/msgpack/binary)",
    ["host", "format"],
)
longhaul_route_errors = Counter(
    "longhaul_route_errors",
    "Transport/handler failures routing to a host (strikes toward its "
    "DEAD transition; explicit 503 backpressure is NOT counted here)",
    ["host"],
)
longhaul_unavailable = Counter(
    "longhaul_unavailable",
    "Requests the front answered 503 + Retry-After (owner inheriting, or "
    "no healthy host for the segment) — the degradation contract doing "
    "its job, never silent data loss",
)
longhaul_failovers = Counter(
    "longhaul_failovers",
    "Segment inheritances completed, labeled by the INHERITING host",
    ["host"],
)
longhaul_failover_in_progress = Gauge(
    "longhaul_failover_in_progress",
    "1 while a host is replaying a dead peer's journal+snapshot "
    "generation into its live table (FailoverStuck alert input)",
)
longhaul_failover_duration = Gauge(
    "longhaul_failover_duration_seconds",
    "Wall time of the last completed segment inheritance (peer recovery "
    "replay + segment merge + rebind)",
)
longhaul_inherited_rows = Counter(
    "longhaul_inherited_rows",
    "Journal rows replayed from dead peers' generations, labeled by the "
    "inheriting host",
    ["host"],
)
longhaul_replay_rows_per_sec = Gauge(
    "longhaul_replay_rows_per_sec",
    "Replay throughput of the last inheritance (journal rows/s through "
    "the traced ledger body)",
)
longhaul_scrape_stale_epoch = Counter(
    "longhaul_scrape_stale_epoch",
    "Host scrape contributions DROPPED from a fleet merge because they "
    "were reported under a different membership epoch (the split-brain "
    "double-count guard)",
    ["host"],
)
longhaul_fleet_budget_remaining = Gauge(
    "longhaul_fleet_budget_remaining",
    "Fleet-level SLO error budget remaining over the longest window, "
    "merged from per-host good/bad totals under ONE membership epoch "
    "(FleetBudgetExhausted alert input)",
    ["slo"],
)
longhaul_promotion_fenced = Counter(
    "longhaul_promotion_fenced",
    "Promotion finalizations REFUSED by the membership-epoch fence (the "
    "flip was decided under a stale epoch — a partitioned host must not "
    "move traffic)",
    ["host"],
)


def drop_host_gauges(host: str) -> None:
    """Drop one member's per-host GAUGE series when it dies or leaves: its
    last heartbeat-age sample must not read as live. Counters stay (their
    rates go quiet on their own); the directory rebinds
    ``longhaul_host_up`` on (re)join."""
    for g in (longhaul_host_heartbeat_age,):
        try:
            g.remove(host)
        except KeyError:
            pass  # never written for this host yet


def render(registry: list[_Metric] | None = None) -> bytes:
    """The text exposition of ``registry`` (default: the process's own
    :data:`REGISTRY`; a store server keeps its series in a list of its
    own, apart from the API's)."""
    lines: list[str] = []
    for metric in REGISTRY if registry is None else registry:
        lines.extend(metric.render())
    return ("\n".join(lines) + "\n").encode()


def start_http_server(port: int, host: str = "0.0.0.0",
                      registry: list[_Metric] | None = None, name: str = "metrics"):
    """Serve ``render(registry)`` on every GET path of ``port`` from a
    daemon thread; returns the server, whose ``shutdown()`` stops it."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 — http.server's name
            body = render(registry)
            self.send_response(200)
            self.send_header("Content-Type", CONTENT_TYPE_LATEST)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):  # scrapes are not worth a log line
            pass

    server = ThreadingHTTPServer((host, port), Handler)
    server.daemon_threads = True
    threading.Thread(target=server.serve_forever, name=name, daemon=True).start()
    return server


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
