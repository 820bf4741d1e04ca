"""The fraud-scoring API on the port.

- ``GET /`` — the dashboard (``frontend/index.html``) when present, else a
  JSON banner
- ``GET /health`` — readiness with per-dependency status, 503 when degraded
- ``POST /predict`` — validate → score through the micro-batcher (the fused
  flush: the family's score body + drift fold + optional reason codes; for
  a ledger-widened model the ledger flush, keyed by the optional
  ``entity_id`` and ``timestamp``; for a wide model the wide flush, keyed
  by the optional ``entity_id``) →
  persist a PENDING row, enqueue ``xai_tasks.compute_shap`` for the SHAP
  worker (``service/worker.py``) → respond with the JAX app's response
  fields
- ``POST /ingest/batch`` — a block of rows in one request: the binary
  lane's frame (``application/x-fraud-frame``) or a msgpack body, admitted
  as one item of the micro-batcher; 429 + ``Retry-After`` at the admission
  bound
- ``GET /explain/{transaction_id}`` — the worker's stored explanation
- ``GET /monitor/status`` — watchtower drift state and recommendation
- ``POST /monitor/feedback`` — delayed fraud labels into the calibration
  window and the durable lifecycle store (``persisted: true``), with
  optional ``entity_ids`` and ``timestamps`` for the ledger's replay
- ``GET /lifecycle/status`` — the conductor's state machine, the feedback
  pools, and the version being served
- ``POST /admin/reload`` — one registry alias sweep now: a moved ``@prod``
  or ``@shadow`` is loaded, warmed and hot-swapped before the response
  (``ADMIN_TOKEN`` gates it when set)
- ``GET /lifeboat/status`` — the lifeboat's state, snapshot generations,
  journal sequence and fsync lag, and the last recovery's report
  (``{"enabled": false, "state": "disabled"}`` without a lifeboat)
- ``GET /debug/flightrecorder`` — the last scored requests' stage
  timelines (``SPYGLASS_ENABLED``, ``FLIGHTRECORDER_CAPACITY``; under the
  shard front every shard's ring, merged)
- ``GET /mesh/status`` — the shard front's shards: health, rows in flight,
  routed rows and errors (``{"enabled": false}`` with one batcher)
- ``POST /admin/shard/drain`` — drain or revive one shard (409 without a
  front, for a shard with nothing to drain, or for the last healthy
  shard; 422 on a bad body; ``ADMIN_TOKEN`` gates it when set)
- ``GET /slo/status`` — the SLO engine's burn rates over the 5m/1h/6h
  windows, error budgets and objectives by lane, and the roofline's peaks,
  program costs and per-entrypoint utilization (``SLO_ENABLED``)
- ``POST /admin/profile`` — a ``torch.profiler`` trace of everything the
  process runs for ``duration_s`` seconds (at most
  ``DEVICE_PROFILE_MAX_S``, one capture at a time: 409 while one runs, 422
  on a bad duration; ``ADMIN_TOKEN`` gates it when set)
- ``GET /metrics`` — Prometheus exposition; a scrape refreshes the
  device-memory gauges, the recompile-storm windows and the SLO gauges

With ``INGEST_PORT`` > 0 the binary ingest lane (``service/binlane.py``)
listens beside the HTTP server and feeds the same micro-batcher, so its
scores are bitwise ``/predict``'s for the same f32 rows. With a challenger
registered at ``@shadow`` the watchtower shadow-scores a sample of batches;
with ``WATCHTOWER_RETRAIN_TRIGGER=1`` a drift episode enqueues one
``watchtower.trigger_retrain`` task on the broker, and with
``CONDUCTOR_AUTO_PROMOTE=1`` a promote/rollback recommendation one of the
conductor's tasks; the worker (``service/worker.py``) runs them.

The served model lives in a ``ModelSlot`` (``lifecycle/swap.py``): the
micro-batcher reads it once a flush and the binary lane once a frame, and
the ``ModelReloader`` (polling every ``LIFECYCLE_RELOAD_INTERVAL_S``, and on
``POST /admin/reload``) swaps a promoted model in between two flushes,
rebinding the watchtower to its profile (and a ledger champion's table).
The lifecycle store (``LIFECYCLE_DB_URL``, default the broker's database)
opens at start-up; a store that fails to open leaves the API serving, with
``/monitor/feedback`` answering ``persisted: false``.

With ``LIFEBOAT_DIR`` set and a ledger model served with a watchtower,
the lifeboat (``lifeboat/``) journals every ledger flush's entity triples
ahead of its launches, snapshots the card's table and drift window off the
hot path, and on start-up replays the newest generation plus the journal
tail on its own thread: until it binds, ``/health``, ``/predict``,
``/ingest/batch`` and the binary lane answer 503 (a status-3 frame) with
``Retry-After``. A failed recovery logs and serves the train-time stamp.

The serving mesh: with ``MESH_FLUSH_DEVICES=N`` (N = 2, 4, 8) the fused
flush runs over N shards of the serving device, each with its own drift
window and ledger sub-table (``mesh/shardflush``); ``MESH_MODEL_DEVICES=M``
(a power of two) adds the model axis: a ``data × M`` grid, on which the
wide family's cross table is column-sharded over the model shards and
every other family splits its rows over the whole grid (the model knob
alone builds a ``1 × M`` grid). With ``MESH_SHARDS=N`` N
micro-batchers serve behind the shard front (``mesh/front``): a request
that no shard can take answers 503 + Retry-After (a status-3 frame on the
binary lane).

The model directory holds either family (``load_any_model``): the logistic
flagship (``fused_score`` kernel; ledger-widened when the directory holds
``ledger_state.npz``, wide when it holds ``wide_params.npz``) or a GBT
forest (TreeSHAP reason codes through the ``tree_shap`` kernel). The
results DB (``DATABASE_URL``) and the broker (``CELERY_BROKER_URL``) are
the JAX package's sqlite schemas, so a JAX app or worker can share them.

Telemetry (``telemetry/``): start-up sets up tracing (with
``OTEL_EXPORTER_OTLP_ENDPOINT``), installs the compile sentinel before any
scorer is built and declares the lanes' SLO objectives. Every ``/predict``,
``/ingest/batch`` and binary-lane outcome feeds the lane's SLO; a traced
``/predict`` opens a ``predict`` span with the six stages as child spans,
and its ``traceparent`` rides the task to the worker's ``compute_shap``
span; a frame with a trace field, or an ``/ingest/batch`` with a
``traceparent`` header, opens an ``ingest.frame`` span.

Run: ``python -m fraud_detection_tpu_torch.service.app --port 8000``
(``DEVICE=cpu`` serves on the CPU).
"""

from __future__ import annotations

import asyncio
import hmac
import logging
import os
import sqlite3
import threading
import time
import uuid

import numpy as np

from fraud_detection_tpu_torch import config
from fraud_detection_tpu_torch.device import resolve_device
from fraud_detection_tpu_torch.ledger.state import entity_fingerprint
from fraud_detection_tpu_torch.lifecycle import (
    ModelReloader,
    ModelSlot,
    open_lifecycle_store,
)
from fraud_detection_tpu_torch.mesh import NoHealthyShards, ShardFront, serving_mesh
from fraud_detection_tpu_torch.mesh.front import HEALTHY, DRAINING
from fraud_detection_tpu_torch.monitor.watchtower import RETRAIN_TASK, build_watchtower
from fraud_detection_tpu_torch.service import binlane, metrics, tracing
from fraud_detection_tpu_torch.service.db import ResultsDB
from fraud_detection_tpu_torch.service.errors import StoreError
from fraud_detection_tpu_torch.service.http import App, HTTPError, Request, Response
from fraud_detection_tpu_torch.service.loading import (
    load_production_model,
    resolve_source_version,
)
from fraud_detection_tpu_torch.service.microbatch import (
    AdmissionFull,
    IngestBlock,
    MicroBatcher,
)
from fraud_detection_tpu_torch.service.schemas import (
    ExplanationFailedOut,
    ExplanationOut,
    HealthOut,
    PredictionOut,
    ReasonCodeOut,
    parse_entity,
    parse_transaction,
)
from fraud_detection_tpu_torch.service.taskq import TASK_NAME, Broker
from fraud_detection_tpu_torch.telemetry import (
    FlightRecorder,
    RecorderSet,
    RequestTimeline,
    compile_sentinel,
    devicemem,
    roofline,
    slo,
)
from fraud_detection_tpu_torch.telemetry.profiler import DeviceProfiler, ProfileBusy

log = logging.getLogger("fraud_detection_tpu_torch.api")

_OBSERVE_PARSE = metrics.request_stage_duration.labels("parse").observe
_frontend_cache: dict[str | None, bytes] = {}

# what a lifecycle-store call raises when the store is down: the endpoints
# that ride it answer 503 + Retry-After instead of a 500
_STORE_OUTAGE_ERRORS = (sqlite3.Error, StoreError, OSError)
STORE_RETRY_AFTER_S = 10
#: the lifeboat's warm restart: the journal replay takes seconds at any sane
#: snapshot cadence, one short client backoff covers it
LIFEBOAT_RETRY_AFTER_S = 5
_RECOVERING_DETAIL = (
    "lifeboat warm restart in progress — replaying the entity journal "
    "through the ledger's read-update"
)


def _store_unavailable(what: str, e: Exception) -> Response:
    """The reference's store-outage body: ``error`` names the outage,
    ``detail`` carries the store's own message."""
    log.warning("%s unavailable (store outage): %s", what, e)
    return Response(
        {"error": f"{what} temporarily unavailable — store outage", "detail": str(e)},
        status_code=503,
        headers={"retry-after": str(STORE_RETRY_AFTER_S)},
    )


def _no_healthy_shards(e: NoHealthyShards) -> Response:
    """Every shard of the front dead or draining: a retryable capacity
    outage, 503 + Retry-After (the half-open probe re-admits a rested shard
    within about ``MESH_SHARD_REOPEN_S``)."""
    return Response(
        {"error": "no healthy scoring shards", "detail": str(e)},
        status_code=503,
        headers={"retry-after": str(max(int(config.mesh_shard_reopen_s()), 1))},
    )


def _admission_shed(e: AdmissionFull, lane_shed) -> Response:
    """A full admission queue answers 429 + Retry-After."""
    lane_shed.inc()
    return Response(
        {"detail": str(e)},
        status_code=429,
        headers={"retry-after": str(max(1, round(e.retry_after_s)))},
    )


def _frontend_index() -> bytes | None:
    """``frontend/index.html``: under ``FRONTEND_DIR`` when it is set (a
    missing page there is logged, not replaced), else beside the package,
    else under the working directory. Cached once found."""
    explicit = os.environ.get("FRONTEND_DIR")
    cached = _frontend_cache.get(explicit)
    if cached is not None:
        return cached
    if explicit is not None:
        dirs = [explicit]
    else:
        dirs = [os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..",
                             "frontend"), "frontend"]
    page = None
    for d in dirs:
        path = os.path.join(d, "index.html")
        if os.path.exists(path):
            with open(path, "rb") as f:
                page = f.read()
            break
    else:
        if explicit is not None:
            log.warning("FRONTEND_DIR=%s has no index.html — UI disabled", explicit)
    if page is not None:  # a missing page stays re-checkable
        _frontend_cache[explicit] = page
    return page


def create_app(
    database_url: str | None = None, broker_url: str | None = None, device=None
) -> App:
    """The API over the production model (``service.loading``: the registry's
    ``@prod``, else ``MODEL_PATH``'s directory, else its joblib files), served on
    ``device`` (default: ``DEVICE``, itself defaulting to ``cuda``), with
    the results DB at ``database_url`` (default ``DATABASE_URL``) and the
    broker at ``broker_url`` (default ``CELERY_BROKER_URL``). Raises at once
    when ``cuda`` is asked for and no card is present."""
    dev = resolve_device(device)
    app = App(title="fraud-detection-tpu-torch API")
    state: dict = {
        "model": None,
        "model_source": None,
        "batcher": None,
        "db": None,
        "broker": None,
        "watchtower": None,
        "slot": None,
        "reloader": None,
        "lifecycle_store": None,
        "flightrecorder": None,
        "binlane": None,
        "lifeboat": None,
        "profiler": None,
        "started_at": None,
    }
    app.state = state  # exposed for tests/embedding

    def _require_admin(req: Request) -> None:
        """The admin gate of ``/admin/reload``, ``/admin/profile`` and
        ``/admin/shard/drain``: with ``ADMIN_TOKEN`` set, the request
        carries it (``X-Admin-Token`` or ``Authorization: Bearer``); empty
        leaves the endpoints open."""
        token = config.admin_token()
        if not token:
            return
        supplied = req.headers.get("x-admin-token")
        if supplied is None:
            auth = req.headers.get("authorization", "")
            if auth.lower().startswith("bearer "):
                supplied = auth[7:].strip()
        # bytes: compare_digest raises on a non-ASCII str
        if supplied is None or not hmac.compare_digest(
            supplied.encode(), token.encode()
        ):
            raise HTTPError(401, "admin token required")

    def _model():
        """The served model: the slot's (the one swappable reference);
        ``state["model"]`` only seeds it at start-up."""
        slot = state["slot"]
        return slot.model if slot is not None else state["model"]

    def _recovering() -> bool:
        boat = state["lifeboat"]
        return boat is not None and boat.state == "recovering"

    def _recovering_response() -> Response | None:
        """The lifeboat's warm-restart gate: while the journal replay
        rebuilds the entity table, readiness and scoring (rows folded now
        would land in a table about to be replaced) answer 503 +
        Retry-After."""
        if not _recovering():
            return None
        return Response(
            {"error": "recovering", "detail": _RECOVERING_DETAIL},
            status_code=503,
            headers={"retry-after": str(LIFEBOAT_RETRY_AFTER_S)},
        )

    def _lane_unavailable():
        """The binary lane's twin of :func:`_recovering_response`."""
        if not _recovering():
            return None
        return (
            "lifeboat warm restart in progress — entity journal replaying; "
            "retry shortly",
            float(LIFEBOAT_RETRY_AFTER_S),
        )

    def _start_lifeboat(model):
        """The lifeboat, with ``LIFEBOAT_DIR`` set, a ledger model and a
        watchtower: built on the watchtower's drift monitor, ``recovering``
        before its recovery thread starts; the thread recovers, then starts
        the maintenance thread. A failed recovery logs and serves the
        train-time stamp. Returns the boat or None."""
        lb_dir = config.lifeboat_dir()
        if not lb_dir:
            return None
        spec = getattr(model, "ledger_spec", None)
        drift = getattr(state["watchtower"], "drift", None)
        if spec is None or drift is None:
            log.warning(
                "LIFEBOAT_DIR set but the served model carries no ledger (or "
                "monitoring is down) — durability layer disabled"
            )
            return None
        try:
            from fraud_detection_tpu_torch.lifeboat import Lifeboat

            boat = Lifeboat(lb_dir, spec, drift=drift, slot=state["slot"])
            boat.state = "recovering"  # the gate before the thread runs
            state["lifeboat"] = boat

            def _warm_restart() -> None:
                try:
                    boat.recover()
                except Exception:
                    log.exception("lifeboat warm restart failed")
                    boat.state = "ready"  # serve the train-time stamp
                boat.start()  # a no-op once a shutdown closed the boat

            threading.Thread(
                target=_warm_restart, name="lifeboat-recover", daemon=True
            ).start()
            return boat
        except Exception as e:
            state["lifeboat"] = None
            log.error("lifeboat startup failed: %s", e)
            return None

    def _ingest_scale(model):
        """The int8-layout dequant scale of the LIVE model, cached a scorer:
        it changes only with a hot swap, which changes the scorer."""
        cached = state.get("_ingest_scale")
        if cached is not None and cached[0] is model.scorer:
            return cached[1]
        scale = binlane.ingest_dequant_scale(model)
        state["_ingest_scale"] = (model.scorer, scale)
        return scale

    async def correlation_and_metrics(req: Request, nxt):
        corr_id = req.headers.get("x-correlation-id") or str(uuid.uuid4())
        req.state["correlation_id"] = corr_id
        t0 = time.perf_counter()
        resp = await nxt(req)
        handler = app.route_template(req.path)
        metrics.http_requests.labels(req.method, handler, str(resp.status_code)).inc()
        metrics.http_request_duration.labels(req.method, handler).observe(
            time.perf_counter() - t0
        )
        resp.headers["x-correlation-id"] = corr_id
        return resp

    app.add_middleware(correlation_and_metrics)

    async def startup():
        state["started_at"] = time.time()
        tracing.setup_tracing()
        # the compile sentinel wraps the serving entrypoints before any
        # scorer is built
        compile_sentinel.install()
        # the lanes' objectives exist (at 0 burn) from the first scrape
        slo_engine = slo.engine()
        if slo_engine is not None:
            slo_engine.declare_lanes()
        state["profiler"] = DeviceProfiler(device=dev)
        cap = config.flightrecorder_capacity()
        n_shards = config.mesh_shards()
        recorders = []
        if cap > 0 and config.spyglass_enabled():
            # under the shard front one ring a shard behind the merged view
            recorders = [FlightRecorder(cap) for _ in range(max(n_shards, 1))]
            state["flightrecorder"] = (
                RecorderSet(recorders) if n_shards > 1 else recorders[0]
            )
        state["db"] = ResultsDB(database_url)
        state["broker"] = Broker(broker_url)
        try:
            # durable labeled feedback (the conductor's training replay);
            # must never take serving down: without it /monitor/feedback
            # still feeds the calibration window, just not the store
            state["lifecycle_store"] = open_lifecycle_store(
                config.lifecycle_db_url(broker_url)
            )
        except Exception as e:
            state["lifecycle_store"] = None
            log.warning("lifecycle store unavailable (%s)", e)
        try:
            model, source = load_production_model(device=dev)
            state["model"], state["model_source"] = model, source

            def _retrain_sender(reason: str) -> None:
                state["broker"].send_task(RETRAIN_TASK, [reason])

            def _action_sender(task: str, reason: str) -> None:
                state["broker"].send_task(task, [reason])

            # the serving mesh (MESH_FLUSH_DEVICES × MESH_MODEL_DEVICES; the
            # model knob alone builds a 1 × M grid, so the wide family's
            # table column-shards without data sharding): built before the
            # watchtower's try, so a setting the mesh refuses (a model axis
            # not a power of two, an explicit grid above 8) fails the
            # start-up instead of leaving an unmonitored app
            mesh = None
            if config.mesh_flush_devices() > 1 or config.mesh_model_devices() > 1:
                mesh = serving_mesh(devices=[dev])
            try:
                # monitoring must never take serving down
                state["watchtower"] = build_watchtower(
                    model, source, retrain_sender=_retrain_sender,
                    action_sender=_action_sender, mesh=mesh,
                )
            except Exception as e:
                state["watchtower"] = None
                log.warning("watchtower startup failed (%s); unmonitored", e)
            state["slot"] = ModelSlot(model, source, resolve_source_version(source))
            metrics.lifecycle_active_model_version.set(state["slot"].version or 0)
            boat = _start_lifeboat(model)
            if n_shards > 1:
                # the shard front (MESH_SHARDS): replica batchers behind a
                # router; they share the slot, so a swap lands on every
                # shard between flushes, and a revive (after an outage)
                # asks the lifeboat for a generation now
                batcher = ShardFront(
                    [
                        MicroBatcher(
                            slot=state["slot"], watchtower=state["watchtower"],
                            recorder=recorders[i] if recorders else None,
                            lifeboat=boat, shard_id=i,
                        )
                        for i in range(n_shards)
                    ],
                    on_revive=(
                        (lambda _shard: boat.request_snapshot())
                        if boat is not None else None
                    ),
                )
            else:
                batcher = MicroBatcher(
                    slot=state["slot"], watchtower=state["watchtower"],
                    recorder=state["flightrecorder"], lifeboat=boat,
                )
            await batcher.start()  # warms the bucket ladder; can raise
            state["batcher"] = batcher
            # the alias watcher: a promotion reaches this process without a
            # restart (poll + POST /admin/reload)
            reloader = ModelReloader(
                state["slot"], watchtower=state["watchtower"], device=dev
            )
            reloader.start()
            state["reloader"] = reloader
            if config.ingest_port() > 0:
                try:
                    lane = binlane.BinaryIngestServer(
                        batcher,
                        scorer_fn=lambda: state["slot"].model.scorer,
                        model_fn=lambda: state["slot"].model,
                        unavailable_fn=_lane_unavailable,
                    )
                    lane.start(asyncio.get_running_loop())
                    state["binlane"] = lane
                except Exception as e:
                    # the HTTP lanes keep serving: the binary lane is the
                    # fast path, never the availability story
                    state["binlane"] = None
                    log.error("binary ingest lane failed to start: %s", e)
            metrics.model_loaded.set(1)
        except RuntimeError as e:
            metrics.model_loaded.set(0)
            state["model"] = state["batcher"] = state["slot"] = None
            if state["lifeboat"]:
                state["lifeboat"].close()
                state["lifeboat"] = None
            if state["watchtower"]:
                state["watchtower"].close()
                state["watchtower"] = None
            log.error("model load/warmup failed at startup: %s", e)

    async def shutdown():
        if state["binlane"]:
            await asyncio.to_thread(state["binlane"].stop)
            state["binlane"] = None
        if state["reloader"]:
            state["reloader"].stop()
        if state["batcher"]:
            await state["batcher"].stop()
        if state["lifeboat"]:
            # after the batcher drained: a flush in flight still journals
            # under the flush lock. No final snapshot, as the reference: the
            # close syncs the journal, so a clean shutdown loses nothing
            await asyncio.to_thread(state["lifeboat"].close)
            state["lifeboat"] = None
        if state["watchtower"]:
            state["watchtower"].close()
        if state["db"]:
            state["db"].close()
        if state["broker"]:
            state["broker"].close()
        if state["lifecycle_store"]:
            state["lifecycle_store"].close()

    app.on_startup.append(startup)
    app.on_shutdown.append(shutdown)

    @app.get("/")
    async def index(req: Request) -> Response:
        """The dashboard page when ``frontend/index.html`` is present, else
        a JSON banner."""
        page = _frontend_index()
        if page is not None:
            return Response(page, media_type="text/html; charset=utf-8")
        return Response({"msg": "fraud-detection-tpu API is live", "ui": "unavailable"})

    @app.get("/status")
    async def status(req: Request) -> Response:
        return Response({"status": "UP"})

    @app.get("/health")
    async def health(req: Request) -> Response:
        # the lifeboat recovering: readiness is gated, a load balancer must
        # not admit traffic into a table mid-replay
        recovering = _recovering_response()
        if recovering is not None:
            return recovering
        # both pings run concurrently off the loop: a stalled store slows
        # this probe, never scoring
        db_ok, broker_ok = await asyncio.gather(
            asyncio.to_thread(lambda: bool(state["db"] and state["db"].ping())),
            asyncio.to_thread(
                lambda: bool(state["broker"] and state["broker"].ping())
            ),
        )
        checks = {
            "model": "ok" if _model() is not None else "unavailable",
            "database": "ok" if db_ok else "unavailable",
            "broker": "ok" if broker_ok else "unavailable",
        }
        healthy = all(v == "ok" for v in checks.values())
        slot = state["slot"]
        body = HealthOut(
            status="healthy" if healthy else "degraded",
            checks=checks,
            model_source=slot.source if slot is not None else state["model_source"],
            uptime_seconds=time.time() - (state["started_at"] or time.time()),
        )
        return Response(body.to_dict(), status_code=200 if healthy else 503)

    @app.post("/predict")
    async def predict(req: Request) -> Response:
        metrics.predictions_submitted.inc()
        corr_id = req.state["correlation_id"]
        t_req = time.perf_counter()
        recovering = _recovering_response()
        if recovering is not None:
            # flow control seconds from ready, not an outage: no SLO burn
            return recovering
        model = _model()
        batcher = state["batcher"]
        if model is None or batcher is None:
            # an unservable request burns the json lane's availability
            slo.record_lane("json", False)
            raise HTTPError(503, "model not loaded")
        t_parse = time.perf_counter()
        try:
            payload = req.json()
            features = parse_transaction(payload)
            row = model.prepare_row(features)
            entity_id, event_ts = parse_entity(payload)
        except ValueError as e:
            raise HTTPError(422, str(e)) from e
        _OBSERVE_PARSE(time.perf_counter() - t_parse)
        metrics.ingest_requests.labels("json").inc()
        # the ledger: hash the entity once at the edge; the (slot,
        # fingerprint, origin-relative time) triple rides the queue item
        # into the ledger flush. Entity-less requests (or a stateless
        # model) pass None and score through the null slot.
        entity = None
        ledger_spec = getattr(model, "ledger_spec", None)
        if ledger_spec is not None and entity_id is not None:
            slot_idx, fp = ledger_spec.row_keys(entity_id)
            entity = (slot_idx, fp, ledger_spec.rel_ts(event_ts or time.time()))
        elif getattr(model, "wide_spec", None) is not None and entity_id is not None:
            # the wide family keys its crosses on the fingerprint alone (the
            # ledger's edge hash: one keyspace)
            entity = (0, entity_fingerprint(entity_id), 0.0)
        timeline = (
            RequestTimeline(correlation_id=corr_id) if batcher.telemetry else None
        )
        reasons = None
        with tracing.span("predict", correlation_id=corr_id):
            with metrics.timed(metrics.inference_duration):
                try:
                    if batcher.explain:
                        score, reasons = await batcher.score_ex(row, timeline, entity)
                    else:
                        score = await batcher.score(row, timeline, entity)
                except AdmissionFull as e:
                    slo.record_lane("json", False)
                    return _admission_shed(e, metrics.ingest_shed.labels("json"))
                except NoHealthyShards as e:
                    log.error("[%s] no healthy shards: %s", corr_id, e)
                    slo.record_lane("json", False)
                    return _no_healthy_shards(e)
                except Exception:
                    # an internal scoring failure (a 500) burns availability
                    slo.record_lane("json", False)
                    raise
            metrics.ingest_rows.labels("json").inc()
            slo.record_lane("json", True, time.perf_counter() - t_req)
            if timeline is not None:
                # the stage decomposition as child spans of this span
                tracing.emit_stage_spans(timeline)
            # serialized inside the span: it rides the task to the worker's
            # compute_shap span
            traceparent = tracing.current_traceparent()
        reason_codes = None
        serve_topk = None
        if reasons is not None:
            idxs, vals = reasons
            names = model.feature_names
            reason_codes = [
                ReasonCodeOut(feature=names[int(i)], attribution=float(v))
                for i, v in zip(idxs, vals)
            ]
            # the serve-time top-k rides the task payload so the worker's
            # full-vector backfill can consistency-check the fused leg
            serve_topk = {
                "indices": [int(i) for i in idxs],
                "values": [float(v) for v in vals],
            }

        # Persist the PENDING row and enqueue the async explanation, off the
        # loop (sqlite commits wait on the file lock). The payload is the
        # JAX app's: 4 arguments (the traceparent None with tracing off), a
        # 5th only when the fused explain leg gave a top-k.
        feature_dict = dict(zip(model.feature_names, row.tolist()))
        tx_id = str(uuid.uuid4())
        explanation_status = "queued"
        task_args = [tx_id, feature_dict, corr_id, traceparent]
        if serve_topk is not None:
            task_args.append(serve_topk)

        def _persist_and_enqueue():
            with metrics.timed(metrics.db_latency):
                state["db"].create_pending(tx_id, feature_dict, corr_id)
            state["broker"].send_task(TASK_NAME, task_args, correlation_id=corr_id)

        try:
            await asyncio.to_thread(_persist_and_enqueue)
        except Exception as e:
            # a queue outage must not fail scoring (api/app.py:248-250)
            log.error("[%s] enqueue failed: %s", corr_id, e)
            explanation_status = "Queue failed"

        return Response(
            PredictionOut(
                prediction=int(score >= 0.5),
                score=score,
                transaction_id=tx_id,
                correlation_id=corr_id,
                explanation_status=explanation_status,
                reason_codes=reason_codes,
            ).to_dict()
        )

    @app.post("/ingest/batch")
    async def ingest_batch(req: Request) -> Response:
        """A block of rows in one POST, admitted as ONE micro-batcher item
        (one future, not one a row), as the binary lane admits a frame:

        - ``application/x-fraud-frame``: the binary lane's frame payload;
          the response is its response payload (scores f32, optional
          reason codes);
        - ``application/msgpack``: ``{"rows": [[...]], "entity_fps":
          [...], "timestamps": [...]}``; the response is msgpack (415 where
          msgpack is not installed).

        A full admission queue answers 429 + Retry-After; scores are
        bitwise ``/predict``'s for the same f32 rows."""
        recovering = _recovering_response()
        if recovering is not None:
            return recovering
        model = _model()
        batcher = state["batcher"]
        if model is None or batcher is None:
            raise HTTPError(503, "model not loaded")
        scorer = model.scorer
        max_rows = min(
            config.ingest_max_rows() or config.scorer_max_batch(),
            binlane.batcher_max_batch(batcher),
        )
        ctype = req.headers.get("content-type", "").split(";")[0].strip().lower()
        t_parse = time.perf_counter()
        # a frame's trace field, else the HTTP traceparent header, links
        # this lane's ingest.frame span to the client's trace
        trace = req.headers.get("traceparent")
        if trace is not None and not tracing.parse_traceparent(trace):
            trace = None
        if ctype == "application/x-fraud-frame":
            lane = "binary"
            try:
                slot, n, entity, frame_trace = binlane.decode_frame_body(
                    scorer, req.body, max_rows, dequant=_ingest_scale(model)
                )
                trace = frame_trace or trace
            except binlane.FrameError as e:
                metrics.ingest_frame_errors.labels(e.kind).inc()
                raise HTTPError(422, str(e)) from e
        elif ctype == "application/msgpack":
            lane = "msgpack"
            try:
                import msgpack
            except ImportError as e:
                raise HTTPError(415, "msgpack not available") from e
            try:
                payload = msgpack.unpackb(req.body)
                slot, n, entity = binlane.block_from_arrays(
                    scorer, np.asarray(payload["rows"], np.float32),
                    payload.get("entity_fps"), payload.get("timestamps"), max_rows,
                )
            except binlane.FrameError as e:
                metrics.ingest_frame_errors.labels(e.kind).inc()
                raise HTTPError(422, str(e)) from e
            except Exception as e:
                # unpack errors, ragged rows, non-numeric values: all client
                # input errors
                raise HTTPError(422, f"bad msgpack batch: {e}") from e
        else:
            raise HTTPError(
                415, "use application/x-fraud-frame or application/msgpack"
            )
        _OBSERVE_PARSE(time.perf_counter() - t_parse)
        metrics.ingest_requests.labels(lane).inc()
        try:
            timeline = (
                RequestTimeline(correlation_id=req.state["correlation_id"])
                if batcher.telemetry else None
            )
            try:
                ek = await batcher.score_block(IngestBlock(slot, n, entity), timeline)
            except AdmissionFull as e:
                slo.record_lane(lane, False)
                return _admission_shed(e, metrics.ingest_shed.labels(lane))
            except NoHealthyShards as e:
                slo.record_lane(lane, False)
                return _no_healthy_shards(e)
            except Exception:
                slo.record_lane(lane, False)
                raise
            metrics.ingest_rows.labels(lane).inc(n)
            slo.record_lane(lane, True, time.perf_counter() - t_parse)
            if trace is not None and tracing._tracer is not None:
                with tracing.span("ingest.frame", traceparent=trace, lane=lane, rows=n):
                    if timeline is not None:
                        tracing.emit_stage_spans(timeline)
            if lane == "binary":
                return Response(
                    binlane.encode_response_body(slot, n, ek),
                    media_type="application/x-fraud-frame",
                )
            out = {"n": n, "scores": slot.scores[:n].tolist()}
            if ek:
                out["reason_idx"] = slot.ei[:n, :ek].tolist()
                out["reason_val"] = slot.ev[:n, :ek].tolist()
            return Response(msgpack.packb(out), media_type="application/msgpack")
        finally:
            scorer.staging.release(slot)

    @app.get("/explain/{transaction_id}")
    async def explain(req: Request) -> Response:
        tx_id = req.path_params["transaction_id"]
        with metrics.timed(metrics.db_latency):
            row = await asyncio.to_thread(state["db"].get, tx_id)
        if row is None or row["status"] == "PENDING":
            raise HTTPError(
                404,
                "Explanation not found. The transaction may still be pending.",
            )
        if row["status"] == "FAILED":
            return Response(
                ExplanationFailedOut(
                    transaction_id=tx_id,
                    status="FAILED",
                    error=(row.get("shap_values") or {}).get("error"),
                ).to_dict()
            )
        return Response(
            ExplanationOut(
                transaction_id=tx_id,
                status=row["status"],
                shap_values=row["shap_values"],
                expected_value=row["expected_value"],
                prediction_score=row["prediction_score"],
                created_at=row["created_at"],
            ).to_dict()
        )

    @app.get("/monitor/status")
    async def monitor_status(req: Request) -> Response:
        wt = state["watchtower"]
        if wt is None:
            return Response(
                {"enabled": False, "status": "disabled", "recommendation": "none"}
            )
        # status() copies small device arrays to the host: off the loop
        return Response(await asyncio.to_thread(wt.status))

    @app.get("/mesh/status")
    async def mesh_status(req: Request) -> Response:
        """The shard front's state: each shard's health, rows in flight and
        routed row and error totals; ``enabled: false`` with one batcher
        (``MESH_SHARDS`` unset)."""
        batcher = state["batcher"]
        if batcher is None or not hasattr(batcher, "shards"):
            return Response({"enabled": False, "shards": 0})
        body = {"enabled": True}
        body.update(batcher.status())
        return Response(body)

    @app.post("/admin/shard/drain")
    async def admin_shard_drain(req: Request) -> Response:
        """Drain or revive one shard: ``{"shard": 0, "action": "drain"}``.
        A drain stops new routing and waits (10 s at most) for the shard's
        in-flight rows; 409 without a front, for a shard that is neither
        healthy nor draining, or for the last healthy shard; 422 on a bad
        body. ``ADMIN_TOKEN`` gates it when set."""
        _require_admin(req)
        batcher = state["batcher"]
        if batcher is None or not hasattr(batcher, "shards"):
            raise HTTPError(409, "mesh front not enabled (MESH_SHARDS)")
        try:
            payload = req.json()
            shard = int(payload["shard"])
            action = payload.get("action", "drain")
            if not 0 <= shard < len(batcher.shards):
                raise ValueError(f"shard must be in [0, {len(batcher.shards)})")
            if action not in ("drain", "revive"):
                raise ValueError("action must be 'drain' or 'revive'")
        except (KeyError, TypeError, ValueError) as e:
            raise HTTPError(422, str(e)) from e
        if action == "revive":
            batcher.revive(shard)
            return Response({"shard": shard, "action": "revive"})
        state_now = batcher.shards[shard].state
        if state_now not in (HEALTHY, DRAINING):
            # drain() would do nothing on a dead or half-open shard
            raise HTTPError(
                409, f"shard {shard} is {state_now!r} — nothing to drain (revive it instead)"
            )
        try:
            batcher.drain(shard)
        except ValueError as e:  # the last healthy shard
            raise HTTPError(409, str(e)) from e
        drained = await asyncio.to_thread(batcher.wait_drained, shard, 10.0)
        return Response({"shard": shard, "action": "drain", "drained": drained})

    @app.post("/monitor/feedback")
    async def monitor_feedback(req: Request) -> Response:
        """Delayed fraud-label feedback: ``{"features": [[...30], ...],
        "scores": [...], "labels": [0|1, ...]}`` with optional
        ``entity_ids`` and ``timestamps`` (epoch s). The rows join the
        watchtower's ingest queue and fold into the calibration window only
        (they were observed live when scored), and land in the durable
        lifecycle store, the conductor's retrain replay (``persisted``)."""
        wt = state["watchtower"]
        model = _model()
        if wt is None or model is None:
            raise HTTPError(
                409, "watchtower disabled — no baseline profile loaded"
            )
        try:
            payload = req.json()
            if not isinstance(payload, dict):
                raise ValueError("body must be a JSON object")
            feats = payload.get("features")
            scores = payload.get("scores")
            labels = payload.get("labels")
            if not isinstance(feats, list) or not feats:
                raise ValueError("'features' must be a non-empty list of rows")
            if (
                not isinstance(scores, list)
                or not isinstance(labels, list)
                or len(feats) != len(scores)
                or len(feats) != len(labels)
            ):
                raise ValueError(
                    "'features', 'scores' and 'labels' must be lists of "
                    "equal length"
                )
            rows = np.stack([model.prepare_row(f) for f in feats])
            if not np.all(np.isfinite(rows)):
                raise ValueError("'features' must be finite numbers")
            scores_arr = np.asarray(scores, np.float32)
            labels_arr = np.asarray(labels, np.float32)
            if scores_arr.ndim != 1 or labels_arr.ndim != 1:
                # nested lists pass the length checks, then would fail on
                # the ingest thread after the 202
                raise ValueError("'scores' and 'labels' must be flat lists")
            if not (
                np.all(np.isfinite(scores_arr))
                and np.all((scores_arr >= 0) & (scores_arr <= 1))
            ):
                raise ValueError("'scores' must be probabilities in [0, 1]")
            if not np.all((labels_arr == 0) | (labels_arr == 1)):
                raise ValueError("'labels' must be 0 or 1")
            # per-row entity + event time: the ledger retrain's replay input
            entity_ids = payload.get("entity_ids")
            timestamps = payload.get("timestamps")
            if entity_ids is not None and (
                not isinstance(entity_ids, list)
                or len(entity_ids) != len(feats)
            ):
                raise ValueError(
                    "'entity_ids' must be a list aligned with 'features'"
                )
            if timestamps is not None:
                if not isinstance(timestamps, list) or len(timestamps) != len(
                    feats
                ):
                    raise ValueError(
                        "'timestamps' must be a list aligned with 'features'"
                    )
                ts_arr = np.asarray(timestamps, np.float64)
                if ts_arr.ndim != 1 or not np.all(
                    np.isfinite(ts_arr) & (ts_arr > 0)
                ):
                    raise ValueError(
                        "'timestamps' must be positive finite numbers"
                    )
        except (TypeError, ValueError) as e:
            # TypeError too: prepare_row over a non-iterable row or
            # np.asarray over nulls are client input errors, not 500s
            raise HTTPError(422, str(e)) from e
        queued = wt.observe(rows, scores_arr, labels_arr, calibration_only=True)
        # the durable copy for the conductor's retrain replay, only on the
        # 202 path: a 429 tells the client to retry, and persisting before
        # a retry would put the rows in the training window twice. Off the
        # loop (a sqlite write) and best-effort: the calibration window got
        # the rows either way.
        persisted = False
        store = state["lifecycle_store"]
        if queued and store is not None:
            try:
                await asyncio.to_thread(
                    store.add_feedback, rows, scores_arr, labels_arr,
                    entity_ids, timestamps,
                )
                persisted = True
            except _STORE_OUTAGE_ERRORS as e:
                # the store is down: the client retries later; the durable
                # pool never got the rows, so a retry cannot duplicate them
                return _store_unavailable("feedback persistence", e)
            except Exception:
                log.warning("feedback persistence failed", exc_info=True)
        return Response(
            {"queued": queued, "rows": int(rows.shape[0]), "persisted": persisted},
            status_code=202 if queued else 429,
        )

    @app.get("/lifecycle/status")
    async def lifecycle_status(req: Request) -> Response:
        """The conductor's state machine and the feedback pools: where the
        episode stands (idle/retraining/gated/shadowing/promoting/done/
        rolled_back), the versions involved, the gate's evidence, and the
        version this process serves."""
        store = state["lifecycle_store"]
        if store is None:
            return Response({"enabled": False, "state": "unavailable"})

        def _read():
            s = store.get_state(config.model_name())
            s["feedback"] = store.feedback_counts()
            slot = state["slot"]
            s["serving_version"] = slot.version if slot else None
            s["serving_source"] = slot.source if slot else state["model_source"]
            s["enabled"] = True
            return s

        try:
            return Response(await asyncio.to_thread(_read))
        except _STORE_OUTAGE_ERRORS as e:
            return _store_unavailable("lifecycle status", e)

    @app.get("/slo/status")
    async def slo_status(req: Request) -> Response:
        """The SLO engine's live state: each objective's burn rates over the
        5m/1h/6h windows, its error budget left, the declared objectives,
        and the roofline's peaks, program costs and utilization;
        ``enabled: false`` with ``SLO_ENABLED=0``."""
        eng = slo.engine()
        if eng is None:
            return Response({"enabled": False, "slos": {}})
        snap = await asyncio.to_thread(eng.export_gauges)
        return Response({
            "enabled": True,
            "latency_threshold_s": eng.latency_threshold_s,
            "windows": eng.windows,
            "fast_burn_threshold": config.slo_fast_burn(),
            "slow_burn_threshold": config.slo_slow_burn(),
            "slos": snap,
            "roofline": roofline.snapshot(),
        })

    @app.post("/admin/profile")
    async def admin_profile(req: Request) -> Response:
        """A device trace of the live service: everything the process runs
        for ``duration_s`` seconds (in ``(0, DEVICE_PROFILE_MAX_S]``, one
        capture at a time), returned as the trace's path. ``ADMIN_TOKEN``
        gates it when set. A profiler that fails answers 5xx."""
        _require_admin(req)
        profiler = state["profiler"]
        if profiler is None:
            raise HTTPError(503, "profiler unavailable")
        body = req.json() if req.body else {}
        if body is None:
            body = {}
        if not isinstance(body, dict):
            raise HTTPError(422, "body must be a JSON object")
        duration = body.get("duration_s")
        try:
            # the capture blocks for its whole window: off the loop, so the
            # scoring it records keeps flowing
            result = await asyncio.to_thread(profiler.capture, duration)
        except ProfileBusy as e:
            raise HTTPError(409, str(e)) from e
        except (TypeError, ValueError) as e:
            raise HTTPError(422, str(e)) from e
        return Response(result)

    @app.post("/admin/reload")
    async def admin_reload(req: Request) -> Response:
        """One registry alias sweep NOW (the poll-independent half of the
        hot swap): a moved ``@prod``/``@shadow`` is loaded, warmed and
        swapped in before the response returns. ``ADMIN_TOKEN`` gates it
        when set."""
        _require_admin(req)
        reloader = state["reloader"]
        if reloader is None:
            raise HTTPError(503, "no reloader — model not loaded")
        result = await asyncio.to_thread(reloader.check_once)
        slot = state["slot"]
        result["serving_version"] = slot.version if slot else None
        result["serving_source"] = slot.source if slot else None
        return Response(result)

    @app.get("/lifeboat/status")
    async def lifeboat_status(req: Request) -> Response:
        """The durability layer: the recovery's report, the snapshot
        generations on disk, the journal's sequence and fsync lag;
        ``enabled: false`` without ``LIFEBOAT_DIR`` or a ledger model."""
        boat = state["lifeboat"]
        if boat is None:
            return Response({"enabled": False, "state": "disabled"})
        body = {"enabled": True}
        body.update(await asyncio.to_thread(boat.status))
        return Response(body)

    @app.get("/debug/flightrecorder")
    async def flightrecorder(req: Request) -> Response:
        """The flight recorder's dump: the last scored requests with their
        six stage timelines, newest first."""
        rec = state["flightrecorder"]
        if rec is None:
            return Response(
                {"enabled": False, "records": [],
                 "hint": "FLIGHTRECORDER_CAPACITY=0 or SPYGLASS_ENABLED=0"}
            )
        return Response({
            "enabled": True,
            "capacity": rec.capacity,
            "total_recorded": rec.total_recorded,
            # under the shard front: per-shard rings merged, every record
            # carrying the shard that ran its flush
            "shards": len(getattr(rec, "recorders", (rec,))),
            "records": rec.dump(),
        })

    @app.get("/metrics")
    async def prom(req: Request) -> Response:
        if state["watchtower"]:
            try:
                # refresh the drift gauges so scrapes see current statistics
                await asyncio.to_thread(state["watchtower"].status)
            except Exception:  # a scrape must not fail on a broken monitor
                log.debug("watchtower gauge refresh failed", exc_info=True)

        def _telemetry_refresh():
            # the device-memory watermark, the recompile-storm windows (a
            # storm clears once its window drains, with no new loads) and
            # the SLO burn and budget gauges (a burn clears likewise)
            devicemem.refresh(dev)
            compile_sentinel.refresh_storm_gauges()
            eng = slo.engine()
            if eng is not None:
                eng.export_gauges()

        try:
            await asyncio.to_thread(_telemetry_refresh)
        except Exception:
            log.debug("telemetry gauge refresh failed", exc_info=True)
        return Response(metrics.render(), media_type=metrics.CONTENT_TYPE_LATEST)

    return app


def main():
    import argparse

    from fraud_detection_tpu_torch.service.http import run

    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8000)
    args = ap.parse_args()
    run(create_app(), args.host, args.port)


if __name__ == "__main__":
    main()
