"""The fraud-scoring API on the port.

- ``GET /`` — the dashboard (``frontend/index.html``) when present, else a
  JSON banner
- ``GET /health`` — readiness with per-dependency status, 503 when degraded
- ``POST /predict`` — validate → score through the micro-batcher (the fused
  flush: the family's score body + drift fold + optional reason codes; for
  a ledger-widened model the ledger flush, keyed by the optional
  ``entity_id`` and ``timestamp``) →
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
  window
- ``GET /debug/flightrecorder`` — the last scored requests' stage
  timelines (``SPYGLASS_ENABLED``, ``FLIGHTRECORDER_CAPACITY``)
- ``GET /metrics`` — Prometheus exposition

With ``INGEST_PORT`` > 0 the binary ingest lane (``service/binlane.py``)
listens beside the HTTP server and feeds the same micro-batcher, so its
scores are bitwise ``/predict``'s for the same f32 rows. With a challenger
registered at ``@shadow`` the watchtower shadow-scores a sample of batches;
with ``WATCHTOWER_RETRAIN_TRIGGER=1`` a drift episode enqueues one
``watchtower.trigger_retrain`` task on the broker.

The model directory holds either family (``load_any_model``): the logistic
flagship (``fused_score`` kernel; ledger-widened when the directory holds
``ledger_state.npz``) or a GBT forest (TreeSHAP reason codes
through the ``tree_shap`` kernel). The results DB (``DATABASE_URL``) and the
broker (``CELERY_BROKER_URL``) are the JAX package's sqlite schemas, so a
JAX app or worker can share them.

Run: ``python -m fraud_detection_tpu_torch.service.app --port 8000``
(``DEVICE=cpu`` serves on the CPU).
"""

from __future__ import annotations

import asyncio
import logging
import os
import time
import uuid

import numpy as np

from fraud_detection_tpu_torch import config
from fraud_detection_tpu_torch.device import resolve_device
from fraud_detection_tpu_torch.monitor.watchtower import RETRAIN_TASK, build_watchtower
from fraud_detection_tpu_torch.service import binlane, metrics
from fraud_detection_tpu_torch.service.db import ResultsDB
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
from fraud_detection_tpu_torch.telemetry import FlightRecorder, RequestTimeline

log = logging.getLogger("fraud_detection_tpu_torch.api")

_OBSERVE_PARSE = metrics.request_stage_duration.labels("parse").observe
_frontend_cache: dict[str | None, bytes] = {}


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
        "flightrecorder": None,
        "binlane": None,
        "ingest_scale": None,
        "started_at": None,
    }
    app.state = state  # exposed for tests/embedding

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
        cap = config.flightrecorder_capacity()
        if cap > 0 and config.spyglass_enabled():
            state["flightrecorder"] = FlightRecorder(cap)
        state["db"] = ResultsDB(database_url)
        state["broker"] = Broker(broker_url)
        try:
            model, source = load_production_model(device=dev)
            state["model"], state["model_source"] = model, source
            # the int8-layout frames' dequant scale (the HELLO's on the lane)
            state["ingest_scale"] = binlane.ingest_dequant_scale(model)

            def _retrain_sender(reason: str) -> None:
                state["broker"].send_task(RETRAIN_TASK, [reason])

            try:
                # monitoring must never take serving down
                state["watchtower"] = build_watchtower(
                    model, source, retrain_sender=_retrain_sender
                )
            except Exception as e:
                state["watchtower"] = None
                log.warning("watchtower startup failed (%s); unmonitored", e)
            batcher = MicroBatcher(
                model.scorer, watchtower=state["watchtower"],
                recorder=state["flightrecorder"], model_source=source,
                model_version=resolve_source_version(source),
            )
            await batcher.start()  # warms the bucket ladder; can raise
            state["batcher"] = batcher
            if config.ingest_port() > 0:
                try:
                    lane = binlane.BinaryIngestServer(
                        batcher, scorer=model.scorer, model=model
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
            state["model"] = state["batcher"] = None
            if state["watchtower"]:
                state["watchtower"].close()
                state["watchtower"] = None
            log.error("model load/warmup failed at startup: %s", e)

    async def shutdown():
        if state["binlane"]:
            await asyncio.to_thread(state["binlane"].stop)
            state["binlane"] = None
        if state["batcher"]:
            await state["batcher"].stop()
        if state["watchtower"]:
            state["watchtower"].close()
        if state["db"]:
            state["db"].close()
        if state["broker"]:
            state["broker"].close()

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
        # both pings run concurrently off the loop: a stalled store slows
        # this probe, never scoring
        db_ok, broker_ok = await asyncio.gather(
            asyncio.to_thread(lambda: bool(state["db"] and state["db"].ping())),
            asyncio.to_thread(
                lambda: bool(state["broker"] and state["broker"].ping())
            ),
        )
        checks = {
            "model": "ok" if state["model"] is not None else "unavailable",
            "database": "ok" if db_ok else "unavailable",
            "broker": "ok" if broker_ok else "unavailable",
        }
        healthy = all(v == "ok" for v in checks.values())
        body = HealthOut(
            status="healthy" if healthy else "degraded",
            checks=checks,
            model_source=state["model_source"],
            uptime_seconds=time.time() - (state["started_at"] or time.time()),
        )
        return Response(body.to_dict(), status_code=200 if healthy else 503)

    @app.post("/predict")
    async def predict(req: Request) -> Response:
        metrics.predictions_submitted.inc()
        corr_id = req.state["correlation_id"]
        model = state["model"]
        batcher = state["batcher"]
        if model is None or batcher is None:
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
        timeline = (
            RequestTimeline(correlation_id=corr_id) if batcher.telemetry else None
        )
        reasons = None
        with metrics.timed(metrics.inference_duration):
            try:
                if batcher.explain:
                    score, reasons = await batcher.score_ex(row, timeline, entity)
                else:
                    score = await batcher.score(row, timeline, entity)
            except AdmissionFull as e:
                return _admission_shed(e, metrics.ingest_shed.labels("json"))
        metrics.ingest_rows.labels("json").inc()
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
        # JAX app's: 4 arguments (the traceparent None: no tracing yet), a
        # 5th only when the fused explain leg gave a top-k.
        feature_dict = dict(zip(model.feature_names, row.tolist()))
        tx_id = str(uuid.uuid4())
        explanation_status = "queued"
        task_args = [tx_id, feature_dict, corr_id, None]
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
        model = state["model"]
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
        if ctype == "application/x-fraud-frame":
            lane = "binary"
            try:
                slot, n, entity, _trace = binlane.decode_frame_body(
                    scorer, req.body, max_rows, dequant=state["ingest_scale"]
                )
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
                return _admission_shed(e, metrics.ingest_shed.labels(lane))
            metrics.ingest_rows.labels(lane).inc(n)
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

    @app.post("/monitor/feedback")
    async def monitor_feedback(req: Request) -> Response:
        """Delayed fraud-label feedback, the calibration (windowed ECE)
        input: ``{"features": [[...30], ...], "scores": [...], "labels":
        [0|1, ...]}``. The rows join the watchtower's ingest queue and fold
        into the calibration window only (they were observed live when
        scored). ``persisted`` is false: the durable feedback store is the
        lifecycle tier (ROADMAP item 11)."""
        wt = state["watchtower"]
        model = state["model"]
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
            # per-row entity + event time, validated as in the JAX app (the
            # retrain replay that reads them is ROADMAP item 11)
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
        return Response(
            {"queued": queued, "rows": int(rows.shape[0]), "persisted": False},
            status_code=202 if queued else 429,
        )

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
            "shards": 1,
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
