"""The fraud-scoring API on the port.

- ``GET /status`` — liveness
- ``GET /health`` — readiness with per-dependency status, 503 when degraded
- ``POST /predict`` — validate → score through the micro-batcher (the fused
  flush: the family's score body + drift fold + optional reason codes) →
  respond with the JAX app's response fields
- ``GET /monitor/status`` — watchtower drift state and recommendation
- ``GET /metrics`` — Prometheus exposition

The model directory holds either family (``load_any_model``): the logistic
flagship (``fused_score`` kernel) or a GBT forest (TreeSHAP reason codes
through the ``tree_shap`` kernel).

The results database, the task queue and the SHAP worker are not in this
slice. ``/health`` therefore reports ``database``/``broker`` as
``"unavailable"`` (503, ``degraded``) and every ``/predict`` answers
``explanation_status: "Queue failed"`` — exactly what the JAX app answers
when those stores are down.

Run: ``python -m fraud_detection_tpu_torch.service.app --port 8000``
(``DEVICE=cpu`` serves on the CPU).
"""

from __future__ import annotations

import asyncio
import logging
import time
import uuid

from fraud_detection_tpu_torch.device import resolve_device
from fraud_detection_tpu_torch.monitor.watchtower import build_watchtower
from fraud_detection_tpu_torch.service import metrics
from fraud_detection_tpu_torch.service.http import App, HTTPError, Request, Response
from fraud_detection_tpu_torch.service.loading import load_production_model
from fraud_detection_tpu_torch.service.microbatch import AdmissionFull, MicroBatcher
from fraud_detection_tpu_torch.service.schemas import (
    HealthOut,
    PredictionOut,
    ReasonCodeOut,
    parse_entity,
    parse_transaction,
)

log = logging.getLogger("fraud_detection_tpu_torch.api")


def create_app(device=None) -> App:
    """The API over the model at ``MODEL_PATH``'s directory, served on
    ``device`` (default: ``DEVICE``, itself defaulting to ``cuda``). Raises
    at once when ``cuda`` is asked for and no card is present."""
    dev = resolve_device(device)
    app = App(title="fraud-detection-tpu-torch API")
    state: dict = {
        "model": None,
        "model_source": None,
        "batcher": None,
        "watchtower": None,
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
        try:
            model, source = load_production_model(device=dev)
            state["model"], state["model_source"] = model, source
            try:
                # monitoring must never take serving down
                state["watchtower"] = build_watchtower(model, source)
            except Exception as e:
                state["watchtower"] = None
                log.warning("watchtower startup failed (%s); unmonitored", e)
            batcher = MicroBatcher(model.scorer, watchtower=state["watchtower"])
            await batcher.start()  # warms the bucket ladder; can raise
            state["batcher"] = batcher
            metrics.model_loaded.set(1)
        except RuntimeError as e:
            metrics.model_loaded.set(0)
            state["model"] = state["batcher"] = None
            if state["watchtower"]:
                state["watchtower"].close()
                state["watchtower"] = None
            log.error("model load/warmup failed at startup: %s", e)

    async def shutdown():
        if state["batcher"]:
            await state["batcher"].stop()
        if state["watchtower"]:
            state["watchtower"].close()

    app.on_startup.append(startup)
    app.on_shutdown.append(shutdown)

    @app.get("/status")
    async def status(req: Request) -> Response:
        return Response({"status": "UP"})

    @app.get("/health")
    async def health(req: Request) -> Response:
        checks = {
            "model": "ok" if state["model"] is not None else "unavailable",
            # not in this slice: the results DB and the task broker
            "database": "unavailable",
            "broker": "unavailable",
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
        try:
            payload = req.json()
            features = parse_transaction(payload)
            row = model.prepare_row(features)
            parse_entity(payload)
        except ValueError as e:
            raise HTTPError(422, str(e)) from e
        reasons = None
        with metrics.timed(metrics.inference_duration):
            try:
                if batcher.explain:
                    score, reasons = await batcher.score_ex(row)
                else:
                    score = await batcher.score(row)
            except AdmissionFull as e:
                return Response(
                    {"detail": str(e)},
                    status_code=429,
                    headers={"retry-after": str(max(1, round(e.retry_after_s)))},
                )
        reason_codes = None
        if reasons is not None:
            names = model.feature_names
            reason_codes = [
                ReasonCodeOut(feature=names[int(i)], attribution=float(v))
                for i, v in zip(*reasons)
            ]
        return Response(
            PredictionOut(
                prediction=int(score >= 0.5),
                score=score,
                transaction_id=str(uuid.uuid4()),
                correlation_id=corr_id,
                # no task queue in this slice: the JAX app's queue-down answer
                explanation_status="Queue failed",
                reason_codes=reason_codes,
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
