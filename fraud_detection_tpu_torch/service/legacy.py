"""The legacy synchronous scoring API (the reference ``deploy.py``'s
contract), on the port.

The port's own copy of the JAX package's ``service/legacy.py``: ``GET /``
answers a liveness banner; ``POST /predict`` takes a feature dict (or a
list, or ``{"features": ...}``) and answers ``{prediction,
fraud_probability, alert}`` with ``alert = probability > 0.8``, and 500
``{"error": ...}`` on any failure. One process, no broker or results DB,
port 5000. It scores through the port's model, so on a card the linear
family runs the ``fused_score`` kernel.

Run: ``python -m fraud_detection_tpu_torch.service.legacy`` (``DEVICE=cpu``
serves on the CPU).
"""

from __future__ import annotations

import logging

from fraud_detection_tpu_torch.device import resolve_device
from fraud_detection_tpu_torch.service.http import App, Request, Response

log = logging.getLogger("fraud_detection_tpu_torch.legacy")

ALERT_THRESHOLD = 0.8


def create_app(model=None, device=None) -> App:
    """The legacy app over ``model``, or over the production model
    (``service.loading``) loaded at startup on ``device`` (default:
    ``DEVICE``, itself defaulting to ``cuda``)."""
    dev = resolve_device(device) if model is None else None
    app = App(title="fraud-detection-tpu-torch legacy API")
    state = {"model": model}
    app.state = state

    async def startup():
        if state["model"] is None:
            from fraud_detection_tpu_torch.service.loading import load_production_model

            state["model"], src = load_production_model(device=dev)
            log.info("legacy API loaded model from %s", src)

    app.on_startup.append(startup)

    @app.get("/")
    async def index(req: Request) -> Response:
        return Response({"msg": "Fraud Detection API is live"})

    @app.post("/predict")
    async def predict(req: Request) -> Response:
        model = state["model"]
        if model is None:
            return Response({"error": "model not loaded"}, status_code=500)
        # every failure, malformed input included, answers 500 {"error"}
        try:
            payload = req.json()
            features = (
                payload.get("features", payload) if isinstance(payload, dict) else payload
            )
            label, prob = model.score_one(features)
        # lockcheck: ignore[silent-except] — the contract: any error → 500 with the message
        except Exception as e:  # noqa: BLE001
            return Response({"error": str(e)}, status_code=500)
        return Response({
            "prediction": int(label),
            "fraud_probability": round(float(prob), 4),
            "alert": bool(prob > ALERT_THRESHOLD),
        })

    return app


def main():
    import argparse

    from fraud_detection_tpu_torch.service.http import run

    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=5000)
    args = ap.parse_args()
    run(create_app(), args.host, args.port)


if __name__ == "__main__":
    main()
