"""Registry validation gate (the CD pipeline's promotion check).

The JAX package's ``validate_auc``: resolve the registered model by URI
(default ``models:/fraud@prod``) through whichever tracking client
``MLFLOW_TRACKING_URI`` names (file store or tracking server), score a
self-generated synthetic set (5,000 rows: one ``fused_score`` launch at the
8,192 bucket for a logistic model on the card), log ``auc_score`` and
``validation_pass`` to a ``model-validation`` run, and exit 1 below the
threshold.

    python -m fraud_detection_tpu_torch.validate_auc [--model-uri URI]
        [--threshold T] [--samples 5000]
"""

from __future__ import annotations

import argparse
import logging
import sys

import torch

from fraud_detection_tpu_torch import config
from fraud_detection_tpu_torch.data.synthetic import generate_synthetic_rows
from fraud_detection_tpu_torch.models import load_any_model
from fraud_detection_tpu_torch.ops.metrics import auc_roc
from fraud_detection_tpu_torch.tracking import TrackingClient

log = logging.getLogger("fraud_detection_tpu_torch.validate_auc")


def validate_auc(
    model_uri: str | None = None,
    threshold: float | None = None,
    n_samples: int = 5000,
    seed: int = 7,
    device=None,
) -> tuple[float, bool]:
    model_uri = model_uri or f"models:/{config.model_name()}@{config.model_stage()}"
    threshold = threshold if threshold is not None else config.auc_threshold()

    client = TrackingClient()
    model = load_any_model(client.registry.resolve(model_uri), device=device)

    x, y = generate_synthetic_rows(n_samples, fraud_ratio=0.05, seed=seed)
    scores = model.scorer.predict_proba(x)
    auc = float(auc_roc(torch.as_tensor(scores, device=model.device), y))
    passed = auc >= threshold

    with client.start_run("model-validation") as run:
        run.log_param("model_uri", model_uri)
        run.log_metric("auc_score", auc)
        run.set_tag("validation_pass", passed)

    log.info("validation AUC %.4f (threshold %.2f) → %s",
             auc, threshold, "PASS" if passed else "FAIL")
    return auc, passed


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model-uri", default=None)
    ap.add_argument("--threshold", type=float, default=None)
    ap.add_argument("--samples", type=int, default=5000)
    a = ap.parse_args(argv)
    auc, passed = validate_auc(a.model_uri, a.threshold, a.samples)
    print(f"auc={auc:.4f} pass={passed}")
    if not passed:
        sys.exit(1)


if __name__ == "__main__":
    main()
