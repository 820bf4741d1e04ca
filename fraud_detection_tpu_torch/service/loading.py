"""Serving-side model resolution.

This slice serves the native artifact directory beside ``MODEL_PATH``
(``model.npz`` + ``feature_names.json``). The registry alias and the joblib
artifacts — the JAX package's other two sources — are not ported yet.
Raises RuntimeError when nothing is loadable, so the API reports degraded
health instead of serving garbage.
"""

from __future__ import annotations

import logging
import os

from fraud_detection_tpu_torch import config
from fraud_detection_tpu_torch.models import load_any_model

log = logging.getLogger("fraud_detection_tpu_torch.loading")


def load_production_model(device=None):
    """Returns ``(model, "native:<dir>")``."""
    model_dir = os.path.dirname(config.model_path()) or "."
    if not os.path.exists(os.path.join(model_dir, "model.npz")):
        raise RuntimeError(
            f"no model available: no model.npz beside {config.model_path()}"
        )
    model = load_any_model(model_dir, device=device)
    log.info("loaded native artifacts from %s", model_dir)
    return model, f"native:{model_dir}"
