"""Serving-side model resolution with fallback, in the JAX package's order:

1. the registry alias ``models:/{MLFLOW_MODEL_NAME}@{MLFLOW_MODEL_STAGE}``
   through whichever tracking client ``MLFLOW_TRACKING_URI`` names (file
   store or tracking server);
2. the native artifact directory beside ``MODEL_PATH`` (``model.npz``);
3. the reference's joblib artifacts (``MODEL_PATH``, ``SCALER_PATH``,
   ``FEATURE_NAMES_PATH``).

``REQUIRE_REGISTRY_MODEL=1`` stops at 1. Raises ``RuntimeError`` when
nothing is loadable, so the API reports degraded health instead of serving
garbage. The source strings are the JAX package's:
``registry:models:/fraud@prod``, ``native:<dir>``, ``joblib:<path>``.

:func:`load_shadow_model` resolves the watchtower's challenger from the
registry alone.
"""

from __future__ import annotations

import logging
import os

from fraud_detection_tpu_torch import config
from fraud_detection_tpu_torch.models import FraudLogisticModel, load_any_model
from fraud_detection_tpu_torch.tracking import TrackingClient

log = logging.getLogger("fraud_detection_tpu_torch.loading")


def load_production_model(device=None):
    """Returns ``(model, source)``; the model on ``device`` (default
    ``DEVICE``)."""
    uri = f"models:/{config.model_name()}@{config.model_stage()}"
    try:
        art = TrackingClient().registry.resolve(uri)
        model = load_any_model(art, device=device)
        log.info("loaded model from registry %s (%s)", uri, art)
        return model, f"registry:{uri}"
    except (FileNotFoundError, ValueError) as e:
        if config.require_registry_model():
            raise RuntimeError(
                f"registry model {uri} unavailable ({e}) and "
                "REQUIRE_REGISTRY_MODEL=1 forbids local-artifact fallback"
            ) from e
        log.warning("registry load failed (%s); falling back to local artifacts", e)

    model_dir = os.path.dirname(config.model_path()) or "."
    if os.path.exists(os.path.join(model_dir, "model.npz")):
        model = load_any_model(model_dir, device=device)
        log.info("loaded native artifacts from %s", model_dir)
        return model, f"native:{model_dir}"

    if os.path.exists(config.model_path()):
        scaler_path = config.scaler_path()
        model = FraudLogisticModel.load_joblib(
            config.model_path(),
            scaler_path if os.path.exists(scaler_path) else None,
            config.feature_names_path(),
            device=device,
        )
        log.info("loaded joblib artifacts from %s", config.model_path())
        return model, f"joblib:{config.model_path()}"

    raise RuntimeError(
        f"no model available: registry {uri} empty and no artifacts at "
        f"{config.model_path()}"
    )


def resolve_source_version(source: str) -> int | None:
    """The registry version behind a :func:`load_production_model` source
    (``registry:models:/fraud@prod`` → the aliased version); None for a
    local-artifact source or when the registry cannot say."""
    kind, _, uri = source.partition(":")
    if kind != "registry":
        return None
    from fraud_detection_tpu_torch.tracking.registry import parse_model_uri

    try:
        name, alias, version = parse_model_uri(uri)
        if version is not None:
            return version
        registry = TrackingClient().registry
        if alias is None:
            return registry.latest_version(name)
        return registry.get_version_by_alias(name, alias)
    except (OSError, ValueError) as e:
        log.debug("source version resolution failed for %s: %s", source, e)
        return None


def load_shadow_model(device=None):
    """The shadow challenger ``models:/{MLFLOW_MODEL_NAME}@{MLFLOW_SHADOW_STAGE}``
    as ``(model, source)`` on ``device``, or None when the alias does not
    exist. Registry only, no local fallback: a challenger is an explicit
    registration, never whatever sits on disk."""
    uri = f"models:/{config.model_name()}@{config.shadow_stage()}"
    try:
        art = TrackingClient().registry.resolve(uri)
    except (FileNotFoundError, ValueError) as e:
        log.debug("no shadow challenger at %s (%s)", uri, e)
        return None
    model = load_any_model(art, device=device)
    log.info("loaded shadow challenger from %s (%s)", uri, art)
    return model, f"registry:{uri}"
