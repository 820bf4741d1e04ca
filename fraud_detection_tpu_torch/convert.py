"""Weights carried across from the JAX package.

The JAX package's parameters arrive as numpy arrays — ``np.asarray`` of its
``LogisticParams``/``ScalerParams`` fields, or the ``model.npz`` keys — and
become the port's objects. Nothing of the JAX package is imported: the
arrays are the whole interface.
"""

from __future__ import annotations

import numpy as np
import torch

from fraud_detection_tpu_torch.ckpt.checkpoint import params_from_arrays
from fraud_detection_tpu_torch.models.logistic import FraudLogisticModel
from fraud_detection_tpu_torch.monitor.baseline import BaselineProfile
from fraud_detection_tpu_torch.ops.logistic import LogisticParams
from fraud_detection_tpu_torch.ops.quant import QuantCalibration
from fraud_detection_tpu_torch.ops.scaler import ScalerParams

#: the JAX NamedTuple field names → the ``model.npz`` keys
_FIELD_ALIASES = {
    "mean": "scaler_mean",
    "scale": "scaler_scale",
    "var": "scaler_var",
    "n_samples": "scaler_n",
}


def logistic_from_arrays(
    arrays: dict[str, np.ndarray], feature_names, device=None
) -> FraudLogisticModel:
    """The port's :class:`FraudLogisticModel` from the JAX parameters.

    ``arrays`` holds ``coef`` and ``intercept`` and, for a scaled model,
    the scaler stats under either their ``model.npz`` names
    (``scaler_mean``, ``scaler_scale``, ``scaler_var``, ``scaler_n``) or
    the ``ScalerParams`` field names (``mean``, ``scale``, ``var``,
    ``n_samples``)."""
    keyed = {_FIELD_ALIASES.get(k, k): np.asarray(v) for k, v in arrays.items()}
    params, scaler = params_from_arrays(keyed)
    return FraudLogisticModel(params, scaler, list(feature_names), device=device)


def profile_from_arrays(arrays: dict[str, np.ndarray]) -> BaselineProfile:
    """The port's :class:`BaselineProfile` from the fields of the JAX
    package's ``BaselineProfile`` (or the ``monitor_profile.npz`` keys)."""
    return BaselineProfile(
        feature_edges=np.asarray(arrays["feature_edges"], np.float32),
        feature_counts=np.asarray(arrays["feature_counts"], np.float32),
        score_edges=np.asarray(arrays["score_edges"], np.float32),
        score_counts=np.asarray(arrays["score_counts"], np.float32),
        score_quantiles=np.asarray(arrays["score_quantiles"], np.float32),
        n_rows=int(np.asarray(arrays["n_rows"])),
        feature_names=tuple(str(n) for n in arrays["feature_names"]),
    )


def scaler_from_arrays(arrays: dict[str, np.ndarray]) -> ScalerParams:
    """The port's :class:`ScalerParams` (on the CPU) from the fields of the
    JAX package's ``ScalerParams`` or the ``scaler_*`` keys of
    ``model.npz``."""
    keyed = {_FIELD_ALIASES.get(k, k): v for k, v in arrays.items()}
    return ScalerParams(*(
        torch.as_tensor(np.asarray(keyed[k], np.float32))
        for k in ("scaler_mean", "scaler_scale", "scaler_var", "scaler_n")
    ))


def params_from_jax_arrays(arrays: dict[str, np.ndarray]) -> LogisticParams:
    """The port's :class:`LogisticParams` (on the CPU) from ``coef`` and
    ``intercept`` of the JAX package's ``LogisticParams``."""
    params, _ = params_from_arrays(
        {"coef": arrays["coef"], "intercept": arrays["intercept"]}
    )
    return params


def calibration_from_arrays(arrays: dict[str, np.ndarray]) -> QuantCalibration:
    """The port's :class:`QuantCalibration` from the JAX package's (its
    ``scale`` and ``sigma_range`` fields, or the npz keys)."""
    return QuantCalibration(
        scale=np.asarray(arrays["scale"], np.float32),
        sigma_range=float(np.asarray(arrays["sigma_range"])),
    )
