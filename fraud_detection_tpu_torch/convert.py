"""Weights carried across from the JAX package.

The JAX package's parameters arrive as numpy arrays — ``np.asarray`` of its
``LogisticParams``/``ScalerParams`` fields, or the ``model.npz`` keys — and
become the port's objects. Nothing of the JAX package is imported: the
arrays are the whole interface.
"""

from __future__ import annotations

import numpy as np
import torch

from fraud_detection_tpu_torch.ckpt.checkpoint import gbt_model_from_arrays, params_from_arrays
from fraud_detection_tpu_torch.models.logistic import FraudLogisticModel
from fraud_detection_tpu_torch.monitor.baseline import BaselineProfile
from fraud_detection_tpu_torch.ops.gbt import GBTModel
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


def gbt_from_arrays(arrays: dict[str, np.ndarray], device=None) -> GBTModel:
    """The port's :class:`GBTModel` from the JAX package's ``GBTModel``
    fields (``split_feature``, ``split_bin``, ``leaf_value``, ``bin_edges``,
    ``base_logit``) or the ``gbt_*`` keys of its ``model.npz``; on the CPU
    unless ``device`` is given."""
    keyed = {(k if k.startswith("gbt_") else f"gbt_{k}"): np.asarray(v)
             for k, v in arrays.items()}
    model = gbt_model_from_arrays(keyed)
    return model if device is None else model.to(device)


def tree_explainer_from_arrays(model: GBTModel, bg_table, expected_value):
    """The port's ``TreeShapExplainer`` over ``model`` from a JAX
    ``TreeShapExplainer``'s ``bg_table`` and ``expected_value`` (numpy),
    with the kernel's tables where the model is on the card."""
    from fraud_detection_tpu_torch.ops.tree_shap import TreeShapExplainer, kernel_tables

    dev = model.split_feature.device
    bg = torch.as_tensor(np.array(bg_table, np.float32), device=dev)
    ev = torch.as_tensor(np.array(expected_value, np.float32), device=dev).reshape(())
    return TreeShapExplainer(model=model, bg_table=bg, expected_value=ev,
                             tables=kernel_tables(model, bg))
