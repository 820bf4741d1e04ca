"""Native model artifacts: ``model.npz`` + ``feature_names.json``.

The same layout the JAX package reads and writes, so either package serves
the other's model: ``coef``, ``intercept`` and, with a scaler,
``scaler_mean``/``scaler_scale``/``scaler_var``/``scaler_n`` — all float64
on disk, float32 in memory. The GBT keys (``gbt_*``) are recognised by
:func:`artifact_kind`; loading a forest belongs to a later slice. The
joblib interchange is not ported.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from fraud_detection_tpu_torch.ckpt.atomic import atomic_savez
from fraud_detection_tpu_torch.ops.logistic import LogisticParams
from fraud_detection_tpu_torch.ops.scaler import ScalerParams

NATIVE_FILE = "model.npz"
FEATURES_FILE = "feature_names.json"


def artifact_kind(directory: str) -> str:
    """``'logistic'`` | ``'gbt'`` | ``'absent'`` — dispatch key for loaders."""
    path = os.path.join(directory, NATIVE_FILE)
    if not os.path.exists(path):
        return "absent"
    with np.load(path) as z:
        return "gbt" if "gbt_leaf_value" in z else "logistic"


def _f64(t) -> np.ndarray:
    return np.asarray(
        t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t,
        np.float64,
    )


def save_artifacts(
    directory: str,
    params: LogisticParams,
    scaler: ScalerParams | None,
    feature_names: list[str],
) -> str:
    os.makedirs(directory, exist_ok=True)
    state = {"coef": _f64(params.coef), "intercept": _f64(params.intercept)}
    if scaler is not None:
        state.update(
            scaler_mean=_f64(scaler.mean),
            scaler_scale=_f64(scaler.scale),
            scaler_var=_f64(scaler.var),
            scaler_n=_f64(scaler.n_samples),
        )
    atomic_savez(os.path.join(directory, NATIVE_FILE), **state)
    with open(os.path.join(directory, FEATURES_FILE), "w") as f:
        json.dump(list(feature_names), f)
    return directory


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32))


def params_from_arrays(
    arrays,
) -> tuple[LogisticParams, ScalerParams | None]:
    """(LogisticParams, ScalerParams | None) on the CPU from the
    ``model.npz`` keys (any mapping of name → array)."""
    params = LogisticParams(
        coef=_f32(arrays["coef"]).reshape(-1),
        intercept=_f32(arrays["intercept"]).reshape(()),
    )
    scaler = None
    if "scaler_mean" in arrays:
        scaler = ScalerParams(
            mean=_f32(arrays["scaler_mean"]).reshape(-1),
            scale=_f32(arrays["scaler_scale"]).reshape(-1),
            var=_f32(arrays["scaler_var"]).reshape(-1),
            n_samples=_f32(arrays["scaler_n"]).reshape(()),
        )
    return params, scaler


def load_artifacts(
    directory: str,
) -> tuple[LogisticParams, ScalerParams | None, list[str]]:
    with np.load(os.path.join(directory, NATIVE_FILE)) as z:
        if "coef" not in z:
            raise ValueError(
                f"{directory} holds {artifact_kind(directory)} artifacts, "
                "not logistic"
            )
        params, scaler = params_from_arrays({k: z[k] for k in z.files})
    with open(os.path.join(directory, FEATURES_FILE)) as f:
        feature_names = json.load(f)
    return params, scaler, feature_names
