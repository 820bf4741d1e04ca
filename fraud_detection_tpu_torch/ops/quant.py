"""Quantization calibration: the per-feature scale behind the int8 wire.

A numpy copy of the JAX package's ``QuantCalibration``,
``derive_calibration``, ``save_calibration`` and ``load_calibration``. The
trainer stamps ``quant_calibration.npz`` beside ``model.npz`` so that a
model serves the int8 wire on its own training profile, in either package.
The quantized wire itself is a later slice.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

CALIBRATION_FILE = "quant_calibration.npz"

#: symmetric range in training sigmas the int8 lattice spans per feature
DEFAULT_SIGMA_RANGE = 8.0


@dataclass(frozen=True)
class QuantCalibration:
    """``scale`` is the dequant scale: raw value ≈ code · scale."""

    scale: np.ndarray  # (d,) float32
    sigma_range: float = DEFAULT_SIGMA_RANGE


def _np32(a) -> np.ndarray:
    if hasattr(a, "detach"):  # a torch tensor, possibly on the card
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float32)


def derive_calibration(scaler, sigma_range: float | None = None) -> QuantCalibration:
    """Calibration from a fitted scaler profile (``|mean| + sigma_range·σ``
    per feature, over 127 codes). ``scaler`` is anything with per-feature
    ``mean`` and ``scale`` (tensors or arrays)."""
    if sigma_range is None:
        from fraud_detection_tpu_torch import config

        sigma_range = config.quant_sigma_range()
    mean = _np32(scaler.mean)
    sigma = _np32(scaler.scale)
    absmax = np.abs(mean) + float(sigma_range) * sigma
    # a constant feature must not yield scale 0 (the encoder divides by it)
    scale = np.maximum(absmax, 1e-12) / 127.0
    return QuantCalibration(scale=scale.astype(np.float32), sigma_range=float(sigma_range))


def save_calibration(directory: str, cal: QuantCalibration) -> str:
    """Write ``quant_calibration.npz`` beside the model artifacts."""
    from fraud_detection_tpu_torch.ckpt.atomic import atomic_savez

    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, CALIBRATION_FILE)
    atomic_savez(
        path,
        scale=np.asarray(cal.scale, np.float32),
        sigma_range=np.float64(cal.sigma_range),
    )
    return path


def load_calibration(directory: str) -> QuantCalibration | None:
    """The stamped calibration; None when absent."""
    path = os.path.join(directory, CALIBRATION_FILE)
    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=False) as z:
        return QuantCalibration(
            scale=np.asarray(z["scale"], np.float32),
            sigma_range=float(z["sigma_range"]),
        )
