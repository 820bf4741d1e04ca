"""Synthetic Kaggle-schema dataset generation, in numpy.

A copy of the JAX package's generator: seeded standard-normal V1..V28,
``Time`` sorted uniform over 48 h, log-normal ``Amount``, Bernoulli fraud
labels at ``fraud_ratio``, and the fraud rows shifted along one fixed
direction in V-space. The same numpy calls in the same order, so the same
seed gives the same rows and the same file bytes in both packages. Chunked,
so a 10M-row file streams to disk without the whole frame in memory.
"""

from __future__ import annotations

import os

import numpy as np

from fraud_detection_tpu_torch import config
from fraud_detection_tpu_torch.data.loader import KAGGLE_FEATURES, LABEL_COLUMN

# The fraud-signal direction is fixed across seeds, so a model trained on
# one synthetic set scores sanely on another (validate_auc scores its own
# set, generated with its own seed).
_SHIFT_SEED = 1729


def fraud_shift(scale: float = 1.5) -> np.ndarray:
    """The direction fraud rows are shifted along in V-space. ``scale`` sets
    the separability: 1.5 (default) is near-perfectly separable; ~0.5 lands
    the AUC near the reference's real-Kaggle 0.971."""
    return np.random.default_rng(_SHIFT_SEED).standard_normal(28).astype(np.float32) * scale


def generate_synthetic_rows(
    n_samples: int,
    fraud_ratio: float = 0.01,
    seed: int = 42,
    shift: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """In-memory generation → (X (n, 30) float32, y (n,) int32)."""
    rng = np.random.default_rng(seed)
    x = np.empty((n_samples, len(KAGGLE_FEATURES)), dtype=np.float32)
    x[:, 0] = np.sort(rng.uniform(0, 172800, n_samples)).astype(np.float32)  # Time, 48 h
    x[:, 1:29] = rng.standard_normal((n_samples, 28), dtype=np.float32)  # V1..V28
    x[:, 29] = rng.lognormal(mean=3.0, sigma=1.0, size=n_samples).astype(np.float32)
    y = (rng.random(n_samples) < fraud_ratio).astype(np.int32)
    if y.sum() < 2:  # SMOTE and the AUC need two positives
        y[:2] = 1
    if shift is None:
        shift = fraud_shift()
    x[:, 1:29] += y[:, None] * shift[None, :]
    return x, y


def generate_synthetic_data(
    output_path: str,
    n_samples: int | None = None,
    fraud_ratio: float = 0.01,
    seed: int = 42,
    chunk_rows: int = 1_000_000,
    shift_scale: float = 1.5,
) -> str:
    """Write a synthetic Kaggle-schema CSV, chunk by chunk (chunk i seeded
    ``seed + i``, its ``Time`` offset by i·48 h so the file stays sorted).
    ``n_samples`` defaults to :func:`config.synthetic_samples`."""
    if n_samples is None:
        n_samples = config.synthetic_samples()
    os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
    header = ",".join(KAGGLE_FEATURES + [LABEL_COLUMN])
    shift = fraud_shift(shift_scale)
    with open(output_path, "w") as f:
        f.write(header + "\n")
        written = 0
        chunk_i = 0
        while written < n_samples:
            n = min(chunk_rows, n_samples - written)
            x, y = generate_synthetic_rows(n, fraud_ratio, seed + chunk_i, shift)
            x[:, 0] += chunk_i * 172800.0
            block = np.concatenate([x, y[:, None].astype(np.float32)], axis=1)
            np.savetxt(f, block, delimiter=",", fmt="%.6g")
            written += n
            chunk_i += 1
    return output_path
