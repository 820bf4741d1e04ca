"""Dataset loading and index-level split utilities.

The on-disk contract is the Kaggle credit-card schema (``Time, V1..V28,
Amount, Class``); column order follows the file header and ``Class`` is the
label. Parsing goes through the port's native C++ reader
(``data/native.py``); ``NATIVE_CSV=0``, or a file the reader rejects, takes
the plain version: the standard library's ``csv`` module for the header
and ``np.loadtxt`` for the body (no pandas).

The split and fold index generators are copies of the JAX package's: the
same numpy RNG calls in the same order, so the same seed gives the same
indices in both packages.
"""

from __future__ import annotations

import csv

import numpy as np

from fraud_detection_tpu_torch import config

KAGGLE_FEATURES: list[str] = ["Time"] + [f"V{i}" for i in range(1, 29)] + ["Amount"]
LABEL_COLUMN = "Class"


def load_creditcard_csv(path: str) -> tuple[np.ndarray, np.ndarray, list[str]]:
    """Load a Kaggle-schema CSV → (X float32 (n, d), y int32 (n,), names).

    The native reader parses each value to float32 as the JAX package's
    reader does; the plain version parses to float64 and rounds once to
    float32 (the two agree within 1 ulp)."""
    if config.native_csv():
        from fraud_detection_tpu_torch.data.native import load_csv_native

        native = load_csv_native(path)
        if native is not None:
            mat, names = native
            if LABEL_COLUMN not in names:
                raise ValueError(f"{path} has no '{LABEL_COLUMN}' column")
            li = names.index(LABEL_COLUMN)
            feature_names = [c for c in names if c != LABEL_COLUMN]
            y = mat[:, li].astype(np.int32)
            x = np.ascontiguousarray(np.delete(mat, li, axis=1))
            return x, y, feature_names
    with open(path, newline="") as f:
        names = [c.strip() for c in next(csv.reader(f))]
    if LABEL_COLUMN not in names:
        raise ValueError(f"{path} has no '{LABEL_COLUMN}' column")
    mat = np.loadtxt(
        path, delimiter=",", skiprows=1, dtype=np.float64, ndmin=2
    )
    if mat.shape[1] != len(names):
        raise ValueError(
            f"{path}: {mat.shape[1]} values per row, {len(names)} columns"
        )
    li = names.index(LABEL_COLUMN)
    feature_names = [c for c in names if c != LABEL_COLUMN]
    y = mat[:, li].astype(np.int32)
    x = np.ascontiguousarray(np.delete(mat, li, axis=1), dtype=np.float32)
    return x, y, feature_names


def stratified_split(
    y: np.ndarray, test_size: float = 0.2, seed: int = 42
) -> tuple[np.ndarray, np.ndarray]:
    """Per-class shuffled index split (sklearn ``train_test_split(stratify=y)``
    semantics). Returns (train_idx, test_idx)."""
    rng = np.random.default_rng(seed)
    train_parts, test_parts = [], []
    for cls in np.unique(y):
        idx = np.where(y == cls)[0]
        rng.shuffle(idx)
        n_test = int(round(len(idx) * test_size))
        test_parts.append(idx[:n_test])
        train_parts.append(idx[n_test:])
    train_idx = np.concatenate(train_parts)
    test_idx = np.concatenate(test_parts)
    rng.shuffle(train_idx)
    rng.shuffle(test_idx)
    return train_idx, test_idx


def stratified_kfold_indices(
    y: np.ndarray, n_splits: int = 5, seed: int = 42, shuffle: bool = True
):
    """Yield (train_idx, val_idx) preserving class ratios per fold (sklearn
    ``StratifiedKFold`` semantics)."""
    rng = np.random.default_rng(seed)
    per_class = {}
    for cls in np.unique(y):
        idx = np.where(y == cls)[0]
        if shuffle:
            rng.shuffle(idx)
        per_class[cls] = np.array_split(idx, n_splits)
    for fold in range(n_splits):
        val = np.concatenate([per_class[c][fold] for c in per_class])
        train = np.concatenate(
            [per_class[c][f] for c in per_class for f in range(n_splits) if f != fold]
        )
        yield np.sort(train), np.sort(val)
