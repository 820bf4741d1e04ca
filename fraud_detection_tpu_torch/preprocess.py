"""Standalone preprocessing pipeline (the reference's legacy linear path).

Writes ``data/preprocessed_data.npz`` (``X_res``, ``y_res``, ``X_test``,
``y_test``) and the scaler and feature-name artifacts, as the JAX package's
``preprocess`` does: the scaler fitted on the training split only, SMOTE on
the scaled training rows. On the card SMOTE's k-NN is one ``knn_topk``
launch; the scaler's sums run in a fixed order, so ``X_test`` is the same
bits on the card and on the CPU.

    python -m fraud_detection_tpu_torch.preprocess [--data CSV] [--out NPZ]
        [--models-dir DIR] [--seed 42]      # DEVICE=cpu runs on the CPU
"""

from __future__ import annotations

import argparse
import json
import logging
import os

import torch

from fraud_detection_tpu_torch import config
from fraud_detection_tpu_torch.ckpt.atomic import atomic_savez
from fraud_detection_tpu_torch.ckpt.checkpoint import export_scaler_artifacts
from fraud_detection_tpu_torch.data.loader import load_creditcard_csv, stratified_split
from fraud_detection_tpu_torch.device import resolve_device
from fraud_detection_tpu_torch.ops.scaler import scaler_fit, scaler_transform
from fraud_detection_tpu_torch.ops.smote import smote

log = logging.getLogger("fraud_detection_tpu_torch.preprocess")


def preprocess(
    data_csv: str | None = None,
    out_npz: str = "data/preprocessed_data.npz",
    models_dir: str = "models",
    seed: int = 42,
    device: str | torch.device | None = None,
) -> dict:
    dev = resolve_device(device)
    data_csv = data_csv or config.data_csv()
    x, y, feature_names = load_creditcard_csv(data_csv)
    train_idx, test_idx = stratified_split(y, 0.2, seed)

    x_train = torch.as_tensor(x[train_idx], device=dev)
    scaler = scaler_fit(x_train)
    xs_train = scaler_transform(scaler, x_train)
    xs_test = scaler_transform(scaler, torch.as_tensor(x[test_idx], device=dev))

    x_res, y_res = smote(xs_train, y[train_idx], seed)

    os.makedirs(os.path.dirname(out_npz) or ".", exist_ok=True)
    atomic_savez(
        out_npz,
        X_res=x_res.cpu().numpy(),
        y_res=y_res,
        X_test=xs_test.cpu().numpy(),
        y_test=y[test_idx],
    )

    # the scaler and feature-name artifacts (the reference's layout)
    os.makedirs(models_dir, exist_ok=True)
    try:
        export_scaler_artifacts(models_dir, scaler, feature_names)
    except RuntimeError:  # joblib absent: the feature list still lands
        with open(os.path.join(models_dir, "feature_names.json"), "w") as f:
            json.dump(feature_names, f)

    log.info(
        "preprocessed: resampled %d rows (from %d), test %d rows → %s",
        len(y_res), len(train_idx), len(test_idx), out_npz,
    )
    return {"n_resampled": int(len(y_res)), "n_test": int(len(test_idx)), "out": out_npz}


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data", default=None)
    ap.add_argument("--out", default="data/preprocessed_data.npz")
    ap.add_argument("--models-dir", default="models")
    ap.add_argument("--seed", type=int, default=42)
    a = ap.parse_args(argv)
    print(preprocess(a.data, a.out, a.models_dir, a.seed))


if __name__ == "__main__":
    main()
