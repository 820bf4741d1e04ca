"""Gradient-boosted-trees fraud model: a fitted
:class:`~fraud_detection_tpu_torch.ops.gbt.GBTModel` forest and the frozen
feature order behind :class:`~fraud_detection_tpu_torch.ops.scorer.
GBTBatchScorer`, on the estimator surface the logistic model shares.

The scaler folds into the bin edges at construction, so the model scores
*raw* rows. Because the fold consumes the scaler, the int8 wire's
calibration is derived here, before the fold, and :meth:`save` stamps
``quant_calibration.npz`` beside the forest, as the JAX package does. The
scorer is built on the h2d wire ``SCORER_WIRE`` names unless the caller
pins one.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from fraud_detection_tpu_torch.ckpt.checkpoint import load_gbt_artifacts, save_gbt_artifacts
from fraud_detection_tpu_torch.device import resolve_device
from fraud_detection_tpu_torch.models.base import FraudModelBase
from fraud_detection_tpu_torch.ops.gbt import GBTModel, fold_scaler_into_gbt
from fraud_detection_tpu_torch.ops.quant import (
    QuantCalibration,
    derive_calibration,
    load_calibration,
    save_calibration,
)
from fraud_detection_tpu_torch.ops.scorer import GBTBatchScorer

log = logging.getLogger("fraud_detection_tpu_torch.models")

class FraudGBTModel(FraudModelBase):
    #: serve-time vs backfill attribution tolerance of the JAX package's
    #: worker consistency check (margin-space TreeSHAP; on the f32 wire the
    #: two paths share one body and agree bitwise)
    explain_consistency_atol = 0.25

    def __init__(
        self,
        model: GBTModel,
        feature_names: list[str],
        scaler=None,
        background: np.ndarray | None = None,
        calibration: QuantCalibration | None = None,
        io_dtype: str | None = None,
        device: str | torch.device | None = None,
    ):
        self.device = resolve_device(device)
        model = model.to(self.device)
        if scaler is not None:
            # the int8 calibration comes from the scaler BEFORE the fold
            # consumes it (serve-time loads read the stamped sidecar)
            if calibration is None:
                calibration = derive_calibration(scaler)
            model = fold_scaler_into_gbt(model, scaler)
        self.model = model
        self.feature_names = list(feature_names)
        if len(self.feature_names) != int(model.bin_edges.shape[0]):
            raise ValueError(
                f"{len(self.feature_names)} feature names for a forest over "
                f"{int(model.bin_edges.shape[0])} features"
            )
        self.background = background  # raw-space sample for TreeSHAP
        self.calibration = calibration
        self._raw_explainer = None
        # the wire: SCORER_WIRE unless pinned. int8 needs the stamped
        # calibration; without one it serves f32, loudly
        if io_dtype is None:
            from fraud_detection_tpu_torch import config

            io_dtype = config.scorer_wire()
        if io_dtype == "int8" and calibration is None:
            log.warning(
                "SCORER_WIRE=int8 but the GBT model carries no stamped "
                "quant_calibration.npz (and its scaler is folded into the "
                "bin edges) — serving on the float32 wire instead"
            )
            io_dtype = "float32"
        # the fused explain leg resolves the cached explainer on the first
        # fused_spec() (warm-up), never at load
        self._scorer = GBTBatchScorer(
            model, io_dtype=io_dtype,
            calibration=calibration if io_dtype == "int8" else None,
            explainer=self.raw_explainer,
        )

    def raw_explainer(self):
        """Exact interventional TreeSHAP over the forest, taking raw rows:
        background the stored training sample, or one all-zeros row when
        absent; the subsample seed from ``EXPLAIN_BG_SEED``. Built once and
        cached; the same explainer (and its kernel tables) rides the fused
        flush's explain leg."""
        if self._raw_explainer is None:
            from fraud_detection_tpu_torch import config
            from fraud_detection_tpu_torch.ops.tree_shap import build_tree_explainer

            bg = self.background
            if bg is None:
                bg = np.zeros((1, len(self.feature_names)), np.float32)
            self._raw_explainer = build_tree_explainer(
                self.model, bg, seed=config.explain_background_seed()
            )
        return self._raw_explainer

    def explain_batch(self, x: np.ndarray) -> tuple[np.ndarray, float]:
        from fraud_detection_tpu_torch.ops.tree_shap import tree_shap

        explainer = self.raw_explainer()
        xt = torch.as_tensor(np.asarray(x, np.float32), device=self.device)
        phi = tree_shap(explainer, xt).cpu().numpy()
        return phi, float(explainer.expected_value)

    def save(self, directory: str) -> str:
        out = save_gbt_artifacts(directory, self.model, self.feature_names, self.background)
        if self.calibration is not None:
            save_calibration(directory, self.calibration)
        return out

    @classmethod
    def load(cls, directory: str, device: str | torch.device | None = None) -> "FraudGBTModel":
        model, feature_names, background = load_gbt_artifacts(directory)
        return cls(
            model, feature_names, background=background,
            calibration=load_calibration(directory), device=device,
        )
