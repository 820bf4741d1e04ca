"""Flagship model: scaled logistic regression for fraud scoring.

Bundles :class:`LogisticParams` + :class:`ScalerParams` + the frozen
feature order behind the scaler-folded :class:`BatchScorer`, built on the
h2d wire ``SCORER_WIRE`` names unless the caller pins one.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from fraud_detection_tpu_torch.ckpt.checkpoint import (
    export_joblib_artifacts,
    import_joblib_artifacts,
    load_artifacts,
    save_artifacts,
)
from fraud_detection_tpu_torch.models.base import FraudModelBase
from fraud_detection_tpu_torch.ops.linear_shap import (
    LinearShapExplainer,
    linear_shap,
    make_explainer,
)
from fraud_detection_tpu_torch.ops.logistic import LogisticParams
from fraud_detection_tpu_torch.ops.quant import (
    QuantCalibration,
    derive_calibration,
    load_calibration,
    save_calibration,
)
from fraud_detection_tpu_torch.ops.scaler import ScalerParams
from fraud_detection_tpu_torch.ops.scorer import BatchScorer, fold_scaler_into_linear

log = logging.getLogger("fraud_detection_tpu_torch.models")


class FraudLogisticModel(FraudModelBase):
    def __init__(
        self,
        params: LogisticParams,
        scaler: ScalerParams | None,
        feature_names: list[str],
        calibration: QuantCalibration | None = None,
        io_dtype: str | None = None,
        device: str | torch.device | None = None,
    ):
        # the wire: SCORER_WIRE unless pinned. int8 takes the stamped
        # calibration (load() passes it), else one derived from the scaler;
        # with neither it serves f32, loudly, rather than refuse to serve
        if io_dtype is None:
            from fraud_detection_tpu_torch import config

            io_dtype = config.scorer_wire()
        if io_dtype == "int8" and scaler is None and calibration is None:
            log.warning(
                "SCORER_WIRE=int8 but the model carries no scaler stats and "
                "no stamped quant_calibration.npz — serving on the float32 "
                "wire instead"
            )
            io_dtype = "float32"
        self.calibration = calibration
        self._scorer = BatchScorer(params, scaler, io_dtype=io_dtype,
                                   calibration=calibration, device=device)
        self.device = self._scorer.device
        self.params = params.to(self.device)
        self.scaler = scaler.to(self.device) if scaler is not None else None
        self.feature_names = list(feature_names)
        if len(self.feature_names) != self._scorer.n_features:
            raise ValueError(
                f"{len(self.feature_names)} feature names for "
                f"{self._scorer.n_features} coefficients"
            )
        self._raw_explainer = None

    def raw_explainer(self) -> LinearShapExplainer:
        """SHAP explainer taking *raw* inputs: scaler folded into the coef,
        background mean = scaler mean. Built once and cached."""
        if self._raw_explainer is None:
            folded = fold_scaler_into_linear(self.params, self.scaler)
            mu = (
                self.scaler.mean if self.scaler is not None
                else torch.zeros_like(folded.coef)
            )
            self._raw_explainer = make_explainer(
                folded.coef, folded.intercept, background_mean=mu
            )
        return self._raw_explainer

    def explain_batch(self, x: np.ndarray) -> tuple[np.ndarray, float]:
        explainer = self.raw_explainer()
        xt = torch.as_tensor(np.asarray(x, np.float32), device=self.device)
        phi = linear_shap(explainer, xt).cpu().numpy()
        return phi, float(explainer.expected_value)

    def save(self, directory: str, joblib_too: bool = True) -> str:
        """``model.npz`` + ``feature_names.json`` and, with a scaler, the
        int8 wire's ``quant_calibration.npz`` derived from it, so that the
        model serves that wire on its own training profile. With
        ``joblib_too``, also the reference's joblib layout where joblib and
        sklearn are installed (the native files alone where not)."""
        save_artifacts(directory, self.params, self.scaler, self.feature_names)
        if self.scaler is not None:
            save_calibration(directory, derive_calibration(self.scaler))
        if joblib_too:
            try:
                export_joblib_artifacts(
                    directory, self.params, self.scaler, self.feature_names
                )
            except RuntimeError:
                pass  # joblib/sklearn not installed: the native format only
        return directory

    @classmethod
    def load(
        cls, directory: str, device: str | torch.device | None = None
    ) -> "FraudLogisticModel":
        params, scaler, feature_names = load_artifacts(directory)
        return cls(params, scaler, feature_names,
                   calibration=load_calibration(directory), device=device)

    @classmethod
    def load_joblib(
        cls,
        model_path: str,
        scaler_path: str | None,
        feature_names_path: str | None,
        device: str | torch.device | None = None,
    ) -> "FraudLogisticModel":
        """A model from the reference's joblib artifacts; without a feature
        list the features are named ``f0``, ``f1``, ..."""
        params, scaler, names = import_joblib_artifacts(
            model_path, scaler_path, feature_names_path
        )
        if names is None:
            names = [f"f{i}" for i in range(params.coef.shape[0])]
        return cls(params, scaler, names, device=device)
