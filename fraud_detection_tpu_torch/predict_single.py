"""Single-prediction client.

The JAX package's ``FraudDetector``: load the production model once
(registry first, then the native directory, then the joblib artifacts:
``service.loading.load_production_model``), take a dict, a list or a pandas
row, reorder it to the training feature order, and return the label or
P(fraud). Each call scores one row: one ``fused_score`` launch at the
smallest bucket for a logistic model on the card.

    python -m fraud_detection_tpu_torch.predict_single [--json '{"Time": ...}']
"""

from __future__ import annotations

import argparse
import json
import logging

from fraud_detection_tpu_torch.service.loading import load_production_model

log = logging.getLogger("fraud_detection_tpu_torch.predict_single")


class FraudDetector:
    """Load-once scoring facade."""

    def __init__(self, model=None, device=None):
        if model is None:
            model, source = load_production_model(device=device)
            log.info("FraudDetector using model from %s", source)
        self.model = model

    def predict(self, features) -> int:
        label, _ = self.model.score_one(self._coerce(features))
        return label

    def predict_proba(self, features) -> float:
        _, proba = self.model.score_one(self._coerce(features))
        return proba

    def _coerce(self, features):
        # a pandas Series or a one-row DataFrame, without needing pandas
        if hasattr(features, "to_dict"):
            d = features.to_dict()
            if d and isinstance(next(iter(d.values())), dict):  # one-row frame
                d = {k: list(v.values())[0] for k, v in d.items()}
            return d
        return features


# a Kaggle-schema row for the demo (synthetic, schema-identical)
_DEMO_ROW = {
    "Time": 406.0, "V1": -2.31, "V2": 1.95, "V3": -1.61, "V4": 4.0,
    "V5": -0.52, "V6": -1.43, "V7": -2.54, "V8": 1.39, "V9": -2.77,
    "V10": -2.77, "V11": 3.2, "V12": -2.9, "V13": -0.6, "V14": -4.29,
    "V15": 0.39, "V16": -1.14, "V17": -2.83, "V18": -0.02, "V19": 0.42,
    "V20": 0.13, "V21": 0.52, "V22": -0.04, "V23": -0.47, "V24": 0.32,
    "V25": 0.04, "V26": 0.18, "V27": 0.26, "V28": -0.14, "Amount": 0.0,
}


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", default=None, help="JSON object of features")
    a = ap.parse_args(argv)
    features = json.loads(a.json) if a.json else _DEMO_ROW
    det = FraudDetector()
    label = det.predict(features)
    proba = det.predict_proba(features)
    print(f"prediction: {label} ({'FRAUD' if label else 'legitimate'}), "
          f"P(fraud) = {proba:.6f}")


if __name__ == "__main__":
    main()
