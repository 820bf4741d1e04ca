"""Offline evaluation: confusion matrix, classification report, AUC-ROC and
the two plots (``confusion_matrix.png``, ``roc_curve.png``).

The JAX package's ``evaluate``: the test split is recomputed from the data
CSV with the training seed; the model is a native artifact of either family,
else the reference's joblib layout. The test rows are scored in one
``predict_proba`` call: one ``fused_score`` launch for a logistic model on
the card, the forest walk for a GBT one. The metrics run on the model's
device.

    python -m fraud_detection_tpu_torch.evaluate [--data CSV] [--model-dir DIR]
        [--plots-dir DIR | --no-plots] [--seed 42]   # DEVICE=cpu: the CPU
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np
import torch

from fraud_detection_tpu_torch import config
from fraud_detection_tpu_torch.data.loader import load_creditcard_csv, stratified_split
from fraud_detection_tpu_torch.models import FraudLogisticModel, load_any_model
from fraud_detection_tpu_torch.ops.metrics import (
    auc_roc,
    binary_classification_report,
    confusion_matrix,
    roc_curve_points,
)
from fraud_detection_tpu_torch.plots import pyplot

log = logging.getLogger("fraud_detection_tpu_torch.evaluate")


def load_model(model_dir: str, device=None):
    """Either family's native artifacts (``model.npz``), else the
    reference's joblib layout (logistic only)."""
    if os.path.exists(os.path.join(model_dir, "model.npz")):
        return load_any_model(model_dir, device=device)
    return FraudLogisticModel.load_joblib(
        os.path.join(model_dir, "logistic_model.joblib"),
        os.path.join(model_dir, "scaler.joblib"),
        os.path.join(model_dir, "feature_names.json"),
        device=device,
    )


def evaluate(
    data_csv: str | None = None,
    model_dir: str = "models",
    plots_dir: str | None = "plots",
    seed: int = 42,
    threshold: float = 0.5,
    device: str | torch.device | None = None,
) -> dict:
    """Prints the report and returns ``{"auc", "confusion_matrix",
    "report", "scores"}`` (``scores``: the test rows' P(fraud)).
    ``plots_dir=None`` writes no plot."""
    plt = pyplot("evaluate") if plots_dir is not None else None
    data_csv = data_csv or config.data_csv()
    x, y, _ = load_creditcard_csv(data_csv)
    _, test_idx = stratified_split(y, 0.2, seed)
    x_test, y_test = x[test_idx], y[test_idx]

    model = load_model(model_dir, device=device)
    scores = model.scorer.predict_proba(x_test)
    dev = model.device
    s = torch.as_tensor(scores, device=dev)
    labels = torch.as_tensor(y_test, device=dev)
    pred = s >= threshold

    cm = confusion_matrix(labels, pred).cpu().numpy().astype(int)
    report = binary_classification_report(labels, pred)
    auc = float(auc_roc(s, labels))

    print("Confusion matrix [[tn fp] [fn tp]]:")
    print(cm)
    print("\nClassification report:")
    for cls in ("0", "1"):
        r = report[cls]
        print(
            f"  class {cls}: precision {r['precision']:.3f} recall {r['recall']:.3f} "
            f"f1 {r['f1-score']:.3f} support {int(r['support'])}"
        )
    print(f"  accuracy {report['accuracy']:.4f}")
    print(f"\nAUC-ROC: {auc:.4f}")

    if plt is not None:
        os.makedirs(plots_dir, exist_ok=True)
        fpr, tpr, _ = roc_curve_points(s, labels, num_thresholds=400)
        _render_plots(plt, cm, fpr.cpu().numpy(), tpr.cpu().numpy(), auc, plots_dir)
    return {"auc": auc, "confusion_matrix": cm.tolist(), "report": report,
            "scores": scores}


def _render_plots(plt, cm, fpr, tpr, auc: float, plots_dir: str) -> None:
    fig, ax = plt.subplots(figsize=(5, 4))
    im = ax.imshow(cm, cmap="Blues")
    for (i, j), v in np.ndenumerate(cm):
        ax.text(j, i, f"{v:,}", ha="center", va="center",
                color="white" if v > cm.max() / 2 else "black")
    ax.set_xlabel("Predicted")
    ax.set_ylabel("Actual")
    ax.set_xticks([0, 1])
    ax.set_yticks([0, 1])
    ax.set_title("Confusion Matrix")
    fig.colorbar(im)
    fig.tight_layout()
    fig.savefig(os.path.join(plots_dir, "confusion_matrix.png"), dpi=120)
    plt.close(fig)

    fig, ax = plt.subplots(figsize=(5, 4))
    ax.plot(fpr, tpr, label=f"ROC (AUC = {auc:.4f})")
    ax.plot([0, 1], [0, 1], "k--", lw=0.8)
    ax.set_xlabel("False positive rate")
    ax.set_ylabel("True positive rate")
    ax.set_title("ROC curve")
    ax.legend(loc="lower right")
    fig.tight_layout()
    fig.savefig(os.path.join(plots_dir, "roc_curve.png"), dpi=120)
    plt.close(fig)
    log.info("plots written to %s/", plots_dir)


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data", default=None)
    ap.add_argument("--model-dir", default="models")
    ap.add_argument("--plots-dir", default="plots")
    ap.add_argument("--no-plots", action="store_true", help="write no plot (no matplotlib)")
    ap.add_argument("--seed", type=int, default=42)
    a = ap.parse_args(argv)
    evaluate(a.data, a.model_dir, None if a.no_plots else a.plots_dir, a.seed)


if __name__ == "__main__":
    main()
