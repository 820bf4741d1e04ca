"""Offline SHAP explainability: the top features by mean |SHAP| over the
test split, a summary plot and dependence plots for the top three.

The JAX package's ``explain``: exact interventional SHAP over up to
``max_rows`` test rows in one ``explain_batch`` call, the closed form for
the logistic family and TreeSHAP for the GBT family (one ``tree_shap``
launch on the card).

    python -m fraud_detection_tpu_torch.explain [--data CSV] [--model-dir DIR]
        [--plots-dir DIR | --no-plots] [--seed 42]
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np
import torch

from fraud_detection_tpu_torch import config
from fraud_detection_tpu_torch.data.loader import load_creditcard_csv, stratified_split
from fraud_detection_tpu_torch.evaluate import load_model
from fraud_detection_tpu_torch.plots import pyplot

log = logging.getLogger("fraud_detection_tpu_torch.explain")


def explain(
    data_csv: str | None = None,
    model_dir: str = "models",
    plots_dir: str | None = "plots",
    seed: int = 42,
    max_rows: int = 20000,
    device: str | torch.device | None = None,
) -> dict:
    """Prints the top 10 and returns ``{"mean_abs_shap", "n_rows", "phi",
    "expected_value"}`` (``phi``: the (n, d) margin-space attributions).
    ``plots_dir=None`` writes no plot."""
    plt = pyplot("explain") if plots_dir is not None else None
    data_csv = data_csv or config.data_csv()
    x, y, _ = load_creditcard_csv(data_csv)
    _, test_idx = stratified_split(y, 0.2, seed)
    x_test = x[test_idx][:max_rows]

    model = load_model(model_dir, device=device)
    phi, expected_value = model.explain_batch(x_test)

    mean_abs = np.abs(phi).mean(axis=0)
    order = np.argsort(mean_abs)[::-1]
    top = [(model.feature_names[i], float(mean_abs[i])) for i in order[:10]]
    print("Top features by mean |SHAP|:")
    for name, v in top:
        print(f"  {name:8s} {v:.4f}")

    if plt is not None:
        os.makedirs(plots_dir, exist_ok=True)
        _render(plt, phi, x_test, model.feature_names, order, plots_dir)
    return {"mean_abs_shap": dict(top), "n_rows": int(len(x_test)), "phi": phi,
            "expected_value": expected_value}


def _render(plt, phi, x_test, names, order, plots_dir: str) -> None:
    # summary: per-feature SHAP distributions of the top 15, violins
    top15 = order[:15][::-1]
    fig, ax = plt.subplots(figsize=(7, 6))
    sample = phi[:2000, :]
    parts = ax.violinplot(
        [sample[:, i] for i in top15], orientation="horizontal", showextrema=False
    )
    for pc in parts["bodies"]:
        pc.set_alpha(0.6)
    ax.set_yticks(range(1, len(top15) + 1))
    ax.set_yticklabels([names[i] for i in top15])
    ax.set_xlabel("SHAP value (margin space)")
    ax.set_title("SHAP summary")
    fig.tight_layout()
    fig.savefig(os.path.join(plots_dir, "shap_summary.png"), dpi=120)
    plt.close(fig)

    for rank, i in enumerate(order[:3]):
        fig, ax = plt.subplots(figsize=(5, 4))
        ax.scatter(x_test[:2000, i], phi[:2000, i], s=4, alpha=0.4)
        ax.set_xlabel(names[i])
        ax.set_ylabel(f"SHAP({names[i]})")
        ax.set_title(f"Dependence: {names[i]}")
        fig.tight_layout()
        fig.savefig(os.path.join(plots_dir, f"shap_dependence_{rank}_{names[i]}.png"),
                    dpi=120)
        plt.close(fig)
    log.info("SHAP plots written to %s/", plots_dir)


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data", default=None)
    ap.add_argument("--model-dir", default="models")
    ap.add_argument("--plots-dir", default="plots")
    ap.add_argument("--no-plots", action="store_true", help="write no plot (no matplotlib)")
    ap.add_argument("--seed", type=int, default=42)
    a = ap.parse_args(argv)
    explain(a.data, a.model_dir, None if a.no_plots else a.plots_dir, a.seed)


if __name__ == "__main__":
    main()
