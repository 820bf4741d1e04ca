"""Data sanity and EDA: the shape and class counts, the class-imbalance and
amount-histogram plots, and ``data/processed_data.csv``, the data with
``Amount`` and ``Time`` replaced by their standardised columns.

The JAX package's ``eda``, with the CSV written by the standard ``csv``
module (no pandas): the same header (V1..V28, ``scaled_amount``,
``scaled_time``, ``Class``), values that parse back to the float32 values
(not byte for byte pandas' text). The two scalers fit on the chosen device.

    python -m fraud_detection_tpu_torch.eda [--data CSV]
        [--plots-dir DIR | --no-plots] [--no-csv]
"""

from __future__ import annotations

import argparse
import csv
import os

import numpy as np
import torch

from fraud_detection_tpu_torch import config
from fraud_detection_tpu_torch.data.loader import LABEL_COLUMN, load_creditcard_csv
from fraud_detection_tpu_torch.device import resolve_device
from fraud_detection_tpu_torch.ops.scaler import scaler_fit, scaler_transform
from fraud_detection_tpu_torch.plots import pyplot


def eda(
    data_csv: str | None = None,
    plots_dir: str | None = "plots",
    out_csv: str | None = "data/processed_data.csv",
    device: str | torch.device | None = None,
) -> dict:
    """Prints the shape and class counts; returns ``{"n_rows",
    "n_fraud"}``. ``plots_dir=None`` writes no plot, ``out_csv=None`` no
    CSV."""
    plt = pyplot("eda") if plots_dir is not None else None
    dev = resolve_device(device)
    data_csv = data_csv or config.data_csv()
    x, y, names = load_creditcard_csv(data_csv)
    n_fraud = int(y.sum())
    print(f"shape: {x.shape}; classes: legit {len(y) - n_fraud:,} / fraud {n_fraud:,} "
          f"({100 * y.mean():.3f}%)")
    print(f"features: {names[:3]} ... {names[-2:]}")

    if plt is not None:
        _render(plt, x, y, names, n_fraud, plots_dir)

    if out_csv:
        columns = dict(zip(names, x.T))
        for col in ("Amount", "Time"):
            if col in columns:
                v = torch.as_tensor(columns.pop(col)[:, None], device=dev)
                columns[f"scaled_{col.lower()}"] = (
                    scaler_transform(scaler_fit(v), v)[:, 0].cpu().numpy()
                )
        header = list(columns) + [LABEL_COLUMN]
        # numpy's shortest round-trip text of each float32 value
        text = np.stack([c.astype(np.float32).astype(str) for c in columns.values()]
                        + [y.astype(str)], axis=1)
        os.makedirs(os.path.dirname(out_csv) or ".", exist_ok=True)
        with open(out_csv, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(header)
            w.writerows(text.tolist())
        print(f"wrote {out_csv}")
    return {"n_rows": len(y), "n_fraud": n_fraud}


def _render(plt, x, y, names, n_fraud: int, plots_dir: str) -> None:
    os.makedirs(plots_dir, exist_ok=True)
    fig, ax = plt.subplots(figsize=(4, 4))
    ax.bar(["legit", "fraud"], [len(y) - n_fraud, n_fraud])
    ax.set_yscale("log")
    ax.set_title("Class distribution")
    fig.tight_layout()
    fig.savefig(os.path.join(plots_dir, "class_distribution.png"), dpi=120)
    plt.close(fig)

    amount = x[:, names.index("Amount")] if "Amount" in names else x[:, -1]
    fig, ax = plt.subplots(figsize=(5, 4))
    ax.hist(amount, bins=80)
    ax.set_yscale("log")
    ax.set_xlabel("Amount")
    ax.set_title("Transaction amounts")
    fig.tight_layout()
    fig.savefig(os.path.join(plots_dir, "amount_histogram.png"), dpi=120)
    plt.close(fig)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data", default=None)
    ap.add_argument("--plots-dir", default="plots")
    ap.add_argument("--no-plots", action="store_true", help="write no plot (no matplotlib)")
    ap.add_argument("--no-csv", action="store_true")
    a = ap.parse_args(argv)
    eda(a.data, None if a.no_plots else a.plots_dir,
        None if a.no_csv else "data/processed_data.csv")


if __name__ == "__main__":
    main()
