"""Time ``train()`` as it fits (sharded over the default mesh) against the
same ``train()`` with its fits unsharded, in turns, on one device.

    python -m fraud_detection_tpu_torch.train_turns --device cuda \\
        --family logistic --family gbt --rounds 3
    python -m fraud_detection_tpu_torch.train_turns --device cpu --family gbt --once

Each run is ``train()`` on the committed CSV with its defaults (5 folds,
SMOTE, L-BFGS or the forest recipe), its tracking store and models in a
temporary directory, nothing registered. The ``sharded`` leg runs it as
it is; the ``unsharded`` leg routes its fits through
``logistic_fit_lbfgs(sharded=False)`` and ``gbt_fit(sharded=False)`` on
the rows' device. A round is sharded, unsharded, unsharded, sharded;
``--once`` runs each leg once. One logistic ``train()`` first, untimed,
takes the process's first-call costs out of the turns. The wall is the host clock around the call
(``train()`` synchronises the device at every stage boundary). Prints one
line a run (its wall, test AUC, final stages and each L-BFGS fit's
iterations) and a JSON line with each leg's walls, median and spread, the
L-BFGS iterations, and whether the two legs' models are bitwise equal;
the JSON also goes to ``chiprun_out/train_turns_<device>_<families>[_<tag>]
.json``.

To hold another tree's ``train()`` against this one (a parent commit
unpacked under a git-ignored directory), run this file by its path with
that tree on ``PYTHONPATH``: the package it imports is that tree's, the
committed CSV and ``chiprun_out/`` are this one's::

    PYTHONPATH=build/parent python fraud_detection_tpu_torch/train_turns.py \
        --device cuda --family logistic --once --tag parent
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
LEGS = ("sharded", "unsharded")


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the card, or "no card"."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        )
    except (OSError, subprocess.SubprocessError):
        return "no card"
    return out.stdout.strip().splitlines()[0]


def run_once(family: str, leg: str, device: str, work: Path) -> tuple[float, dict, dict]:
    """One ``train()`` of ``family`` on ``device`` through ``leg``'s fits;
    returns its wall, its metrics and its model file's arrays."""
    import fraud_detection_tpu_torch.train as train_mod

    fits = {"logistic_fit_lbfgs": train_mod.logistic_fit_lbfgs, "gbt_fit": train_mod.gbt_fit}
    if leg == "unsharded":
        for name, fn in fits.items():
            setattr(train_mod, name, lambda *a, _fn=fn, **kw: _fn(
                *a, **{**kw, "mesh": None, "sharded": False}))
    out = work / f"{family}_{leg}_{time.perf_counter_ns()}"
    os.environ["MLFLOW_TRACKING_URI"] = f"file:{out / 'mlruns'}"
    try:
        t0 = time.perf_counter()
        metrics = train_mod.train(
            data_csv=str(ROOT / "data" / "creditcard.csv"), out_dir=str(out / "models"),
            device=device, model_family=family, register=False,
        )
        wall = time.perf_counter() - t0
    finally:
        for name, fn in fits.items():
            setattr(train_mod, name, fn)
    with np.load(out / "models" / "model.npz") as z:
        arrays = {k: z[k].copy() for k in z.files}
    return wall, metrics, arrays


def turns(family: str, device: str, rounds: int, once: bool, work: Path) -> dict:
    order = list(LEGS) if once else [*LEGS, *reversed(LEGS)] * rounds
    walls: dict = {leg: [] for leg in LEGS}
    fits: dict = {leg: [] for leg in LEGS}
    iters: dict = {leg: [] for leg in LEGS}
    models: dict = {}
    for leg in order:
        wall, metrics, arrays = run_once(family, leg, device, work)
        walls[leg].append(wall)
        final = {k: v for k, v in metrics["stages"].items() if k.startswith("final")}
        final["fits"] = sum(v for k, v in metrics["stages"].items() if k.endswith("_fit"))
        fits[leg].append(final)
        iters[leg].append(metrics.get("lbfgs_iters"))
        models.setdefault(leg, arrays)
        print(f"train_turns {device} {family} {leg}: {wall:.3f} s wall, test AUC "
              f"{metrics['test_auc']:.6f}, final stages {final}, L-BFGS iterations "
              f"{metrics.get('lbfgs_iters')}", flush=True)
    a, b = models["sharded"], models["unsharded"]
    bitwise = a.keys() == b.keys() and all(a[k].tobytes() == b[k].tobytes() for k in a)
    return {
        "walls_s": walls,
        "median_s": {leg: float(np.median(w)) for leg, w in walls.items()},
        "spread_s": {leg: [min(w), max(w)] for leg, w in walls.items()},
        "final_fit_stages_s": fits,
        "lbfgs_iters": iters,
        "models_bitwise_equal": bool(bitwise),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--family", action="append", choices=("logistic", "gbt"))
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--once", action="store_true", help="each leg once, not in rounds")
    ap.add_argument("--tag", default="", help="suffix of the JSON file's name")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.WARNING)
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("train_turns: --device cuda needs a CUDA card", file=sys.stderr)
            return 2
    card = card_line()
    print(f"card: {card}", flush=True)
    result = {"device": args.device, "card": card, "families": {}}
    families = args.family or ["logistic"]
    with tempfile.TemporaryDirectory(prefix="train_turns_") as work:
        run_once("logistic", "sharded", args.device, Path(work))  # warm-up
        for family in families:
            result["families"][family] = turns(family, args.device, args.rounds,
                                               args.once, Path(work))
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    tag = f"_{args.tag}" if args.tag else ""
    (out_dir / f"train_turns_{args.device}_{'_'.join(families)}{tag}.json").write_text(
        json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
