"""Offline training of the logistic flagship or the GBT family on one
device.

    python -m fraud_detection_tpu_torch.train --data data/creditcard.csv \\
        [--model logistic|gbt --folds 5 --seed 42 --solver auto|lbfgs|sgd \\
         --no-smote --no-register --ledger --out-dir DIR --checkpoint-dir DIR]

The JAX package's ``train.py`` for ``model_family="logistic"`` and
``"gbt"``, on the card unless ``DEVICE=cpu`` (or ``device="cpu"``) is
given:

1. load the CSV and split it 80/20, stratified; with ``--ledger`` (or
   ``LEDGER_ENABLED=1``; the logistic family only, a forest warns and goes
   on without it) replay every row through the ledger body on the device
   (``ledger.materialize_features``: seeded pseudo-entities, timestamps
   from the ``Time`` column) and widen the rows with the K velocity
   features;
2. fit the scaler on the train split;
3. k-fold CV with SMOTE inside each fold (no leakage), one AUC per fold;
4. fit once more on the SMOTE'd full train split (L-BFGS, or SGD above
   ``SGD_ROW_THRESHOLD`` rows or with ``--solver sgd``; ``--checkpoint-dir``
   makes the SGD fit resumable per epoch). The GBT family fits the
   XGBoost recipe (``GBTConfig``: 100 trees, depth 5, 256 bins, lr 0.1)
   through the ``gbt_hist`` kernel, with ``scale_pos_weight`` = n_neg/n_pos
   only without SMOTE (the two are alternative imbalance corrections);
5. the test AUC;
6. the drift baseline in raw feature space from the test scores;
7. ``model.npz`` + ``feature_names.json`` + ``quant_calibration.npz`` +
   ``monitor_profile.npz`` (+ ``ledger_state.npz``: the spec, whose null
   features are the training rows' mean velocity features and whose clock
   origin continues the replay's, and the replay's final table) into
   ``--out-dir`` and the run's artifact dir
   (a forest stores the scaler folded into its bin edges and a 128-row
   raw-space TreeSHAP background);
8. the AUC gate: register the run's artifact under alias ``prod`` when the
   test AUC reaches ``MLFLOW_AUC_THRESHOLD``;
9. return the metrics.

The wide family and the device trace of ``--profile-dir`` are later
slices: asking for them raises, naming the ROADMAP item that ports them. Besides the JAX package's metrics, the
returned dict holds ``stages`` (seconds per stage, the device synchronised
at each boundary) and ``lbfgs_iters`` (iterations of each L-BFGS fit).
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import time

import numpy as np
import torch

from fraud_detection_tpu_torch import config
from fraud_detection_tpu_torch.ckpt.train_state import SGDCheckpointer
from fraud_detection_tpu_torch.data.loader import (
    load_creditcard_csv,
    stratified_kfold_indices,
    stratified_split,
)
from fraud_detection_tpu_torch.device import resolve_device
from fraud_detection_tpu_torch.ledger import (
    LEDGER_FEATURE_NAMES,
    LedgerSpec,
    materialize_features,
    synthesize_entities,
)
from fraud_detection_tpu_torch.models.gbt import FraudGBTModel
from fraud_detection_tpu_torch.models.logistic import FraudLogisticModel
from fraud_detection_tpu_torch.monitor.baseline import build_baseline_profile, save_profile
from fraud_detection_tpu_torch.ops.gbt import GBTConfig, gbt_fit, gbt_predict_proba
from fraud_detection_tpu_torch.ops.logistic import (
    logistic_fit_lbfgs,
    logistic_fit_sgd,
    predict_proba,
)
from fraud_detection_tpu_torch.ops.metrics import auc_roc
from fraud_detection_tpu_torch.ops.scaler import scaler_fit, scaler_transform
from fraud_detection_tpu_torch.ops.smote import smote
from fraud_detection_tpu_torch.tracking import TrackingClient

log = logging.getLogger("fraud_detection_tpu_torch.train")

# Row count above which the full-batch L-BFGS path gives way to minibatch
# SGD (the line search makes several full-data passes per iteration).
SGD_ROW_THRESHOLD = 2_000_000

#: families and options of the JAX trainer that later slices port
_UNPORTED = {
    "wide": "the wide family (ROADMAP queue 1, item 10)",
    "profile_dir": "the device trace of a training run (ROADMAP queue 1, item 13)",
}


class _Stages:
    """Wall seconds per stage by the host clock, the device synchronised at
    every boundary so that each stage's device work is inside its own time."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.seconds: dict[str, float] = {}
        self._t = time.perf_counter()

    def mark(self, name: str) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        now = time.perf_counter()
        self.seconds[name] = self.seconds.get(name, 0.0) + now - self._t
        self._t = now


def _fit(x, y, *, seed: int, solver: str, class_weight, checkpointer=None,
         iters: list | None = None):
    if solver == "sgd" or (solver == "auto" and x.shape[0] > SGD_ROW_THRESHOLD):
        return logistic_fit_sgd(
            x, y, epochs=8, batch_size=65536, lr=1.0, seed=seed,
            class_weight=class_weight,
            epoch_callback=checkpointer.epoch_callback if checkpointer else None,
            resume=checkpointer.latest() if checkpointer else None,
        )
    # L-BFGS is one solve with nothing to resume; a checkpoint directory
    # applies to the SGD path only
    info: dict = {}
    params = logistic_fit_lbfgs(
        x, y, max_iter=200, class_weight=class_weight, info=info
    )
    if iters is not None:
        iters.append(info["n_iter"])
    return params


def _scale_pos_weight(y) -> float:
    """n_negative / n_positive — the reference's imbalance knob for the
    XGBoost path, computed before SMOTE."""
    n_pos = max(int((np.asarray(y) > 0).sum()), 1)
    return float((len(y) - n_pos) / n_pos)


def _fit_gbt(x, y, *, gbt_config: GBTConfig | None, spw: float):
    cfg = gbt_config or GBTConfig()
    if cfg.scale_pos_weight == 1.0 and spw != 1.0:
        cfg = dataclasses.replace(cfg, scale_pos_weight=spw)
    # The JAX trainer fits sharded over its mesh (gbt_fit(sharded=True),
    # XLA histograms + psum); the port has one device, so this is the
    # unsharded fit through the gbt_hist kernel. The sharded fit, with its
    # histogram allreduce over this kernel's output, is ROADMAP queue 1,
    # item 12.
    return gbt_fit(x, y, cfg), cfg


def _rows(t: torch.Tensor, idx: np.ndarray) -> torch.Tensor:
    return t[torch.as_tensor(idx, device=t.device)]


def train(
    data_csv: str | None = None,
    n_folds: int = 5,
    seed: int = 42,
    solver: str = "auto",
    use_smote: bool = True,
    class_weight=None,
    register: bool = True,
    out_dir: str = "models",
    model_family: str = "logistic",
    gbt_config: GBTConfig | None = None,
    checkpoint_dir: str | None = None,
    device: str | torch.device | None = None,
    ledger: bool | None = None,
) -> dict:
    """Run the pipeline; returns a metrics dict. ``ledger`` None reads
    ``LEDGER_ENABLED``."""
    if model_family not in ("logistic", "gbt"):
        raise ValueError(f"model family must be logistic|gbt, got {model_family!r}")
    if config.env_flag("WIDE_ENABLED"):
        raise NotImplementedError(f"WIDE_ENABLED: {_UNPORTED['wide']} is not ported yet")
    use_ledger = ledger if ledger is not None else config.ledger_enabled()
    if use_ledger and model_family != "logistic":
        log.warning("ledger widening supports the logistic family only; off")
        use_ledger = False
    t0 = time.time()
    dev = resolve_device(device)
    stages = _Stages(dev)
    data_csv = data_csv or config.data_csv()
    x, y, feature_names = load_creditcard_csv(data_csv)
    log.info("loaded %s: %d rows, %d positives", data_csv, len(y), int(y.sum()))

    train_idx, test_idx = stratified_split(y, 0.2, seed)
    stages.mark("load")
    ledger_spec = ledger_state = None
    if use_ledger:
        spec0 = LedgerSpec.from_config(x.shape[1])
        ents, ts = synthesize_entities(
            x, feature_names, seed, config.ledger_synth_events_per_entity()
        )
        feats, ledger_state = materialize_features(spec0, x, ents, ts, device=dev)
        x = np.concatenate([x, feats], axis=1).astype(np.float32)
        feature_names = list(feature_names) + list(LEDGER_FEATURE_NAMES)
        ledger_spec = dataclasses.replace(
            spec0,
            # entity-less serving rows read the training rows' mean
            # velocity features (the null slot)
            null_features=feats[train_idx].mean(axis=0).astype(np.float32),
            # serve-time wall clocks continue the replay's clock
            ts_origin=time.time() - (float(ts.max()) + 1.0),
        )
        log.info("ledger widening on: %d slots, halflife %.0fs, +%d velocity "
                 "features", spec0.slots, spec0.halflife_s, len(LEDGER_FEATURE_NAMES))
        stages.mark("ledger_replay")
    x_train, y_train = x[train_idx], y[train_idx]
    x_test, y_test = x[test_idx], y[test_idx]

    scaler = scaler_fit(torch.as_tensor(x_train, device=dev))
    # device-resident from here on: fold gathers, SMOTE and the fits read
    # these directly
    xs_train = scaler_transform(scaler, torch.as_tensor(x_train, device=dev))
    xs_test = scaler_transform(scaler, torch.as_tensor(x_test, device=dev))
    stages.mark("scaler")

    client = TrackingClient()
    metrics: dict = {}
    lbfgs_iters: list[int] = []
    gbt = model_family == "gbt"
    with client.start_run() as run:
        # scale_pos_weight and SMOTE are alternative imbalance corrections:
        # the weight applies only without SMOTE
        spw = _scale_pos_weight(y_train) if gbt and not use_smote else 1.0
        run.log_params(
            {
                "model_type": "gbt" if gbt else "logistic_regression",
                "solver": solver,
                "n_folds": n_folds,
                "use_smote": use_smote,
                "class_weight": class_weight,
                "seed": seed,
                "n_rows": len(y),
                "n_features": x.shape[1],
                "device": dev.type,
                "n_devices": 1,
            }
        )

        # ---- CV with SMOTE inside each fold (no leakage) ----
        cv_aucs = []
        for fold, (tr, va) in enumerate(
            stratified_kfold_indices(y_train, n_folds, seed)
        ):
            x_tr, y_tr = _rows(xs_train, tr), y_train[tr]
            try:
                if use_smote:
                    t_smote: dict = {}
                    x_tr, y_tr = smote(x_tr, y_tr, seed + fold, timings=t_smote)
                    stages.mark(f"fold{fold}_smote")
                    stages.seconds[f"fold{fold}_knn"] = t_smote["knn"]
                if gbt:
                    gmodel, _ = _fit_gbt(x_tr, y_tr, gbt_config=gbt_config, spw=spw)
                    stages.mark(f"fold{fold}_fit")
                    val_scores = gbt_predict_proba(gmodel, _rows(xs_train, va))
                else:
                    params = _fit(
                        x_tr, y_tr, seed=seed + fold, solver=solver,
                        class_weight=class_weight, iters=lbfgs_iters,
                    )
                    stages.mark(f"fold{fold}_fit")
                    val_scores = predict_proba(params, _rows(xs_train, va))
                fold_auc = float(auc_roc(val_scores, y_train[va]))
                stages.mark(f"fold{fold}_auc")
            except ValueError as e:
                # a degenerate fold (too few positives for SMOTE, or a
                # one-class validation slice): report it and go on
                log.warning("fold %d skipped: %s", fold, e)
                run.set_tag(f"fold_{fold}_skipped", str(e))
                stages.mark(f"fold{fold}_skipped")
                continue
            cv_aucs.append(fold_auc)
            run.log_metric("cv_auc", fold_auc, step=fold)
            log.info("fold %d AUC %.4f", fold, fold_auc)
        if cv_aucs:
            metrics["cv_auc_mean"] = float(np.mean(cv_aucs))
            run.log_metric("cv_auc_mean", metrics["cv_auc_mean"])

        # ---- final fit on the SMOTE'd full train split ----
        if use_smote:
            t_smote = {}
            x_fin, y_fin = smote(xs_train, y_train, seed + 1000, timings=t_smote)
            stages.mark("final_smote")
            stages.seconds["final_knn"] = t_smote["knn"]
        else:
            x_fin, y_fin = xs_train, y_train
        if gbt:
            gmodel, used_cfg = _fit_gbt(x_fin, y_fin, gbt_config=gbt_config, spw=spw)
            run.log_params(
                {
                    "n_trees": used_cfg.n_trees,
                    "max_depth": used_cfg.max_depth,
                    "learning_rate": used_cfg.learning_rate,
                    "scale_pos_weight": used_cfg.scale_pos_weight,
                }
            )
            stages.mark("final_fit")
            test_scores_t = gbt_predict_proba(gmodel, xs_test)
        else:
            # a preempted SGD fit restarted with the same checkpoint_dir
            # goes on at the next epoch
            ck = SGDCheckpointer(checkpoint_dir) if checkpoint_dir else None
            params = _fit(
                x_fin, y_fin, seed=seed, solver=solver, class_weight=class_weight,
                checkpointer=ck, iters=lbfgs_iters,
            )
            if ck is not None:
                # the fit finished: leftover checkpoints must not make a
                # later run with this directory "resume" stale params
                ck.clear()
            stages.mark("final_fit")
            test_scores_t = predict_proba(params, xs_test)
        test_auc = float(auc_roc(test_scores_t, y_test))
        test_scores = test_scores_t.cpu().numpy()
        metrics["test_auc"] = test_auc
        run.log_metric("test_auc", test_auc)
        log.info("test AUC %.4f", test_auc)
        stages.mark("test_auc")

        # ---- drift baseline, in raw feature space (the serving scorer folds
        # the scaler into its weights and reads raw rows), scored by the
        # held-out test scores ----
        profile = build_baseline_profile(
            x_train, test_scores, feature_names=feature_names, device=dev
        )
        run.log_metric("monitor_profile_rows", profile.n_rows)
        stages.mark("baseline")

        # ---- artifacts, in both destinations: registration copies the
        # run's artifact dir, so every resolution path carries its own
        # calibration and drift baseline ----
        model_artifact = run.artifact_path("model")
        if gbt:
            # the wrapper folds the scaler into the bin edges (the forest
            # scores raw rows), derives the int8 calibration before the fold,
            # and stores a 128-row raw-space sample as the TreeSHAP background
            bg_idx = np.random.default_rng(seed).choice(
                len(x_train), min(128, len(x_train)), replace=False
            )
            model = FraudGBTModel(
                gmodel, feature_names, scaler=scaler, background=x_train[bg_idx],
                device=dev,
            )
        else:
            model = FraudLogisticModel(params, scaler, feature_names, device=dev,
                                       ledger_spec=ledger_spec, ledger_state=ledger_state)
        for directory in (out_dir, model_artifact):
            model.save(directory)
            save_profile(directory, profile)
        stages.mark("save")

        # ---- AUC promotion gate ----
        threshold = config.auc_threshold()
        run.log_param("auc_threshold", threshold)
        version = None
        if register:
            # the lineage record names the parent: whatever @prod pointed at
            # when this run trained
            parent = client.registry.get_version_by_alias(
                config.model_name(), config.model_stage()
            )
            version = client.registry.register_if_gate(
                config.model_name(),
                model_artifact,
                test_auc,
                threshold,
                alias=config.model_stage(),
                run_id=run.run_id,
                lineage={
                    "trained_by": "offline",
                    "parent_version": parent,
                    "data_csv": data_csv,
                    "n_rows": len(y),
                },
            )
            if version:
                run.set_tag("registered_version", version)
                log.info(
                    "registered %s v%d (alias %s)",
                    config.model_name(), version, config.model_stage(),
                )
            else:
                log.warning(
                    "AUC %.4f below threshold %.2f — not registered",
                    test_auc, threshold,
                )
        stages.mark("register")
        metrics["registered_version"] = version
        metrics["train_seconds"] = time.time() - t0
        metrics["stages"] = stages.seconds
        metrics["lbfgs_iters"] = lbfgs_iters
        run.log_metric("train_seconds", metrics["train_seconds"])
    return metrics


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--data", default=None)
    ap.add_argument("--folds", type=int, default=5)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--solver", choices=["auto", "lbfgs", "sgd"], default="auto")
    ap.add_argument("--model", choices=["logistic", "gbt"], default="logistic")
    ap.add_argument("--no-smote", action="store_true")
    ap.add_argument("--no-register", action="store_true")
    ap.add_argument("--wide", action="store_true", help="not ported yet")
    ap.add_argument(
        "--ledger", action="store_true",
        help="widen the rows with the ledger's per-entity velocity features "
        "(replayed through the serving body); also LEDGER_ENABLED=1",
    )
    ap.add_argument("--out-dir", default="models")
    ap.add_argument("--profile-dir", default=None, help="not ported yet")
    ap.add_argument(
        "--checkpoint-dir", default=None,
        help="write per-epoch SGD checkpoints here; re-running with the same "
        "dir resumes an interrupted fit at the next epoch (sgd/auto only)",
    )
    args = ap.parse_args(argv)
    for key, asked in (
        ("wide", args.wide), ("profile_dir", args.profile_dir is not None),
    ):
        if asked:
            ap.error(f"{_UNPORTED[key]} is not ported yet")
    metrics = train(
        data_csv=args.data,
        n_folds=args.folds,
        seed=args.seed,
        solver=args.solver,
        use_smote=not args.no_smote,
        register=not args.no_register,
        out_dir=args.out_dir,
        model_family=args.model,
        checkpoint_dir=args.checkpoint_dir,
        ledger=True if args.ledger else None,
    )
    print(metrics)


if __name__ == "__main__":
    main()
