"""The retrain executor: what runs when the watchtower says "retrain".

The port's copy of the JAX package's ``lifecycle/retrain.py``, on the
default mesh of one device (the card unless ``DEVICE=cpu`` or ``device=``
asks for the CPU; one shard, or one a process of a group).
It assembles a training set from the base CSV plus the durable feedback
replay (recent window + uniform-over-history reservoir, :mod:`.store`),
warm-starts the solver from the incumbent champion's params, runs the
offline trainer's sharded L-BFGS fit, and judges the result against the
champion on the frozen holdout plus the recent-window slice through the gate
(:mod:`.gate`). On the card the SMOTE step's k-NN is the ``knn_topk``
kernel, and the gate's, the holdout's and the profile's scores are the
``fused_score`` kernel (the logistic family's ``predict_proba``).

The warm start crosses scaler spaces: the champion's params are folded to
raw-input space (the identity the serving scorer relies on), then
re-expressed in the NEW scaler's space.

The holdout is carved with the offline trainer's stratified split and seed
(so the gate's "frozen holdout" is the split every champion was judged
on), the scaler is fitted on the train side only, and SMOTE never sees
eval rows. SMOTE's draws come from a CPU ``torch.Generator(seed + 1000)``,
so the card and the CPU build the same synthetic rows (the reference draws
from threefry: an accepted deviation, ROADMAP queue 3).

Three branches, chosen by the champion and ``WIDE_ENABLED``:

- the logistic family (narrow champion, or a forest: cold start);
- the ledger family: base and feedback rows replayed in timestamp order
  through the serving body (``ledger/replay``), the challenger stamped with
  the replay's final table;
- the wide family (a wide champion, or ``WIDE_ENABLED=1`` under a narrow
  one): the hashed crosses of the raw rows fitted with the base slice by
  ``mesh/retrain.wide_sgd_fit`` over ``wide_training_mesh()``
  (``MESH_MODEL_DEVICES`` model shards, as ``train()``'s).

``MESH_RETRAIN=1`` fits the logistic and ledger families with the
cross-replica-sharded weight update in place of L-BFGS
(``mesh/retrain.mesh_sgd_fit``: ``max(max_iter // 20, 3)`` epochs from
the champion's warm start). The feedback pools' summary is the
``mapreduce_pool_stats`` over the same mesh.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from fraud_detection_tpu_torch import config
from fraud_detection_tpu_torch.data.loader import load_creditcard_csv, stratified_split
from fraud_detection_tpu_torch.device import resolve_device
from fraud_detection_tpu_torch.lifecycle.gate import (
    GateResult,
    GateThresholds,
    evaluate_gate,
)
from fraud_detection_tpu_torch.models.logistic import FraudLogisticModel
from fraud_detection_tpu_torch.monitor.baseline import build_baseline_profile, save_profile
from fraud_detection_tpu_torch.ops.logistic import LogisticParams, logistic_fit_lbfgs
from fraud_detection_tpu_torch.ops.scaler import scaler_fit, scaler_transform
from fraud_detection_tpu_torch.ops.scorer import fold_scaler_into_linear
from fraud_detection_tpu_torch.ops.smote import smote
from fraud_detection_tpu_torch.parallel.mesh import default_mesh

log = logging.getLogger("fraud_detection_tpu_torch.lifecycle")

HOLDOUT_SEED = 42  # the offline trainer's split seed — the frozen holdout
HOLDOUT_FRACTION = 0.2


@dataclass
class RetrainResult:
    gate: GateResult
    challenger: FraudLogisticModel | None
    artifact_dir: str | None
    run_id: str | None
    champion_version: int | None
    metrics: dict = field(default_factory=dict)
    #: ``(x, y)`` the final fit saw (SMOTE's rows appended), on the host,
    #: when ``run_retrain(keep_fit_rows=True)``
    fit_rows: tuple | None = None


def warm_start_from(champion, new_scaler) -> LogisticParams | None:
    """Champion params re-expressed in the new scaler's space (None when the
    champion family carries no linear params — a forest — and the fit must
    start cold)."""
    params = getattr(champion, "params", None)
    if params is None or not isinstance(params, LogisticParams):
        return None
    folded = fold_scaler_into_linear(params, getattr(champion, "scaler", None))
    w_raw = folded.coef.float()
    b_raw = folded.intercept.float().reshape(())
    if new_scaler is None:
        return LogisticParams(coef=w_raw, intercept=b_raw)
    scale = new_scaler.scale.to(w_raw.device, torch.float32)
    mean = new_scaler.mean.to(w_raw.device, torch.float32)
    return LogisticParams(coef=w_raw * scale, intercept=b_raw + torch.dot(mean, w_raw))


def _replay_widened(
    spec, x, feature_names, seed, fx_w, fe_w, ft_w, fx_r, fe_r, ft_r, device,
):
    """The widened feature blocks of a ledger retrain: ONE causal replay
    (timestamp order) over base + feedback rows through the serving body.
    Base rows get the offline trainer's seeded pseudo-entities; feedback
    rows carry their recorded entity and timestamp (rows persisted without
    them replay through the null slot, ordered after the base clock).
    Returns the widened base matrix, the widened feature names, the spec to
    stamp on the challenger (clock origin advanced to serve time), the
    final table snapshot, and the widened window/reservoir blocks."""
    from fraud_detection_tpu_torch.ledger import (
        LEDGER_FEATURE_NAMES,
        materialize_features,
        synthesize_entities,
    )

    n_b, n_w, n_r = x.shape[0], fx_w.shape[0], fx_r.shape[0]
    ents_b, ts_b = synthesize_entities(
        x, feature_names, seed, config.ledger_synth_events_per_entity(),
    )
    base_max = float(ts_b.max()) if n_b else 0.0

    def fb_meta(ents, ts, n, newest_first: bool, offset: float):
        ents = list(ents) if ents else [None] * n
        out_ts = np.zeros(n, np.float32)
        for i in range(n):
            t = float(ts[i]) if ts is not None and i < len(ts) else 0.0
            if t > 0:
                out_ts[i] = spec.rel_ts(t)
            else:
                # no recorded event time: order after the base clock, in
                # fetch order (window rows arrive newest first — reversed
                # so older rows replay first)
                rank = (n - i) if newest_first else (i + 1)
                out_ts[i] = base_max + offset + rank
        return ents, out_ts

    ents_r, ts_r = fb_meta(fe_r, ft_r, n_r, False, 0.25)
    ents_w, ts_w = fb_meta(fe_w, ft_w, n_w, True, 0.5)
    all_x = np.concatenate([a for a in (x, fx_w, fx_r) if a.size]) if (
        n_w or n_r
    ) else x
    all_ents = list(ents_b) + (ents_w if n_w else []) + (ents_r if n_r else [])
    all_ts = np.concatenate(
        [a for a, k in ((ts_b, n_b), (ts_w, n_w), (ts_r, n_r)) if k]
    )
    feats, final_state = materialize_features(
        spec, all_x, all_ents, all_ts, device=device
    )
    xw = np.concatenate([all_x, feats], axis=1).astype(np.float32)
    new_spec = dataclasses.replace(
        spec, ts_origin=time.time() - (float(all_ts.max()) + 1.0)
    )
    names = list(feature_names) + list(LEDGER_FEATURE_NAMES)
    return (
        xw[:n_b], names, new_spec, final_state,
        xw[n_b : n_b + n_w], xw[n_b + n_w :],
    )


def run_retrain(
    store,
    champion,
    champion_version: int | None,
    reason: str = "",
    data_csv: str | None = None,
    use_smote: bool = True,
    max_iter: int = 200,
    seed: int = HOLDOUT_SEED,
    thresholds: GateThresholds | None = None,
    tracking_client=None,
    device: str | torch.device | None = None,
    keep_fit_rows: bool = False,
) -> RetrainResult:
    """One full retrain → gate pass on ``device``. Pure with respect to the
    registry: the conductor decides what to do with a passing challenger
    (register, alias, state transitions); this function only trains and
    judges. ``metrics["stages"]`` holds the seconds of each stage, the
    device synchronised at every boundary."""
    from fraud_detection_tpu_torch.tracking import TrackingClient
    from fraud_detection_tpu_torch.train import _Stages

    t0 = time.time()
    dev = resolve_device(device)
    mesh = default_mesh(dev)
    stages = _Stages(dev)
    client = tracking_client or TrackingClient()
    thresholds = thresholds or GateThresholds.from_config()

    # ---- base data + frozen holdout (the split every champion was judged on)
    x, y, feature_names = load_creditcard_csv(data_csv or config.data_csv())
    train_idx, test_idx = stratified_split(y, HOLDOUT_FRACTION, seed)
    stages.mark("load")

    # ---- feedback replay: recent window + history reservoir (raw rows).
    # The window splits disjointly: even rows replay into TRAINING, odd rows
    # become the gate's recent-eval slice (judging the challenger on rows it
    # trained on would inflate its recent AUC against a champion that never
    # saw them). Interleaved, so both halves span the same period.
    ledger_spec = getattr(champion, "ledger_spec", None)
    ledger_state = None
    wide_spec = getattr(champion, "wide_spec", None)
    if wide_spec is None and config.wide_enabled():
        if ledger_spec is not None:
            # the two widenings exclude each other: keep the ledger retrain
            log.warning(
                "WIDE_ENABLED ignored: the champion is ledger-widened — "
                "retraining the ledger family instead"
            )
        else:
            # the narrow→wide promotion flow: the challenger's crosses start
            # from a zero table, the warm start seeds the base slice, and the
            # gate judges each model at its own width over the same rows
            from fraud_detection_tpu_torch.ops.crosses import spec_from_config

            wide_spec = spec_from_config(x.shape[1])
    fps_base = fps_w = fps_r = None
    if wide_spec is not None:
        # the wide challenger retrains on the crosses serving computes:
        # recorded entities for feedback rows, the ledger's seeded
        # pseudo-entities for the entity-less base CSV. The base block stays
        # unwidened: the contributions depend on the table being fitted
        from fraud_detection_tpu_torch.ledger.replay import synthesize_entities
        from fraud_detection_tpu_torch.ops.crosses import entity_fingerprints

        fx_w, fs_w, fy_w, fe_w, ft_w = store.window_rows_meta()
        fx_r, fs_r, fy_r, fe_r, ft_r = store.reservoir_rows_meta()
        ents_b, _ = synthesize_entities(
            x, feature_names, seed, config.ledger_synth_events_per_entity()
        )
        fps_base = entity_fingerprints(ents_b, x.shape[0])
        fps_w = entity_fingerprints(fe_w, fx_w.shape[0])
        fps_r = entity_fingerprints(fe_r, fx_r.shape[0])
    elif ledger_spec is None:
        fx_w, fs_w, fy_w = store.window_rows()
        fx_r, fs_r, fy_r = store.reservoir_rows()
    else:
        # a widened champion retrains on WIDENED features: base + feedback
        # rows replay through the serving body in timestamp order, so the
        # challenger's training features are the features serving computes.
        # The meta fetch rides the same store read as the rows.
        fx_w, fs_w, fy_w, fe_w, ft_w = store.window_rows_meta()
        fx_r, fs_r, fy_r, fe_r, ft_r = store.reservoir_rows_meta()
        (
            x, feature_names, ledger_spec, ledger_state, fx_w, fx_r,
        ) = _replay_widened(
            ledger_spec, x, feature_names, seed,
            fx_w, fe_w, ft_w, fx_r, fe_r, ft_r, dev,
        )
    stages.mark("feedback")
    x_train, y_train = x[train_idx], y[train_idx]
    x_hold, y_hold = x[test_idx], y[test_idx]
    fx_train, fy_train = fx_w[0::2], fy_w[0::2]
    fx_eval, fy_eval = fx_w[1::2], fy_w[1::2]
    fps_fit = fps_hold = fps_eval = None
    x_hold_champ = fx_eval_champ = None
    if wide_spec is not None:
        fps_hold = fps_base[test_idx]
        fps_eval = fps_w[1::2]
        fps_fit = np.concatenate(
            [a for a in (fps_base[train_idx], fps_w[0::2], fps_r) if a.size]
        ).astype(np.uint32)
    replay_x = [a for a in (fx_train, fx_r) if a.size]
    replay_y = [a for a in (fy_train, fy_r) if a.size]
    n_replay = int(sum(a.shape[0] for a in replay_x))
    if replay_x:
        if any(a.shape[1] != x_train.shape[1] for a in replay_x):
            raise ValueError(
                "feedback feature arity does not match the base dataset"
            )
        x_fit = np.concatenate([x_train, *replay_x]).astype(np.float32)
        y_fit = np.concatenate(
            [y_train, *(a.astype(y_train.dtype) for a in replay_y)]
        )
    else:
        x_fit, y_fit = x_train, y_train

    # the feedback pools' summary the run records (scores from the SAME
    # fetch as the replay rows: a second store read could interleave with
    # arriving feedback and misalign scores with rows)
    pool_stats: dict | None = None
    if replay_x:
        from fraud_detection_tpu_torch.mesh.retrain import mapreduce_pool_stats

        pool_scores = np.concatenate(
            [fs_w[0::2], fs_r]
        ) if fs_r.size else fs_w[0::2]
        try:
            pool_stats = mapreduce_pool_stats(
                np.concatenate(replay_x), np.concatenate(replay_y), pool_scores,
                mesh=mesh,
            )
        except Exception as e:
            log.warning("feedback pool aggregation failed: %s", e)
    stages.mark("pool_stats")

    with client.start_run() as run:
        run.log_params(
            {
                "trigger": "conductor_retrain",
                "reason": reason[:500],
                "n_base_rows": int(len(y_train)),
                "n_feedback_rows": n_replay,
                "warm_start": champion_version is not None,
                "parent_version": champion_version,
                "use_smote": use_smote,
                "max_iter": max_iter,
                "device": dev.type,
                "n_devices": mesh.global_data,
                "mesh_retrain": config.mesh_retrain(),
            }
        )
        if pool_stats is not None:
            run.log_metric("feedback_label_rate", pool_stats["label_rate"])
            run.log_metric("feedback_score_mean", pool_stats["score_mean"])

        # ---- scaler on the train side only, then the fit
        x_fit_dev = torch.as_tensor(x_fit, device=dev)
        scaler = scaler_fit(x_fit_dev)
        xs_fit = scaler_transform(scaler, x_fit_dev)
        ws = None if wide_spec is not None else warm_start_from(champion, scaler)
        x_final, y_final = xs_fit, y_fit
        stages.mark("scaler")
        if use_smote and wide_spec is not None:
            # a synthetic row carries no hashable entity or cross identity,
            # so the wide fit trains on the class-weighted raw mix instead
            use_smote = False
            run.set_tag("smote_skipped", "wide family: crosses are discrete")
        n_synth = 0
        if use_smote:
            try:
                x_final, y_final = smote(xs_fit, y_fit, seed + 1000)
                n_synth = int(x_final.shape[0]) - int(xs_fit.shape[0])
            except ValueError as e:
                # a degenerate minority (too few positives for k-NN): fit on
                # the raw mix rather than failing the whole loop
                log.warning("retrain SMOTE skipped: %s", e)
                run.set_tag("smote_skipped", str(e))
            stages.mark("smote")
        wide_names = wide_scaler = wide_table = None
        if wide_spec is not None:
            # the wide family's 2-D (data × model) fit over
            # wide_training_mesh(), train()'s grid: the warm start crosses
            # scaler spaces on the BASE slice; the champion's table
            # warm-starts verbatim (contributions are raw-space)
            from fraud_detection_tpu_torch.mesh.retrain import (
                wide_sgd_fit,
                wide_training_mesh,
            )
            from fraud_detection_tpu_torch.ops.crosses import (
                cross_indices,
                widen_scaler,
                widen_with_crosses,
            )

            ws_base = None
            if isinstance(getattr(champion, "params", None), LogisticParams):
                # a champion without linear params (a forest) cold-starts
                folded = fold_scaler_into_linear(
                    champion.params, getattr(champion, "scaler", None)
                )
                w_raw = folded.coef.float()[: wide_spec.n_base].to(dev)
                ws_base = LogisticParams(
                    coef=w_raw * scaler.scale.to(dev),
                    intercept=(
                        folded.intercept.float().to(dev).reshape(())
                        + torch.dot(scaler.mean.to(dev), w_raw)
                    ),
                )
            # indices hash the RAW rows — the values serving hashes
            idx_fit = cross_indices(x_fit, fps_fit, wide_spec, device=dev)
            has_fit = (fps_fit != 0).astype(np.float32)
            params, wide_table = wide_sgd_fit(
                x_final, idx_fit, has_fit, y_final, wide_spec,
                epochs=max(max_iter // 10, 5), seed=seed,
                class_weight="balanced",
                warm_start=(ws_base, getattr(champion, "wide_table", None)),
                mesh=wide_training_mesh(device=dev),
            )
            stages.mark("fit")
            wide_names = list(feature_names) + list(wide_spec.cross_names)
            wide_scaler = widen_scaler(scaler, wide_spec.n_cross)
            challenger = FraudLogisticModel(
                params, wide_scaler, wide_names, device=dev,
                wide_spec=wide_spec, wide_table=wide_table,
            )
            # the gate judges WIDENED slices, the block the fused flush builds
            # for these rows: the challenger's from ITS fitted table, a wide
            # champion's from its OWN table
            champ_table = getattr(champion, "wide_table", None)
            if champ_table is not None:
                x_hold_champ = widen_with_crosses(
                    x_hold, fps_hold, champ_table, champion.wide_spec, device=dev
                )
                fx_eval_champ = (
                    widen_with_crosses(
                        fx_eval, fps_eval, champ_table, champion.wide_spec,
                        device=dev,
                    )
                    if fx_eval.size else None
                )
            x_hold = widen_with_crosses(x_hold, fps_hold, wide_table, wide_spec,
                                        device=dev)
            if fx_eval.size:
                fx_eval = widen_with_crosses(
                    fx_eval, fps_eval, wide_table, wide_spec, device=dev
                )
        else:
            if config.mesh_retrain():
                # MESH_RETRAIN=1: the warm-started update itself shards
                # across the mesh — each shard owns 1/N of the params and
                # their momentum (2004.13336)
                from fraud_detection_tpu_torch.mesh.retrain import mesh_sgd_fit

                params = mesh_sgd_fit(
                    x_final, y_final, epochs=max(max_iter // 20, 3),
                    warm_start=ws, mesh=mesh,
                )
            else:
                params = logistic_fit_lbfgs(
                    x_final, y_final, max_iter=max_iter, warm_start=ws,
                    mesh=mesh, sharded=True,
                )
            stages.mark("fit")
            challenger = FraudLogisticModel(
                params, scaler, list(feature_names), device=dev,
                ledger_spec=ledger_spec, ledger_state=ledger_state,
            )

        # ---- the challenger gate: frozen holdout + recent labeled window
        gate = evaluate_gate(
            champion,
            challenger,
            x_hold,
            y_hold,
            x_recent=fx_eval if fx_eval.size else None,
            y_recent=fy_eval if fy_eval.size else None,
            thresholds=thresholds,
            x_holdout_champion=x_hold_champ,
            x_recent_champion=fx_eval_champ,
        )
        stages.mark("gate")
        for k, v in gate.metrics.items():
            run.log_metric(k, float(v))
        run.set_tag("gate_passed", gate.passed)
        if gate.reasons:
            run.set_tag("gate_reasons", "; ".join(gate.reasons)[:900])

        # ---- artifacts: the model with its calibration and sidecars, and
        # the drift baseline beside it (every resolution path carries its
        # own monitor profile)
        artifact_dir = run.artifact_path("model")
        challenger.save(artifact_dir, joblib_too=False)
        hold_scores = np.asarray(
            challenger.scorer.predict_proba(np.asarray(x_hold, np.float32))
        )
        if wide_spec is not None:
            # the baseline covers the WIDENED block (base + contributions),
            # the distribution the fused wide flush bins; it reuses the fit's
            # cross indices rather than hashing x_fit again
            table_np = wide_table.detach().cpu().numpy()
            contrib_fit = table_np[idx_fit] * has_fit[:, None]
            profile = build_baseline_profile(
                np.concatenate([x_fit, contrib_fit], axis=1).astype(np.float32),
                hold_scores, feature_names=wide_names, device=dev,
            )
        else:
            profile = build_baseline_profile(
                x_fit, hold_scores, feature_names=list(feature_names), device=dev,
            )
        save_profile(artifact_dir, profile)
        stages.mark("artifacts")

        wall = time.time() - t0
        run.log_metric("retrain_seconds", wall)
        metrics = dict(gate.metrics)
        metrics.update(
            {
                "retrain_seconds": wall,
                "n_feedback_rows": n_replay,
                "n_fit_rows": int(x_final.shape[0]),
                "n_synthetic_rows": n_synth,
                "stages": stages.seconds,
            }
        )
        fit_rows = None
        if keep_fit_rows:
            fit_rows = (
                torch.as_tensor(x_final).detach().cpu().numpy(), np.asarray(y_final)
            )
        return RetrainResult(
            gate=gate,
            challenger=challenger,
            artifact_dir=artifact_dir,
            run_id=run.run_id,
            champion_version=champion_version,
            metrics=metrics,
            fit_rows=fit_rows,
        )
