"""The challenger gate: a retrained model judged against the champion.

The port's copy of the JAX package's ``lifecycle/gate.py``. A challenger
earns the ``@shadow`` alias only by clearing three bounds against the
incumbent champion, on a frozen holdout plus the recent labeled-feedback
window:

- **AUC**: challenger AUC ≥ champion AUC − ε (``CONDUCTOR_GATE_AUC_MARGIN``)
  on every slice with both classes present;
- **ECE**: challenger expected calibration error ≤
  ``CONDUCTOR_GATE_ECE_BOUND``;
- **score PSI vs champion**: PSI(challenger scores ‖ champion scores) on the
  holdout ≤ ``CONDUCTOR_GATE_PSI_BOUND``.

Both models score the slice through their own scorers (on the card the
logistic family's ``predict_proba`` is the ``fused_score`` kernel, a
forest's its device walk); the four statistics then come out of ONE
function on the scores' device (:func:`_gate_stats`), so the host never
loops over rows. Slices are padded to a power-of-two bucket (floor
``_MIN_GATE_BUCKET``) as in the reference, whose jit compiles once a
bucket; the port has no compile to save, but keeps the padding and the
weights vector that zeroes the padding rows. The bins sum in float64, so
the padding leaves the ECE and the PSI bitwise unchanged, and the AUC's
sums are of half-integers, exact while n_pos·n_neg < 2²³ (a test holds the
padded and unpadded statistics bitwise equal).

Every criterion is written as ``not (ok_condition)``, so a NaN statistic
(a diverged fit, a poisoned slice) fails the gate.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field

import numpy as np
import torch

from fraud_detection_tpu_torch import config
from fraud_detection_tpu_torch.monitor.drift import psi_from_counts
from fraud_detection_tpu_torch.ops.metrics import _auc_weighted
from fraud_detection_tpu_torch.ops.scorer import _bucket

log = logging.getLogger("fraud_detection_tpu_torch.lifecycle")

N_GATE_SCORE_BINS = 20
N_GATE_CALIB_BINS = 10

# Smallest padded slice length (the reference's compile-ladder floor).
_MIN_GATE_BUCKET = 256


@dataclass(frozen=True)
class GateThresholds:
    auc_margin: float
    ece_bound: float
    psi_bound: float
    min_eval_rows: int

    @classmethod
    def from_config(cls) -> "GateThresholds":
        return cls(
            auc_margin=config.conductor_gate_auc_margin(),
            ece_bound=config.conductor_gate_ece_bound(),
            psi_bound=config.conductor_gate_psi_bound(),
            min_eval_rows=config.conductor_min_eval_rows(),
        )


@dataclass
class GateResult:
    passed: bool
    reasons: list[str] = field(default_factory=list)
    metrics: dict = field(default_factory=dict)

    def to_json(self) -> dict:
        return {
            "passed": self.passed,
            "reasons": list(self.reasons),
            "metrics": {k: round(float(v), 6) for k, v in self.metrics.items()},
        }


def _weighted_hist(idx: torch.Tensor, weights: torch.Tensor, n_bins: int,
                   values: torch.Tensor | None = None) -> torch.Tensor:
    """Σ over rows of ``weights`` (times ``values``) into ``idx``'s bins, as
    the reference writes it: a one-hot (n, bins) product summed over rows.
    The sum runs in float64 and rounds to float32 once, so weight-0 padding
    rows leave every bin's float32 value as it was (a float32 sum's
    rounding would depend on the padded length's reduction tree)."""
    onehot = (idx[:, None] == torch.arange(n_bins, device=idx.device)[None, :])
    w = weights if values is None else weights * values
    return (onehot.to(torch.float64) * w.to(torch.float64)[:, None]).sum(dim=0).float()


def _gate_stats(
    champ_scores: torch.Tensor,  # (n,)
    chall_scores: torch.Tensor,  # (n,)
    labels: torch.Tensor,  # (n,) 0/1
    weights: torch.Tensor,  # (n,) 1.0 real rows, 0.0 padding
    score_edges: torch.Tensor,  # (s_bins - 1,) interior edges on [0, 1]
    calib_edges: torch.Tensor,  # (c_bins - 1,)
):
    """One gate evaluation a slice, on the scores' device. Returns
    ``(champ_auc, chall_auc, chall_ece, score_psi)`` as 0-d tensors."""
    champ_auc = _auc_weighted(champ_scores, labels, weights)
    chall_auc = _auc_weighted(chall_scores, labels, weights)

    # score-PSI challenger-vs-champion: both histogrammed on shared edges
    # (bin = the number of edges ≤ score, the reference's convention)
    n_score = score_edges.shape[0] + 1

    def hist(s):
        idx = torch.searchsorted(score_edges, s, right=True)
        return _weighted_hist(idx, weights, n_score)

    psi = psi_from_counts(hist(chall_scores), hist(champ_scores))

    # the challenger's ECE over uniform confidence bins (padding weight 0)
    n_calib = calib_edges.shape[0] + 1
    cidx = torch.searchsorted(calib_edges, chall_scores, right=True)
    cnt = _weighted_hist(cidx, weights, n_calib)
    conf = _weighted_hist(cidx, weights, n_calib, chall_scores) / cnt.clamp_min(1e-9)
    acc = _weighted_hist(
        cidx, weights, n_calib, (labels > 0).to(torch.float32)
    ) / cnt.clamp_min(1e-9)
    w = cnt / cnt.sum().clamp_min(1e-9)
    ece = (w * (conf - acc).abs()).sum()
    return champ_auc, chall_auc, ece, psi


def _slice_stats(
    champion, challenger, x: np.ndarray, y: np.ndarray,
    x_champion: np.ndarray | None = None,
) -> dict | None:
    """Score both models on one eval slice and run :func:`_gate_stats`.
    None when the slice cannot be judged (empty or single-class: AUC
    undefined). ``x_champion`` is the champion's OWN view of the same rows
    when the two models widen differently (the wide family: contribution
    columns gathered from each model's own cross table) — without it a
    widened champion would score the CHALLENGER's contributions through
    its coefficients."""
    y = np.asarray(y).reshape(-1)
    if x.shape[0] == 0 or (y > 0).all() or (y <= 0).all():
        return None

    def view(model, block) -> np.ndarray:
        # width-aware slice: a WIDENED eval block (base columns followed by
        # cross contributions) judges a narrow model on its base prefix,
        # so a narrow→wide gate scores each model as it would serve the rows
        d = getattr(model.scorer, "n_features", block.shape[1])
        return np.asarray(
            block[:, :d] if block.shape[1] > d else block, np.float32
        )

    champ = np.asarray(
        champion.scorer.predict_proba(
            view(champion, x_champion if x_champion is not None else x)
        ),
        np.float32,
    ).reshape(-1)
    chall = np.asarray(
        challenger.scorer.predict_proba(view(challenger, x)), np.float32
    ).reshape(-1)
    dev = getattr(challenger, "device", None) or torch.device("cpu")
    # pad to the power-of-two bucket with weight-0 rows, inert in all four
    # statistics
    n = int(y.shape[0])
    pad = _bucket(n, _MIN_GATE_BUCKET) - n

    def on_dev(a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.pad(np.asarray(a, np.float32), (0, pad)), device=dev)

    weights = on_dev(np.ones((n,), np.float32))
    score_edges = torch.as_tensor(
        np.linspace(0.0, 1.0, N_GATE_SCORE_BINS + 1)[1:-1], dtype=torch.float32,
        device=dev,
    )
    calib_edges = torch.as_tensor(
        np.linspace(0.0, 1.0, N_GATE_CALIB_BINS + 1)[1:-1], dtype=torch.float32,
        device=dev,
    )
    stats = _gate_stats(
        on_dev(champ), on_dev(chall), on_dev(y), weights, score_edges, calib_edges
    )
    champ_auc, chall_auc, ece, psi = (float(t) for t in torch.stack(stats).cpu())
    return {
        "champion_auc": champ_auc,
        "challenger_auc": chall_auc,
        "challenger_ece": ece,
        "score_psi_vs_champion": psi,
        "rows": int(x.shape[0]),
    }


def evaluate_gate(
    champion,
    challenger,
    x_holdout: np.ndarray,
    y_holdout: np.ndarray,
    x_recent: np.ndarray | None = None,
    y_recent: np.ndarray | None = None,
    thresholds: GateThresholds | None = None,
    x_holdout_champion: np.ndarray | None = None,
    x_recent_champion: np.ndarray | None = None,
) -> GateResult:
    """Run the full gate: the frozen holdout (required) and the recent
    labeled window (judged only when it clears ``min_eval_rows`` and holds
    both classes). ``x_holdout_champion``/``x_recent_champion`` are the
    champion's OWN widened views of the same rows when both models are
    widened but carry different tables (the wide→wide retrain)."""
    thr = thresholds or GateThresholds.from_config()
    reasons: list[str] = []
    metrics: dict = {}

    hold = _slice_stats(
        champion, challenger, x_holdout, y_holdout,
        x_champion=x_holdout_champion,
    )
    if hold is None:
        return GateResult(
            False, ["holdout slice unusable (empty or single-class)"], {}
        )
    metrics.update({f"holdout_{k}": v for k, v in hold.items()})
    if not (hold["challenger_auc"] >= hold["champion_auc"] - thr.auc_margin):
        reasons.append(
            f"holdout AUC {hold['challenger_auc']:.4f} < champion "
            f"{hold['champion_auc']:.4f} - {thr.auc_margin}"
        )
    if not (hold["challenger_ece"] <= thr.ece_bound):
        reasons.append(
            f"holdout ECE {hold['challenger_ece']:.4f} > {thr.ece_bound}"
        )
    if not (hold["score_psi_vs_champion"] <= thr.psi_bound):
        reasons.append(
            f"holdout score PSI vs champion "
            f"{hold['score_psi_vs_champion']:.4f} > {thr.psi_bound}"
        )

    if x_recent is not None and x_recent.shape[0] >= thr.min_eval_rows:
        recent = _slice_stats(
            champion, challenger, x_recent, y_recent,
            x_champion=x_recent_champion,
        )
        if recent is not None:
            metrics.update({f"recent_{k}": v for k, v in recent.items()})
            if not (
                recent["challenger_auc"]
                >= recent["champion_auc"] - thr.auc_margin
            ):
                reasons.append(
                    f"recent-window AUC {recent['challenger_auc']:.4f} < "
                    f"champion {recent['champion_auc']:.4f} - {thr.auc_margin}"
                )
            if not (recent["challenger_ece"] <= thr.ece_bound):
                reasons.append(
                    f"recent-window ECE {recent['challenger_ece']:.4f} > "
                    f"{thr.ece_bound}"
                )
        else:
            log.info("recent labeled window single-class — slice skipped")

    return GateResult(not reasons, reasons, metrics)
