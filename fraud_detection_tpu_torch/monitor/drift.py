"""Online drift accumulators: the device-resident decayed window.

On the serving path the drift fold rides the flush itself:
:func:`_fused_flush` / :func:`_fused_flush_explain` score the staged batch
through the scorer's score body (the ``fused_score`` kernel or the forest
on the card), optionally take the per-row top-k SHAP reason codes (linear
SHAP, or TreeSHAP through the ``tree_shap`` kernel), and fold the
batch into the window — all enqueued on the device stream, with no host
sync; the caller's one device-to-host copy of the outputs is the only one.
The JAX package runs each as one XLA program per bucket; here they are
eager PyTorch launches (one CUDA-graph replay per flush is later work).

The JAX programs donate the window buffers. The port instead preallocates
the window tensors once (:func:`init_window`) and updates them in place,
which keeps one live copy of the monitoring state the same way.

Statistics are derived lazily (:func:`_drift_stats`) when
``/monitor/status`` or a scrape asks: per-feature and score PSI
(``Σ (p−q)·ln(p/q)`` over smoothed bin masses), KS (``max |CDF_p −
CDF_q|``) and windowed ECE over labeled feedback rows. The window is
exponential (half-life in rows).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from fraud_detection_tpu_torch import config
from fraud_detection_tpu_torch.device import resolve_device
from fraud_detection_tpu_torch.monitor.baseline import (
    BaselineProfile,
    feature_histogram,
    score_histogram,
)
from fraud_detection_tpu_torch.ops.linear_shap import _raw_linear_shap, topk_reasons
from fraud_detection_tpu_torch.ops.scorer import _bucket
from fraud_detection_tpu_torch.ops.tree_shap import TreeShapExplainer, _raw_tree_shap

PSI_EPS = 1e-4
N_CALIB_BINS = 10


@dataclass(frozen=True)
class DriftWindow:
    """Decayed window state — preallocated device tensors, updated in
    place by every fold (the counterpart of the reference's donated
    buffers)."""

    feature_counts: torch.Tensor  # (d, n_bins)
    score_counts: torch.Tensor  # (s_bins,)
    calib_count: torch.Tensor  # (c_bins,) labeled rows per score bin
    calib_conf: torch.Tensor  # (c_bins,) Σ score over labeled rows
    calib_label: torch.Tensor  # (c_bins,) Σ label over labeled rows
    n_rows: torch.Tensor  # () decayed row count

    def tensors(self) -> tuple[torch.Tensor, ...]:
        return (
            self.feature_counts, self.score_counts, self.calib_count,
            self.calib_conf, self.calib_label, self.n_rows,
        )


class DriftStats(NamedTuple):
    feature_psi: torch.Tensor  # (d,)
    feature_ks: torch.Tensor  # (d,)
    score_psi: torch.Tensor  # ()
    score_ks: torch.Tensor  # ()
    ece: torch.Tensor  # ()
    n_labeled: torch.Tensor  # ()


def init_window(
    n_features: int, n_feature_bins: int, n_score_bins: int,
    n_calib_bins: int = N_CALIB_BINS, device: torch.device | None = None,
) -> DriftWindow:
    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return DriftWindow(
        feature_counts=z(n_features, n_feature_bins),
        score_counts=z(n_score_bins),
        calib_count=z(n_calib_bins),
        calib_conf=z(n_calib_bins),
        calib_label=z(n_calib_bins),
        n_rows=z(),
    )


def _narrow_scores(scores: torch.Tensor, out_dtype) -> torch.Tensor:
    """Cast the score output to the d2h return wire; the drift fold always
    bins the full-precision f32 scores. ``uint8`` ships ``round(p·255)``
    (round half to even, like the reference)."""
    if out_dtype == torch.uint8:
        return torch.round(scores * 255.0).to(torch.uint8)
    if out_dtype == torch.float32:
        return scores
    return scores.to(out_dtype)


def _narrow_reasons(
    idx: torch.Tensor, val: torch.Tensor, n_features: int, out_dtype
) -> tuple[torch.Tensor, torch.Tensor]:
    """Compress reason codes for the d2h copy: uint8 indices when the
    schema fits in a byte; f16 values on any narrow return wire
    (attributions are signed, so the uint8 lattice does not apply)."""
    if n_features <= 256:
        idx = idx.to(torch.uint8)
    if out_dtype != torch.float32:
        val = val.to(torch.float16)
    return idx, val


def _topk_attributions(
    xf: torch.Tensor, explain_args, explain_k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """The explain leg: exact interventional SHAP over the values the model
    scored, reduced to the per-row arg-top-k. The family follows
    ``explain_args``: a ``TreeShapExplainer`` goes through
    ``_raw_tree_shap`` (with the explainer's cached kernel tables), the
    linear pair ``(coef, background_mean)`` through ``_raw_linear_shap``.
    Each is its standalone explainer's body, so fused reason codes are
    bitwise the standalone ones."""
    if isinstance(explain_args, TreeShapExplainer):
        return topk_reasons(
            _raw_tree_shap(explain_args.model, explain_args.bg_table, xf,
                           tables=explain_args.tables),
            explain_k,
        )
    coef, background_mean = explain_args
    return topk_reasons(_raw_linear_shap(coef, background_mean, xf), explain_k)


def _fold_serving_batch(
    window: DriftWindow,
    xf: torch.Tensor,
    scores: torch.Tensor,
    valid: torch.Tensor,
    decay: float,
    feature_edges: torch.Tensor,
    score_edges: torch.Tensor,
) -> None:
    """The serving-flush window fold shared by both fused flushes: bin the
    batch the model scored, decay-fold the drift histograms in place, leave
    calibration state untouched (serving batches carry no labels)."""
    fc = feature_histogram(xf, feature_edges, weights=valid)
    sc = score_histogram(scores, score_edges, weights=valid)
    window.feature_counts.mul_(decay).add_(fc)
    window.score_counts.mul_(decay).add_(sc)
    window.n_rows.mul_(decay).add_(valid.sum())


def _fused_flush(
    window: DriftWindow,
    x: torch.Tensor,  # (b, d) staged batch on the device
    valid: torch.Tensor,  # (b,) 1.0 for real rows, 0.0 for bucket padding
    decay: float,  # drift forgetting factor (live rows this batch)
    feature_edges: torch.Tensor,
    score_edges: torch.Tensor,
    score_args,
    *,
    score_fn,
    out_dtype=torch.float32,
) -> torch.Tensor:
    """Scores **and** the drift-window fold for one staged batch; returns
    the score vector in the ``out_dtype`` return wire."""
    xf = x.float()
    scores = score_fn(score_args, x).float()
    _fold_serving_batch(
        window, xf, scores, valid, decay, feature_edges, score_edges
    )
    return _narrow_scores(scores, out_dtype)


def _fused_flush_explain(
    window: DriftWindow,
    x: torch.Tensor,
    valid: torch.Tensor,
    decay: float,
    feature_edges: torch.Tensor,
    score_edges: torch.Tensor,
    score_args,
    explain_args,  # linear-SHAP (coef, background_mean) or a TreeShapExplainer
    *,
    score_fn,
    explain_k: int,  # reason codes per row (pre-clamped to d)
    out_dtype=torch.float32,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Scores, per-row top-k reason codes AND the drift fold; returns
    ``(scores, reason_idx, reason_val)``. The window fold is the one
    :func:`_fused_flush` runs, so enabling explanations cannot move
    monitoring state."""
    xf = x.float()
    scores = score_fn(score_args, x).float()
    idx, val = _topk_attributions(xf, explain_args, explain_k)
    idx, val = _narrow_reasons(idx, val, x.shape[1], out_dtype)
    _fold_serving_batch(
        window, xf, scores, valid, decay, feature_edges, score_edges
    )
    return _narrow_scores(scores, out_dtype), idx, val


def _window_update(
    window: DriftWindow,
    x: torch.Tensor,  # (n, d) padded batch
    scores: torch.Tensor,  # (n,)
    labels: torch.Tensor,  # (n,) feedback labels, garbage where unlabeled
    label_valid: torch.Tensor,  # (n,) 1.0 where labels[i] is real
    valid: torch.Tensor,  # (n,) 1.0 for real rows, 0.0 for bucket padding
    decay: float,  # drift forgetting factor (live rows this batch)
    calib_decay: float,  # calibration factor (labeled rows this batch)
    feature_edges: torch.Tensor,
    score_edges: torch.Tensor,
    calib_edges: torch.Tensor,
) -> None:
    """Fold one scored batch into the window in place (the split path and
    feedback replays). ``valid`` masks rows into the drift histograms,
    ``label_valid`` into the calibration state; their decays are
    independent."""
    fc = feature_histogram(x.float(), feature_edges, weights=valid)
    sc = score_histogram(scores, score_edges, weights=valid)
    n_calib = calib_edges.shape[0] + 1
    cidx = (scores[:, None] >= calib_edges[None, :]).sum(dim=-1)
    onehot = (
        cidx[:, None] == torch.arange(n_calib, device=scores.device)[None, :]
    ).float()
    lw = label_valid
    window.feature_counts.mul_(decay).add_(fc)
    window.score_counts.mul_(decay).add_(sc)
    window.calib_count.mul_(calib_decay).add_(lw @ onehot)
    window.calib_conf.mul_(calib_decay).add_((lw * scores) @ onehot)
    window.calib_label.mul_(calib_decay).add_((lw * labels) @ onehot)
    window.n_rows.mul_(decay).add_(valid.sum())


def _smoothed_mass(counts: torch.Tensor) -> torch.Tensor:
    """Additively-smoothed bin masses along the last axis (finite PSI on
    empty bins)."""
    n_bins = counts.shape[-1]
    total = counts.sum(dim=-1, keepdim=True)
    return (counts + PSI_EPS) / (total + PSI_EPS * n_bins)


def psi_from_counts(p_counts: torch.Tensor, q_counts: torch.Tensor) -> torch.Tensor:
    """Population stability index along the last axis."""
    p = _smoothed_mass(p_counts)
    q = _smoothed_mass(q_counts)
    return ((p - q) * torch.log(p / q)).sum(dim=-1)


def ks_from_counts(p_counts: torch.Tensor, q_counts: torch.Tensor) -> torch.Tensor:
    """Two-sample KS statistic from histograms along the last axis."""
    p = p_counts / p_counts.sum(dim=-1, keepdim=True).clamp_min(1.0)
    q = q_counts / q_counts.sum(dim=-1, keepdim=True).clamp_min(1.0)
    return (torch.cumsum(p, dim=-1) - torch.cumsum(q, dim=-1)).abs().amax(dim=-1)


def _drift_stats(
    window: DriftWindow,
    base_feature_counts: torch.Tensor,
    base_score_counts: torch.Tensor,
) -> DriftStats:
    n_labeled = window.calib_count.sum()
    cnt = window.calib_count.clamp_min(1e-9)
    conf = window.calib_conf / cnt
    acc = window.calib_label / cnt
    w = window.calib_count / n_labeled.clamp_min(1e-9)
    return DriftStats(
        feature_psi=psi_from_counts(window.feature_counts, base_feature_counts),
        feature_ks=ks_from_counts(window.feature_counts, base_feature_counts),
        score_psi=psi_from_counts(window.score_counts, base_score_counts),
        score_ks=ks_from_counts(window.score_counts, base_score_counts),
        ece=(w * (conf - acc).abs()).sum(),
        n_labeled=n_labeled,
    )


class DriftMonitor:
    """Host wrapper: owns the device-resident window, pads feedback batches
    onto the power-of-two bucket ladder, and surfaces stats as floats."""

    def __init__(
        self,
        profile: BaselineProfile,
        halflife_rows: float | None = None,
        min_bucket: int = 8,
        device: str | torch.device | None = None,
    ):
        self.profile = profile
        self.device = resolve_device(device)
        self.halflife_rows = float(
            halflife_rows
            if halflife_rows is not None
            else config.watchtower_halflife_rows()
        )
        self.min_bucket = min_bucket

        def dev(a) -> torch.Tensor:
            return torch.as_tensor(
                np.asarray(a, np.float32), device=self.device
            ).contiguous()

        self._feature_edges = dev(profile.feature_edges)
        self._score_edges = dev(profile.score_edges)
        self._calib_edges = dev(np.linspace(0.0, 1.0, N_CALIB_BINS + 1)[1:-1])
        self._base_fc = dev(profile.feature_counts)
        self._base_sc = dev(profile.score_counts)
        self.window = init_window(
            profile.n_features,
            profile.feature_counts.shape[1],
            profile.score_counts.shape[0],
            device=self.device,
        )
        self.rows_seen = 0  # monotonic (not decayed), host-side
        # a flush's fold is several in-place launches: a stats() reader (or
        # a concurrent flush) must not interleave its own launches between
        # them, so each holds this lock while it enqueues
        self._lock = threading.Lock()

    def _decay_for(self, n: int) -> float:
        """The forgetting factor for ``n`` live rows, rounded to float32
        (the value the reference's f32 device scalar holds)."""
        return float(np.float32(0.5 ** (n / self.halflife_rows)))

    def fused_flush(
        self,
        x: torch.Tensor,
        valid: torch.Tensor,
        n_live: int,
        score_args,
        score_fn,
        out_dtype=torch.float32,
        explain_args=None,
        explain_k: int = 0,
    ):
        """Score one staged, bucket-padded device batch AND fold it into the
        window; with ``explain_k > 0`` also the top-k reason codes. Returns
        the device score vector (return wire ``out_dtype``), or the
        ``(scores, reason_idx, reason_val)`` triple. Only enqueues device
        work: the caller's fetch is the flush's one host sync."""
        decay = self._decay_for(n_live)
        explain_k = min(int(explain_k), int(x.shape[1]))  # k ≥ d clamps to d
        with self._lock:
            if explain_k > 0 and explain_args is not None:
                out = _fused_flush_explain(
                    self.window, x, valid, decay, self._feature_edges,
                    self._score_edges, score_args, explain_args,
                    score_fn=score_fn, explain_k=explain_k,
                    out_dtype=out_dtype,
                )
            else:
                out = _fused_flush(
                    self.window, x, valid, decay, self._feature_edges,
                    self._score_edges, score_args, score_fn=score_fn,
                    out_dtype=out_dtype,
                )
            self.rows_seen += n_live
        return out

    def warm_fused(
        self, scorer, bucket: int, out_dtype=torch.float32, explain_k: int = 0
    ) -> None:
        """Run the fused flush once for ``bucket`` without touching the
        window: an all-padding batch (valid = 0) with decay 1.0 folds exact
        zeros into every histogram. Builds the kernel on first use and warms
        the allocator for the bucket's shapes."""
        spec = scorer.fused_spec()
        slot = scorer.staging.acquire(bucket)
        try:
            slot.f32[:] = 0.0
            slot.valid[:] = 0.0
            out = self.fused_flush(
                scorer.to_device(slot.f32), scorer.to_device(slot.valid), 0,
                spec.score_args, spec.score_fn, out_dtype=out_dtype,
                explain_args=spec.explain_args if explain_k else None,
                explain_k=explain_k,
            )
            for t in out if isinstance(out, tuple) else (out,):
                t.cpu()
        finally:
            scorer.staging.release(slot)

    def update(self, x, scores, labels=None, calibration_only=False) -> None:
        """Fold one scored batch in (the split path and feedback replays).
        ``calibration_only=True`` updates only the calibration state (the
        rows were already observed live)."""
        x = np.asarray(x, np.float32)
        if x.ndim == 1:
            x = x[None, :]
        scores = np.asarray(scores, np.float32).reshape(-1)
        n = x.shape[0]
        b = _bucket(n, self.min_bucket)
        if b != n:
            x = np.concatenate([x, np.zeros((b - n, x.shape[1]), np.float32)])
            scores = np.concatenate([scores, np.zeros(b - n, np.float32)])
        real = np.zeros(b, np.float32)
        real[:n] = 1.0
        valid = np.zeros(b, np.float32) if calibration_only else real
        lab = np.zeros(b, np.float32)
        if labels is None:
            lab_valid = np.zeros(b, np.float32)
        else:
            lab[:n] = np.asarray(labels, np.float32).reshape(-1)
            lab_valid = real
        n_live = 0 if calibration_only else n
        n_labeled = n if labels is not None else 0

        def dev(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(a).to(self.device)

        with self._lock:
            _window_update(
                self.window, dev(x), dev(scores), dev(lab), dev(lab_valid),
                dev(valid), self._decay_for(n_live), self._decay_for(n_labeled),
                self._feature_edges, self._score_edges, self._calib_edges,
            )
            if not calibration_only:
                self.rows_seen += n

    def stats(self) -> dict:
        """Host-synced snapshot (status/scrape time, never per batch)."""
        with self._lock:
            # a device-side copy in stream order: later folds cannot reach
            # it, so the sync below runs outside the lock
            window = DriftWindow(*(t.clone() for t in self.window.tensors()))
            rows_seen = self.rows_seen
        s = _drift_stats(window, self._base_fc, self._base_sc)
        feature_psi = s.feature_psi.double().cpu().numpy()
        feature_ks = s.feature_ks.double().cpu().numpy()
        order = np.argsort(feature_psi)[::-1][:5]
        top = [
            {
                "feature": self.profile.feature_names[i],
                "psi": round(float(feature_psi[i]), 5),
                "ks": round(float(feature_ks[i]), 5),
            }
            for i in order
        ]
        return {
            "window_rows": float(window.n_rows),
            "rows_seen": rows_seen,
            "feature_psi_max": float(feature_psi.max(initial=0.0)),
            "feature_ks_max": float(feature_ks.max(initial=0.0)),
            "score_psi": float(s.score_psi),
            "score_ks": float(s.score_ks),
            "ece": float(s.ece),
            "n_labeled": float(s.n_labeled),
            "top_features": top,
        }
