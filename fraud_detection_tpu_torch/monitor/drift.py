"""Online drift accumulators: the device-resident decayed window.

On the serving path the drift fold rides the flush itself:
:func:`_fused_flush` / :func:`_fused_flush_explain` score the staged batch
through the scorer's score body (the ``fused_score`` kernel or the forest
on the card), optionally take the per-row top-k SHAP reason codes (linear
SHAP, or TreeSHAP through the ``tree_shap`` kernel), and fold the
batch into the window — all enqueued on the device stream, with no host
sync; the caller's one device-to-host copy of the outputs is the only one.
On the int8 wire both flushes take the codes: ``xf = codes · dequant_scale``
is the one multiply that the histograms bin, the explain leg attributes
and, for the forest, the score reads. On the bf16 wire they bin the
bf16-rounded values, the values the model scored.
With a ledger bound (a widened family), :func:`_fused_flush_ledger` runs
instead: it reads and updates the per-entity table on the device, widens
the batch with the K velocity features and scores, explains and folds the
widened rows. With the wide family's ``(CrossSpec, table)`` given,
:func:`_fused_flush_wide` runs: it hashes each row's entity crosses,
gathers their learned contributions from the table and scores, explains
and folds the widened rows.
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

import logging
import threading
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from fraud_detection_tpu_torch import config
from fraud_detection_tpu_torch.device import resolve_device
from fraud_detection_tpu_torch.ledger.features import _ledger_read_update, ledger_stats
from fraud_detection_tpu_torch.ledger.state import LedgerState, device_state
from fraud_detection_tpu_torch.monitor.baseline import (
    BaselineProfile,
    feature_histogram,
    score_histogram,
)
from fraud_detection_tpu_torch.ops.crosses import _gather_contrib, _raw_cross_indices
from fraud_detection_tpu_torch.ops.linear_shap import _raw_linear_shap, topk_reasons
from fraud_detection_tpu_torch.ops.scorer import _bucket, _cast_scores, _raw_score_linear
from fraud_detection_tpu_torch.ops.tree_shap import TreeShapExplainer, _raw_tree_shap

PSI_EPS = 1e-4
N_CALIB_BINS = 10


#: the window's fields in the order of the reference's ``DriftWindow``
#: NamedTuple: the order of :meth:`DriftWindow.tensors` and of a lifeboat
#: snapshot's ``win_*`` arrays
WINDOW_FIELDS = (
    "feature_counts", "score_counts", "calib_count", "calib_conf",
    "calib_label", "n_rows",
)


@dataclass(frozen=True)
class DriftWindow:
    """Decayed window state — preallocated device tensors, updated in
    place by every fold (the counterpart of the reference's donated
    buffers). A snapshot's copy holds numpy arrays in the same fields."""

    feature_counts: torch.Tensor  # (d, n_bins)
    score_counts: torch.Tensor  # (s_bins,)
    calib_count: torch.Tensor  # (c_bins,) labeled rows per score bin
    calib_conf: torch.Tensor  # (c_bins,) Σ score over labeled rows
    calib_label: torch.Tensor  # (c_bins,) Σ label over labeled rows
    n_rows: torch.Tensor  # () decayed row count

    def tensors(self) -> tuple[torch.Tensor, ...]:
        return tuple(getattr(self, name) for name in WINDOW_FIELDS)


def _window_leaves(window) -> tuple:
    """The six leaves of a window in :data:`WINDOW_FIELDS` order: this
    package's :class:`DriftWindow` or any sequence in that order (the
    reference's NamedTuple)."""
    return window.tensors() if isinstance(window, DriftWindow) else tuple(window)


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


def _flush_inputs(
    x: torch.Tensor, dequant_scale: torch.Tensor | None, score_codes: bool
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(what the score reads, xf)``: ``xf`` is the f32 batch the
    histograms bin and the explain leg attributes. Without
    ``dequant_scale`` the score reads the staged rows as they are (f32 or
    bf16). On the int8 wire ``xf = codes · dequant_scale``, the one
    multiply the histograms and (``score_codes=False``, the forest) the
    score share; with ``score_codes`` the score reads the codes upcast
    once, the scale being folded into its weights."""
    if dequant_scale is None:
        return x, x.float()
    codes = x.float()  # exact: the codes are small integers
    xf = codes * dequant_scale
    return (codes if score_codes else xf), xf


def _fused_flush(
    window: DriftWindow,
    x: torch.Tensor,  # (b, d) staged batch on the device (f32, bf16 or int8 codes)
    valid: torch.Tensor,  # (b,) 1.0 for real rows, 0.0 for bucket padding
    decay: float,  # drift forgetting factor (live rows this batch)
    feature_edges: torch.Tensor,
    score_edges: torch.Tensor,
    score_args,
    *,
    score_fn,
    dequant_scale: torch.Tensor | None = None,  # (d,) on the int8 wire
    score_codes: bool = True,  # score_fn takes the codes (True) or xf
    out_dtype=torch.float32,
) -> torch.Tensor:
    """Scores **and** the drift-window fold for one staged batch; returns
    the score vector in the ``out_dtype`` return wire."""
    xs, xf = _flush_inputs(x, dequant_scale, score_codes)
    scores = score_fn(score_args, xs).float()
    _fold_serving_batch(
        window, xf, scores, valid, decay, feature_edges, score_edges
    )
    return _cast_scores(scores, out_dtype)


def _fused_flush_explain(
    window: DriftWindow,
    x: torch.Tensor,
    valid: torch.Tensor,
    decay: float,
    feature_edges: torch.Tensor,
    score_edges: torch.Tensor,
    score_args,
    explain_args,  # raw-space linear-SHAP (coef, background_mean) or a TreeShapExplainer
    *,
    score_fn,
    explain_k: int,  # reason codes per row (pre-clamped to d)
    dequant_scale: torch.Tensor | None = None,
    score_codes: bool = True,
    out_dtype=torch.float32,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Scores, per-row top-k reason codes AND the drift fold; returns
    ``(scores, reason_idx, reason_val)``. The reason codes attribute the
    ``xf`` the histograms bin, and the window fold is the one
    :func:`_fused_flush` runs, so enabling explanations cannot move
    monitoring state."""
    xs, xf = _flush_inputs(x, dequant_scale, score_codes)
    scores = score_fn(score_args, xs).float()
    idx, val = _topk_attributions(xf, explain_args, explain_k)
    idx, val = _narrow_reasons(idx, val, x.shape[1], out_dtype)
    _fold_serving_batch(
        window, xf, scores, valid, decay, feature_edges, score_edges
    )
    return _cast_scores(scores, out_dtype), idx, val


def _fused_flush_ledger(
    window: DriftWindow,
    ledger,  # ledger.LedgerState on the device, updated in place
    x: torch.Tensor,  # (b, d_base) staged batch (f32, bf16 or int8 codes)
    valid: torch.Tensor,  # (b,) 1.0 for real rows, 0.0 for bucket padding
    decay: float,
    feature_edges: torch.Tensor,  # (d_base + K, bins - 1): the widened edges
    score_edges: torch.Tensor,
    score_args,  # raw-space (coef, intercept) over the widened block
    ledger_rows,  # (slot_idx, fp, ts, has_entity) device columns, (b,) each
    null_features: torch.Tensor,  # (K,) features of entity-less rows
    halflife_s: torch.Tensor,  # () f32 decay half-life
    *,
    score_fn,
    dequant_scale: torch.Tensor | None = None,  # (d_base,) on the int8 wire
    explain_args=None,  # raw-space (coef, background_mean) over d_base + K
    explain_k: int = 0,  # reason codes per row (0: no explain leg)
    amount_col: int = -1,  # the Amount column of the base row
    out_dtype=torch.float32,
):
    """The ledger flush (the JAX package's ``_fused_flush_ledger`` and its
    ``_ledger_serving_body``, one function here): the one widening sequence
    for every wire and both explain settings — dequant (int8 wire) → the
    amount column → the
    ledger read-update (``ledger/features._ledger_read_update``, the body
    the training replay runs) → concat → score through ``score_fn`` (the
    ``fused_score`` kernel at d_base + K on the card) → the optional top-k
    reason codes over the widened columns → the drift fold over the
    widened edges. Entity-less and padding rows read the null features and
    leave the table bitwise unchanged. Returns the scores (return wire
    ``out_dtype``), or ``(scores, reason_idx, reason_val)`` with the
    explain leg."""
    xb = x.float()
    if dequant_scale is not None:
        xb = xb * dequant_scale
    slot_idx, fp, ts, has_entity = ledger_rows
    feats = _ledger_read_update(
        ledger, slot_idx, fp, ts, xb[:, amount_col], has_entity,
        null_features, halflife_s,
    )
    xf = torch.cat([xb, feats], dim=1)
    scores = score_fn(score_args, xf).float()
    out = _cast_scores(scores, out_dtype)
    if explain_k > 0:
        idx, val = _topk_attributions(xf, explain_args, explain_k)
        out = (out, *_narrow_reasons(idx, val, xf.shape[1], out_dtype))
    _fold_serving_batch(
        window, xf, scores, valid, decay, feature_edges, score_edges
    )
    return out


def _fused_flush_wide(
    window: DriftWindow,
    x: torch.Tensor,  # (b, n_base) staged batch (f32, bf16 or int8 codes)
    valid: torch.Tensor,  # (b,) 1.0 for real rows, 0.0 for bucket padding
    decay: float,
    feature_edges: torch.Tensor,  # (n_base + n_cross, bins - 1): the widened edges
    score_edges: torch.Tensor,
    score_args,  # raw-space (coef, intercept) over the widened block
    wide_table: torch.Tensor,  # (buckets,) the learned cross weights
    wide_rows,  # (fp, has_entity) device columns, (b,) each
    *,
    cross_spec,
    dequant_scale: torch.Tensor | None = None,  # (n_base,) on the int8 wire
    explain_args=None,  # raw-space (coef, background_mean) over the widened block
    explain_k: int = 0,  # reason codes per row (0: no explain leg)
    out_dtype=torch.float32,
):
    """The wide flush (the JAX package's single-device ``_fused_flush_wide``
    and its ``_wide_serving_body``, one function here): dequant (int8 wire)
    → the hashed cross indices (``ops/crosses._raw_cross_indices``) → the
    table gather, zeroed for entity-less rows → concat → score through the
    linear body (the ``fused_score`` kernel at n_base + n_cross on the
    card) → the optional top-k reason codes over the widened columns → the
    drift fold over the widened edges. The table is only read. Entity-less
    rows score base-only, and an all-padding batch folds exact zeros.
    Returns the scores (return wire ``out_dtype``), or ``(scores,
    reason_idx, reason_val)`` with the explain leg."""
    xb = x.float()
    if dequant_scale is not None:
        xb = xb * dequant_scale
    fp, has_entity = wide_rows
    idx = _raw_cross_indices(xb, fp, spec=cross_spec)
    xf = torch.cat([xb, _gather_contrib(wide_table, idx, has_entity)], dim=1)
    scores = _raw_score_linear(score_args, xf).float()
    out = _cast_scores(scores, out_dtype)
    if explain_k > 0:
        ridx, rval = _topk_attributions(xf, explain_args, explain_k)
        out = (out, *_narrow_reasons(ridx, rval, xf.shape[1], out_dtype))
    _fold_serving_batch(
        window, xf, scores, valid, decay, feature_edges, score_edges
    )
    return out


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


def psi_np(p_counts: np.ndarray, q_counts: np.ndarray) -> float:
    """Numpy PSI with the same smoothing, in float64 — for host-side
    consumers (the shadow scorer's challenger histogram)."""
    p_counts = np.asarray(p_counts, np.float64)
    q_counts = np.asarray(q_counts, np.float64)
    n_bins = p_counts.shape[-1]
    p = (p_counts + PSI_EPS) / (p_counts.sum() + PSI_EPS * n_bins)
    q = (q_counts + PSI_EPS) / (q_counts.sum() + PSI_EPS * n_bins)
    return float(np.sum((p - q) * np.log(p / q)))


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
        # the ledger's per-entity table, bound when the served model is
        # widened: updated in place by the ledger flush, under the same lock
        self.ledger: LedgerState | None = None
        self.ledger_spec = None
        self._ledger_null: torch.Tensor | None = None
        self._ledger_halflife: torch.Tensor | None = None
        # a flush's fold is several in-place launches: a stats() reader (or
        # a concurrent flush) must not interleave its own launches between
        # them, so each holds this lock while it enqueues
        self._lock = threading.Lock()

    def _decay_for(self, n: int) -> float:
        """The forgetting factor for ``n`` live rows, rounded to float32
        (the value the reference's f32 device scalar holds)."""
        return float(np.float32(0.5 ** (n / self.halflife_rows)))

    # -- the ledger: the per-entity velocity table ------------------------
    def bind_ledger(self, spec, state=None) -> None:
        """Attach the ledger table: flushes given ``ledger_rows`` then run
        the widened :func:`_fused_flush_ledger`. ``state`` is a host
        snapshot (``ledger_state.npz``) or None for a fresh table."""
        with self._lock:
            self.ledger_spec = spec
            self.ledger = device_state(state, spec.slots, self.device)
            self._ledger_null = torch.tensor(
                spec.null_features, dtype=torch.float32, device=self.device
            )
            self._ledger_halflife = torch.tensor(
                spec.halflife_s, dtype=torch.float32, device=self.device
            )

    def ledger_snapshot(self) -> LedgerState | None:
        """A copy of the live table on the monitor's device (the fingerprint
        int64; ``ledger.state.host_state`` gives the file's dtypes); None
        when no ledger is bound. The clone is enqueued under the lock in
        stream order, so later flushes cannot reach it; the caller's
        device-to-host copy, if any, runs outside the lock."""
        with self._lock:
            if self.ledger is None:
                return None
            return LedgerState(*(t.clone() for t in self.ledger))

    # -- the lifeboat: the window's snapshot and restore -------------------
    def window_snapshot(self) -> DriftWindow:
        """A copy of the live window on the monitor's device (the lifeboat
        snapshot's input), enqueued under the lock like
        :meth:`ledger_snapshot`'s."""
        with self._lock:
            return DriftWindow(*(t.clone() for t in self.window.tensors()))

    def shard_window_snapshot(self) -> DriftWindow | None:
        """The per-shard windows: None, there is no mesh on the port yet."""
        return None

    def restore_window(self, window, shard_window=None, rows_seen=None) -> bool:
        """Copy a snapshotted window into the live tensors (warm restart).
        The shapes must be the live window's; a window of another geometry
        (another baseline profile) is skipped with a WARNING, and
        ``rows_seen`` then stays as it is."""
        with self._lock:
            ok = self._restore_windows_locked(window, shard_window)
            if ok and rows_seen is not None:
                self.rows_seen = int(rows_seen)
        return ok

    def _restore_windows_locked(self, window, shard_window) -> bool:
        leaves = _window_leaves(window)
        cur = self.window.tensors()
        shapes = tuple(tuple(leaf.shape) for leaf in leaves)
        want = tuple(tuple(t.shape) for t in cur)
        if shapes != want:
            logging.getLogger("fraud_detection_tpu_torch.lifeboat").warning(
                "drift window restore skipped: snapshot shapes %s != live "
                "%s (profile geometry changed since the snapshot)",
                shapes, want,
            )
            return False
        for t, leaf in zip(cur, leaves):
            t.copy_(torch.as_tensor(leaf, dtype=torch.float32))
        return True

    def ledger_stats(self) -> dict | None:
        """Scrape-time table telemetry (occupancy, collisions, evictions);
        None when no ledger is bound."""
        with self._lock:
            if self.ledger is None:
                return None
            table = LedgerState(*(t.clone() for t in self.ledger))
            halflife = self.ledger_spec.halflife_s
        return ledger_stats(table, halflife)

    def fused_flush(
        self,
        x: torch.Tensor,
        valid: torch.Tensor,
        n_live: int,
        score_args,
        score_fn,
        dequant_scale=None,
        score_codes: bool = True,
        out_dtype=torch.float32,
        explain_args=None,
        explain_k: int = 0,
        ledger_rows=None,
        wide_args=None,
        wide_rows=None,
    ):
        """Score one staged, bucket-padded device batch AND fold it into the
        window; with ``explain_k > 0`` also the top-k reason codes. With
        ``dequant_scale`` (the int8 wire) ``x`` holds codes that the flush
        dequantizes. With ``wide_args`` (the scorer's ``(CrossSpec,
        table)``) and ``wide_rows`` (the ``(fp, has_entity)`` device
        columns) it is the widened :func:`_fused_flush_wide`; else, with a
        ledger bound and ``ledger_rows`` (the ``(slot_idx, fp, ts,
        has_entity)`` device columns), the widened
        :func:`_fused_flush_ledger`, which also updates the table. Returns
        the device score vector (return wire ``out_dtype``), or the
        ``(scores, reason_idx, reason_val)`` triple. Only enqueues device
        work: the caller's fetch is the flush's one host sync."""
        decay = self._decay_for(n_live)
        if wide_args is not None and wide_rows is not None:
            cross_spec, wide_table = wide_args
            # k clamps against the widened width the explain leg attributes
            k = (min(int(explain_k), int(x.shape[1]) + cross_spec.n_cross)
                 if explain_args is not None else 0)
            with self._lock:
                out = _fused_flush_wide(
                    self.window, x, valid, decay, self._feature_edges,
                    self._score_edges, score_args, wide_table, wide_rows,
                    cross_spec=cross_spec, dequant_scale=dequant_scale,
                    explain_args=explain_args, explain_k=k, out_dtype=out_dtype,
                )
                self.rows_seen += n_live
            return out
        if ledger_rows is not None and self.ledger is not None:
            spec = self.ledger_spec
            # k clamps against the widened width the explain leg attributes
            k = min(int(explain_k), spec.n_features) if explain_args is not None else 0
            with self._lock:
                out = _fused_flush_ledger(
                    self.window, self.ledger, x, valid, decay,
                    self._feature_edges, self._score_edges, score_args,
                    ledger_rows, self._ledger_null, self._ledger_halflife,
                    score_fn=score_fn, dequant_scale=dequant_scale,
                    explain_args=explain_args, explain_k=k,
                    amount_col=spec.amount_col, out_dtype=out_dtype,
                )
                self.rows_seen += n_live
            return out
        explain_k = min(int(explain_k), int(x.shape[1]))  # k ≥ d clamps to d
        fixed = (self.window, x, valid, decay, self._feature_edges,
                 self._score_edges, score_args)
        quant = dict(dequant_scale=dequant_scale, score_codes=score_codes)
        with self._lock:
            if explain_k > 0 and explain_args is not None:
                out = _fused_flush_explain(
                    *fixed, explain_args, score_fn=score_fn,
                    explain_k=explain_k, **quant, out_dtype=out_dtype,
                )
            else:
                out = _fused_flush(*fixed, score_fn=score_fn, **quant,
                                   out_dtype=out_dtype)
            self.rows_seen += n_live
        return out

    def warm_fused(
        self, scorer, bucket: int, out_dtype=torch.float32, explain_k: int = 0
    ) -> None:
        """Run the fused flush once for ``bucket`` without touching the
        window: an all-padding batch (valid = 0) with decay 1.0 folds exact
        zeros into every histogram. It stages through the scorer's wire
        encode and takes the scorer's fused spec (dequant scale included),
        so it runs what serving runs: it builds the kernel on first use and
        warms the allocator for the bucket's shapes. With a ledger bound it
        runs the ledger flush, whose all-padding rows leave the table
        bitwise unchanged; for the wide family the wide flush, with
        fingerprint 0 (a zero cross block) on every row."""
        spec = scorer.fused_spec()
        slot = scorer.staging.acquire(bucket)
        try:
            slot.f32[:] = 0.0
            hx = scorer._encode_slot(slot)
            slot.valid[:] = 0.0
            ledger_rows = wide_rows = None
            if spec.wide is not None:
                slot.ensure_ledger()
                slot.lf[:] = 0
                slot.lh[:] = 0.0
                wide_rows = (scorer.to_device(slot.lf), scorer.to_device(slot.lh))
            if self.ledger is not None and spec.ledger is not None:
                # has_entity 0 everywhere: the table is bitwise unchanged
                slot.ensure_ledger()
                cols = (slot.ls, slot.lf, slot.lt, slot.lh)
                for c in cols:
                    c[:] = 0
                ledger_rows = tuple(scorer.to_device(c) for c in cols)
            out = self.fused_flush(
                scorer.to_device(hx), scorer.to_device(slot.valid), 0,
                spec.score_args, spec.score_fn,
                dequant_scale=spec.dequant_scale, score_codes=spec.score_codes,
                out_dtype=out_dtype,
                explain_args=spec.explain_args if explain_k else None,
                explain_k=explain_k,
                ledger_rows=ledger_rows,
                wide_args=spec.wide,
                wide_rows=wide_rows,
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
        if self.ledger_spec is not None:
            # base-width rows into a widened window (the split path,
            # feedback): the null features, as the null slot scores them
            x = self.ledger_spec.widen(x)
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
