"""Shadow scoring: a challenger model rides a sample of live traffic.

The port's own copy of the JAX package's ``monitor/shadow.py``. The
challenger resolves from the registry alias ``models:/{name}@shadow``
(:func:`fraud_detection_tpu_torch.service.loading.load_shadow_model`). A
configurable fraction of scored batches is re-scored by the challenger —
always OFF the request path (the watchtower's single ingest thread), so a
slow or broken challenger can never add champion latency; at worst its
batches are dropped by the watchtower's backlog bound. The challenger
scores through its own ``predict_proba``: on a card the ``fused_score``
kernel (linear) or the forest's device predict, and its attributions
through ``explain_batch`` (``tree_shap`` for a forest).

Tracked, with the same exponential window semantics as :mod:`drift`:

- **decision disagreement**: fraction of rows where champion and challenger
  land on opposite sides of the alert threshold — the "would promotion
  change production behavior" number;
- **mean |Δscore|**: magnitude of the score gap;
- **challenger score PSI** against the baseline score histogram — per-model
  score drift, so the promotion recommendation can compare which model's
  output distribution still matches training.

A ledger-widened challenger sees the base-width monitor rows: it scores and
explains them through its null slot (``BatchScorer``'s null fold,
``FraudLogisticModel.explain_batch``), since the entity table lives in the
champion's flush.
"""

from __future__ import annotations

import logging

import numpy as np

from fraud_detection_tpu_torch import config
from fraud_detection_tpu_torch.monitor.baseline import BaselineProfile
from fraud_detection_tpu_torch.monitor.drift import psi_np

log = logging.getLogger("fraud_detection_tpu_torch.watchtower")


class ShadowScorer:
    def __init__(
        self,
        scorer,
        profile: BaselineProfile,
        sample_rate: float | None = None,
        threshold: float = 0.5,
        halflife_rows: float | None = None,
        seed: int = 0,
        explainer=None,
    ):
        self._scorer = scorer
        # the challenger's attributions (a callable phi(rows)): when present
        # AND the champion's serve-time top-k indices ride along with a
        # sampled batch, the window tracks reason-code divergence (mean
        # 1 − Jaccard over the index sets): how differently the challenger
        # would EXPLAIN the same traffic.
        self._explainer = explainer
        self.sample_rate = float(
            sample_rate
            if sample_rate is not None
            else config.watchtower_shadow_sample()
        )
        self.threshold = threshold
        self.halflife_rows = float(
            halflife_rows
            if halflife_rows is not None
            else config.watchtower_halflife_rows()
        )
        self._rng = np.random.default_rng(seed)
        self._score_edges = np.asarray(profile.score_edges, np.float64)
        self._base_counts = np.asarray(profile.score_counts, np.float64)
        self._score_counts = np.zeros_like(self._base_counts)
        self._rows = 0.0  # decayed
        self._disagree = 0.0  # decayed
        self._delta = 0.0  # decayed
        self._reason_rows = 0.0  # decayed rows with reason comparisons
        self._reason_div = 0.0  # decayed Σ (1 − Jaccard)
        self.batches_seen = 0
        self.batches_sampled = 0

    def maybe_observe(
        self,
        rows: np.ndarray,
        champion_scores: np.ndarray,
        champion_reasons=None,
    ) -> bool:
        """Sample-and-score one batch; returns True when the challenger ran.
        Called from the watchtower ingest thread, never the request path.
        ``champion_reasons`` is the (n, k) matrix of serve-time top-k
        reason-code indices when the fused explain leg rode the flush."""
        self.batches_seen += 1
        if self._rng.random() >= self.sample_rate:
            return False
        ch = np.asarray(
            self._scorer.predict_proba(np.asarray(rows, np.float32)),
            np.float64,
        ).reshape(-1)
        champ = np.asarray(champion_scores, np.float64).reshape(-1)
        n = ch.shape[0]
        # A sampled batch of n rows stands in for ~n/sample_rate rows of
        # live traffic, so fade in live-row terms — the halflife knob means
        # the same amount of traffic here as on the (full-rate) drift window.
        decay = 0.5 ** (n / (self.halflife_rows * min(self.sample_rate, 1.0)))
        self._rows = self._rows * decay + n
        self._disagree = self._disagree * decay + float(
            np.sum((ch >= self.threshold) != (champ >= self.threshold))
        )
        self._delta = self._delta * decay + float(np.sum(np.abs(ch - champ)))
        # side='right' keeps the bin convention identical to the jitted
        # histograms (index = #edges <= x) so boundary ties land the same
        hist = np.bincount(
            np.searchsorted(self._score_edges, ch, side="right"),
            minlength=self._base_counts.shape[0],
        ).astype(np.float64)
        self._score_counts = self._score_counts * decay + hist
        if champion_reasons is not None and self._explainer is not None:
            champ_idx = np.asarray(champion_reasons)
            k = champ_idx.shape[1] if champ_idx.ndim == 2 else 0
            if k > 0 and champ_idx.shape[0] == n:
                phi = self._challenger_phi(rows, n)
                if phi is not None:
                    self._fold_reasons(phi, champ_idx, k, n, decay)
        self.batches_sampled += 1
        return True

    def _challenger_phi(self, rows, n: int):
        """The challenger's per-row attribution matrix for one sampled
        batch, or None when it cannot be produced (the comparison is then
        skipped, never the sample). ``explainer`` is the challenger's
        ``phi(rows)`` callable, family-agnostic: linear SHAP, or the
        forest's TreeSHAP, run on the watchtower ingest thread like the
        challenger re-score itself, never the request path."""
        try:
            phi = np.asarray(self._explainer(rows), np.float64)
        except Exception:
            log.debug("challenger phi failed", exc_info=True)
            return None
        return phi if phi.ndim == 2 and phi.shape[0] == n else None

    def _fold_reasons(self, phi, champ_idx, k, n, decay) -> None:
        """Fold one sampled batch's reason-code comparison into the decayed
        divergence window (mean 1 − Jaccard over the top-k index sets)."""
        # the challenger's top-k by signed attribution; argsort is stable,
        # so ties resolve toward the lower index as the JAX package's do
        k = min(k, phi.shape[1])
        ch_idx = np.argsort(-phi, axis=1, kind="stable")[:, :k]
        inter = np.asarray(
            [
                len(set(a.tolist()) & set(b.tolist()))
                for a, b in zip(champ_idx, ch_idx)
            ],
            np.float64,
        )
        denom = np.maximum(champ_idx.shape[1] + k - inter, 1.0)
        jaccard = inter / denom
        self._reason_rows = self._reason_rows * decay + n
        self._reason_div = self._reason_div * decay + float(
            np.sum(1.0 - jaccard)
        )

    def stats(self) -> dict:
        rows = max(self._rows, 1e-9)
        return {
            "sample_rate": self.sample_rate,
            "batches_seen": self.batches_seen,
            "batches_sampled": self.batches_sampled,
            "window_rows": self._rows,
            "disagreement": self._disagree / rows,
            "mean_abs_delta": self._delta / rows,
            "score_psi": psi_np(self._score_counts, self._base_counts),
            "reason_divergence": (
                self._reason_div / self._reason_rows
                if self._reason_rows > 0
                else None
            ),
        }
