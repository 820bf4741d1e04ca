"""Train-time baseline profile: the reference distribution drift is judged
against, saved as ``monitor_profile.npz`` beside ``model.npz`` in the JAX
package's layout (either package reads the other's).

- **per-feature histograms** over equiprobable (training-quantile) edges;
- **score histogram** over uniform [0, 1] edges plus tail quantiles of the
  score distribution.

The histogram functions are shared with the online accumulators in
:mod:`.drift`, so baseline and window counts never disagree on binning.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from fraud_detection_tpu_torch.device import resolve_device
from fraud_detection_tpu_torch.parallel.sharding import split_segments

PROFILE_FILE = "monitor_profile.npz"

N_FEATURE_BINS = 16
N_SCORE_BINS = 20
SCORE_QUANTILES = (0.5, 0.9, 0.95, 0.99, 0.999)

#: rows per chunk of the baseline reduction — bounds the (chunk, d, bins)
#: one-hot intermediate
PROFILE_CHUNK = 1 << 16


@dataclass(frozen=True)
class BaselineProfile:
    feature_edges: np.ndarray  # (d, n_bins - 1) interior edges, sorted
    feature_counts: np.ndarray  # (d, n_bins)
    score_edges: np.ndarray  # (s_bins - 1,) interior edges on [0, 1]
    score_counts: np.ndarray  # (s_bins,)
    score_quantiles: np.ndarray  # (len(SCORE_QUANTILES),)
    n_rows: int
    feature_names: tuple[str, ...]

    @property
    def n_features(self) -> int:
        return int(self.feature_edges.shape[0])


def _segment_sum(t: torch.Tensor, segments: int | None, **kw) -> torch.Tensor:
    """Sum over the row axis, or, with ``segments``, over each of that many
    equal row segments (the serving mesh's shards) → a leading shard axis."""
    if segments is None:
        return t.sum(dim=0, **kw)
    return split_segments(t, segments).sum(dim=1, **kw)


def feature_histogram(
    x: torch.Tensor, edges: torch.Tensor, weights: torch.Tensor | None = None,
    segments: int | None = None,
) -> torch.Tensor:
    """Per-feature weighted histogram: ``x`` (n, d) against ``edges``
    (d, n_edges) → (d, n_edges + 1) f32 counts. Bin index = number of edges
    ≤ x (``searchsorted side='right'``). A dense one-hot reduction, as in
    the reference: with 0/1 weights every count is an exact integer, so the
    summation order cannot change it — nor a split of the rows into
    ``segments`` equal segments, each counted apart → (segments, d,
    n_edges + 1)."""
    n_edges = edges.shape[1]
    idx = (x[:, :, None] >= edges[None, :, :]).sum(dim=-1)  # (n, d)
    bins = torch.arange(n_edges + 1, device=x.device)
    onehot = idx[:, :, None] == bins[None, None, :]
    if weights is None:
        return _segment_sum(onehot, segments, dtype=torch.float32)
    return _segment_sum(onehot * weights.float()[:, None, None], segments)


def score_histogram(
    scores: torch.Tensor, edges: torch.Tensor, weights: torch.Tensor | None = None,
    segments: int | None = None,
) -> torch.Tensor:
    """Weighted histogram of ``scores`` (n,) against interior ``edges``
    (n_edges,) → (n_edges + 1,) counts; same convention (``segments``
    included) as :func:`feature_histogram`."""
    idx = (scores[:, None] >= edges[None, :]).sum(dim=-1)  # (n,)
    bins = torch.arange(edges.shape[0] + 1, device=scores.device)
    onehot = idx[:, None] == bins[None, :]
    if weights is None:
        return _segment_sum(onehot, segments, dtype=torch.float32)
    return _segment_sum(onehot * weights.float()[:, None], segments)


def build_baseline_profile(
    x,
    scores,
    feature_names: list[str] | None = None,
    n_bins: int = N_FEATURE_BINS,
    n_score_bins: int = N_SCORE_BINS,
    device: str | torch.device | None = None,
) -> BaselineProfile:
    """Profile training features ``x`` (n, d) + model ``scores`` (m,)."""
    dev = resolve_device(device)
    xt = torch.as_tensor(np.asarray(x, np.float32), device=dev)
    st = torch.as_tensor(np.asarray(scores, np.float32).reshape(-1), device=dev)
    qs = torch.arange(1, n_bins, dtype=torch.float32, device=dev) / n_bins
    feature_edges = torch.quantile(xt, qs, dim=0).T.contiguous()
    score_edges = torch.as_tensor(
        np.linspace(0.0, 1.0, n_score_bins + 1)[1:-1], dtype=torch.float32,
        device=dev,
    )
    n, d = xt.shape
    m = st.shape[0]
    feature_counts = torch.zeros((d, n_bins), dtype=torch.float32, device=dev)
    score_counts = torch.zeros((n_score_bins,), dtype=torch.float32, device=dev)
    for lo in range(0, max(n, m), PROFILE_CHUNK):
        if lo < n:
            feature_counts += feature_histogram(
                xt[lo:lo + PROFILE_CHUNK], feature_edges
            )
        if lo < m:
            score_counts += score_histogram(
                st[lo:lo + PROFILE_CHUNK], score_edges
            )
    quantiles = torch.quantile(
        st, torch.tensor(SCORE_QUANTILES, dtype=torch.float32, device=dev)
    )
    names = tuple(feature_names) if feature_names else tuple(
        f"f{i}" for i in range(d)
    )
    return BaselineProfile(
        feature_edges=feature_edges.cpu().numpy(),
        feature_counts=feature_counts.cpu().numpy(),
        score_edges=score_edges.cpu().numpy(),
        score_counts=score_counts.cpu().numpy(),
        score_quantiles=quantiles.cpu().numpy(),
        n_rows=n,
        feature_names=names,
    )


def save_profile(directory: str, profile: BaselineProfile) -> str:
    """Write ``monitor_profile.npz`` beside the model artifacts."""
    from fraud_detection_tpu_torch.ckpt.atomic import atomic_savez

    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, PROFILE_FILE)
    atomic_savez(
        path,
        feature_edges=profile.feature_edges,
        feature_counts=profile.feature_counts,
        score_edges=profile.score_edges,
        score_counts=profile.score_counts,
        score_quantiles=profile.score_quantiles,
        n_rows=np.int64(profile.n_rows),
        feature_names=np.asarray(profile.feature_names),
    )
    return path


def load_profile(directory: str) -> BaselineProfile | None:
    """The profile of an artifact directory; None when absent (serving then
    runs unmonitored rather than failing the model load)."""
    path = os.path.join(directory, PROFILE_FILE)
    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=False) as z:
        return BaselineProfile(
            feature_edges=np.asarray(z["feature_edges"], np.float32),
            feature_counts=np.asarray(z["feature_counts"], np.float32),
            score_edges=np.asarray(z["score_edges"], np.float32),
            score_counts=np.asarray(z["score_counts"], np.float32),
            score_quantiles=np.asarray(z["score_quantiles"], np.float32),
            n_rows=int(z["n_rows"]),
            feature_names=tuple(str(n) for n in z["feature_names"]),
        )
