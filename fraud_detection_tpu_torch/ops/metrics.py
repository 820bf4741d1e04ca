"""Classification metrics. ``auc_roc`` is the exact AUC-ROC by the weighted
Mann–Whitney statistic: one global sort and two ``searchsorted`` passes, as
the JAX package computes it. The confusion matrix and report belong to the
``evaluate.py`` slice."""

from __future__ import annotations

import numpy as np
import torch


def _auc_weighted(
    scores: torch.Tensor, labels: torch.Tensor, weights: torch.Tensor
) -> torch.Tensor:
    """For each positive, the weight of negatives strictly below it plus
    half the weight of tied negatives (ties handled like
    ``sklearn.roc_auc_score``)."""
    is_pos = (labels > 0).to(scores.dtype)
    pos = is_pos * weights
    neg = (1.0 - is_pos) * weights
    order = torch.argsort(scores, stable=True)
    s_sorted = scores[order]
    cum_neg = torch.cat(
        [torch.zeros(1, dtype=scores.dtype, device=scores.device),
         torch.cumsum(neg[order], dim=0)]
    )
    lo = torch.searchsorted(s_sorted, scores, side="left")
    hi = torch.searchsorted(s_sorted, scores, side="right")
    neg_below = cum_neg[lo]
    neg_tied = cum_neg[hi] - cum_neg[lo]
    u = torch.sum(pos * (neg_below + 0.5 * neg_tied))
    return u / (torch.sum(pos) * torch.sum(neg))


def auc_roc(scores, labels, n_valid: int | None = None) -> torch.Tensor:
    """Exact AUC-ROC as a 0-d float32 tensor on the scores' device.

    ``scores`` and ``labels`` are tensors or arrays (arrays go to the
    scores' device, the CPU for two arrays). ``n_valid`` masks out padded
    rows. Raises ``ValueError`` when only one class is present: the
    statistic is 0/0 there, and a NaN would pass silently into the gate."""
    s = scores if isinstance(scores, torch.Tensor) else torch.as_tensor(
        np.asarray(scores, np.float32)
    )
    s = s.float().reshape(-1)
    labels_np = (
        labels.detach().cpu().numpy() if isinstance(labels, torch.Tensor)
        else np.asarray(labels)
    ).reshape(-1)
    n = s.shape[0]
    valid = labels_np[: n_valid if n_valid is not None else n]
    if (valid > 0).all() or (valid <= 0).all():
        raise ValueError("auc_roc is undefined when only one class is present")
    lab = torch.as_tensor(labels_np, device=s.device)
    if n_valid is None:
        weights = torch.ones(n, dtype=s.dtype, device=s.device)
    else:
        weights = (torch.arange(n, device=s.device) < n_valid).to(s.dtype)
    return _auc_weighted(s, lab, weights)
