"""Classification metrics on the inputs' device. ``auc_roc`` is the exact
AUC-ROC by the weighted Mann–Whitney statistic: one global sort and two
``searchsorted`` passes, as the JAX package computes it. The confusion
matrix, the classification report and the ROC points serve ``evaluate``."""

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


def _as_tensor(a, device=None) -> torch.Tensor:
    """A tensor on ``device`` (default: where ``a`` lies, the CPU for an
    array)."""
    t = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
    return t if device is None else t.to(device)


def _row_weights(n: int, n_valid: int | None, device) -> torch.Tensor:
    """1 for the first ``n_valid`` rows (all when None), 0 for padding."""
    if n_valid is None:
        return torch.ones(n, dtype=torch.float32, device=device)
    return (torch.arange(n, device=device) < n_valid).float()


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
    return _auc_weighted(s, lab, _row_weights(n, n_valid, s.device))


def confusion_matrix(labels, pred, n_valid: int | None = None) -> torch.Tensor:
    """2x2 float32 confusion matrix ``[[tn, fp], [fn, tp]]`` (sklearn's
    layout) on ``pred``'s device. ``pred`` is boolean or is read as
    ``pred > 0``; ``n_valid`` masks out padded rows."""
    p = _as_tensor(pred).reshape(-1)
    if p.dtype != torch.bool:
        p = p > 0
    p = p.float()
    lab = (_as_tensor(labels, p.device).reshape(-1) > 0).float()
    w = _row_weights(p.shape[0], n_valid, p.device)
    tp = torch.sum(w * p * lab)
    fp = torch.sum(w * p * (1.0 - lab))
    fn = torch.sum(w * (1.0 - p) * lab)
    tn = torch.sum(w * (1.0 - p) * (1.0 - lab))
    return torch.stack([torch.stack([tn, fp]), torch.stack([fn, tp])])


def binary_classification_report(labels, pred, n_valid: int | None = None) -> dict:
    """Per-class precision/recall/F1/support, accuracy and the macro and
    weighted averages, shaped like ``sklearn.metrics.classification_report(
    output_dict=True)``."""
    cm = confusion_matrix(labels, pred, n_valid).cpu().numpy()
    tn, fp = cm[0]
    fn, tp = cm[1]

    def prf(tp_, fp_, fn_):
        prec = tp_ / (tp_ + fp_) if (tp_ + fp_) > 0 else 0.0
        rec = tp_ / (tp_ + fn_) if (tp_ + fn_) > 0 else 0.0
        f1 = 2 * prec * rec / (prec + rec) if (prec + rec) > 0 else 0.0
        return prec, rec, f1

    p1, r1, f1_1 = prf(tp, fp, fn)
    p0, r0, f1_0 = prf(tn, fn, fp)
    support0 = tn + fp
    support1 = fn + tp
    total = support0 + support1
    acc = (tp + tn) / total if total > 0 else 0.0

    def weighted(v0, v1):
        return float((v0 * support0 + v1 * support1) / total) if total else 0.0

    return {
        "0": {"precision": float(p0), "recall": float(r0), "f1-score": float(f1_0),
              "support": float(support0)},
        "1": {"precision": float(p1), "recall": float(r1), "f1-score": float(f1_1),
              "support": float(support1)},
        "accuracy": float(acc),
        "macro avg": {
            "precision": float((p0 + p1) / 2),
            "recall": float((r0 + r1) / 2),
            "f1-score": float((f1_0 + f1_1) / 2),
            "support": float(total),
        },
        "weighted avg": {
            "precision": weighted(p0, p1),
            "recall": weighted(r0, r1),
            "f1-score": weighted(f1_0, f1_1),
            "support": float(total),
        },
    }


def roc_curve_points(scores, labels, num_thresholds: int = 200):
    """(fpr, tpr, thresholds) float32 tensors on ``scores``' device over an
    evenly spaced grid from 1 down to 0: a row is positive at threshold t
    when its score is ``>= t``. The grid is ``torch.linspace``'s; it may
    differ from ``jnp.linspace``'s float32 grid in the last bit."""
    s = _as_tensor(scores).float().reshape(-1)
    lab = (_as_tensor(labels, s.device).reshape(-1) > 0).float()
    thresholds = torch.linspace(1.0, 0.0, num_thresholds, device=s.device)
    pos = torch.sum(lab)
    neg = lab.shape[0] - pos
    pred = (s[None, :] >= thresholds[:, None]).float()  # (thresholds, n)
    tp = pred @ lab
    fp = pred @ (1.0 - lab)
    return fp / neg, tp / pos, thresholds
