"""The wide family's fit and the feedback pools' summary on one device.

:func:`wide_sgd_fit` is the JAX package's ``mesh/retrain.wide_sgd_fit``
for a 1×1 (data × model) mesh: the same minibatch momentum SGD over the
base coef, the intercept and the hashed-cross table, with the same
padding, permutation stream, cosine learning rate and manual gradient, run
as a Python loop over minibatches. The 2-D form, with the table
column-sharded over the model axis and the gradient reduce-scattered over
the data axis, is ROADMAP item 12.

:func:`mapreduce_pool_stats` is the JAX package's function of that name on
a one-shard data mesh: the map side's sums over the replay rows, with no
reduce across shards to do.
"""

from __future__ import annotations

import numpy as np
import torch

from fraud_detection_tpu_torch.device import resolve_device
from fraud_detection_tpu_torch.ops.logistic import (
    LogisticParams,
    _cap_batch_size,
    _pad_rows,
    _resolve_sample_weight,
)


def wide_sgd_fit(
    x,
    idx,
    has,
    y,
    cross_spec,
    c: float = 1.0,
    epochs: int = 5,
    batch_size: int = 4096,
    lr: float = 0.3,
    momentum: float = 0.9,
    class_weight: dict | str | None = None,
    sample_weight=None,
    seed: int = 0,
    warm_start: tuple | None = None,
    device: str | torch.device | None = None,
) -> tuple[LogisticParams, torch.Tensor]:
    """Fit the wide family on ``device`` (resolved as every entry point
    resolves it: ``cuda`` unless the caller asks for the CPU).

    ``x`` is the scaled base block, ``idx`` the rows' cross indices
    (``ops/crosses.cross_indices`` of the RAW rows), ``has`` the has-entity
    mask: arrays, or tensors, which are used where they lie when that is
    ``device``. ``warm_start`` is a ``(base LogisticParams, table)`` pair.
    Each minibatch of the epoch's permutation (``np.random.default_rng(
    seed)`` over the padded rows) takes the gradient of
    ``(C/B_valid)·Σ sw·softplus(−ỹ·z)`` with ``z = x·w + Σ_c has·T[idx_c] +
    b``, plus ``w/n`` and ``T/n``; ``v ← momentum·v − lr_e·g``,
    ``p ← p + v``; ``lr_e = lr·½(1 + cos(π·e/epochs))``. The table's
    gradient adds up through ``index_put_(accumulate=True)``, which the card
    sums in a fixed order, so two fits on the card are bitwise equal.

    Returns ``(widened LogisticParams, table)``: the base coef followed by
    one 1.0 per cross template (the contribution columns enter the logit
    with unit weight; the learned mass lives in the table)."""
    dev = resolve_device(device)

    def on_dev(a, dtype: torch.dtype) -> torch.Tensor:
        # a tensor already on ``dev`` is used as it is; a host array is
        # copied there once
        if isinstance(a, torch.Tensor):
            return a.to(device=dev, dtype=dtype)
        return torch.tensor(np.asarray(a), dtype=dtype, device=dev)

    x_t = on_dev(x, torch.float32)
    idx_t = on_dev(idx, torch.int64)
    has_t = on_dev(has, torch.float32)
    y_np = y.detach().cpu().numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
    n, d = x_t.shape
    buckets = cross_spec.buckets
    sw = _resolve_sample_weight(y_np, sample_weight, class_weight)
    batch_size = _cap_batch_size(n, 1, batch_size)
    x_dev, idx_dev, has_dev = (_pad_rows(t, batch_size) for t in (x_t, idx_t, has_t))
    n_pad = x_dev.shape[0]
    # padding rows: label 0 (ỹ = −1), weight 0, validity 0, no entity
    y_pm = np.full((n_pad,), -1.0, np.float32)
    y_pm[:n] = np.where(y_np > 0, 1.0, -1.0)
    sw_pad = np.zeros((n_pad,), np.float32)
    sw_pad[:n] = sw
    valid = np.zeros((n_pad,), np.float32)
    valid[:n] = 1.0
    y_dev, sw_dev, valid_dev = (torch.as_tensor(a, device=dev) for a in (y_pm, sw_pad, valid))

    coef = torch.zeros((d,), dtype=torch.float32, device=dev)
    table = torch.zeros((buckets,), dtype=torch.float32, device=dev)
    intercept = torch.zeros((), dtype=torch.float32, device=dev)
    if warm_start is not None:
        base_params, warm_table = warm_start
        if base_params is not None:
            coef = torch.as_tensor(base_params.coef, dtype=torch.float32, device=dev)[:d]
            intercept = torch.as_tensor(base_params.intercept, dtype=torch.float32,
                                        device=dev).reshape(())
        if warm_table is not None:
            table = torch.as_tensor(warm_table, dtype=torch.float32, device=dev)
    vel, vel_t = torch.zeros_like(coef), torch.zeros_like(table)
    vel_b = torch.zeros_like(intercept)

    c = float(c)
    n_cross = idx_dev.shape[1]
    n_batches = n_pad // batch_size
    rng = np.random.default_rng(seed)
    for e in range(epochs):
        lr_e = float(np.float32(lr * 0.5 * (1.0 + np.cos(np.pi * e / max(epochs, 1)))))
        perm = torch.as_tensor(rng.permutation(n_pad), device=dev)
        for i in range(n_batches):
            sel = perm[i * batch_size:(i + 1) * batch_size]
            xb, ib, hb = x_dev[sel], idx_dev[sel], has_dev[sel]
            yb, swb = y_dev[sel], sw_dev[sel]
            b_valid = torch.clamp(valid_dev[sel].sum(), min=1.0)
            z_wide = (table[ib] * hb[:, None]).sum(dim=1)
            z = xb @ coef + z_wide + intercept
            # d/dz of sw·softplus(−ỹz)·C/B_valid
            g = swb * (-yb) * torch.sigmoid(-yb * z) * (c / b_valid)
            g_coef = xb.T @ g + coef / n
            g_b = g.sum()
            # the table's gradient: each row's g on each of its buckets
            g_tab = torch.zeros_like(table).index_put_(
                (ib.reshape(-1),), (g * hb)[:, None].expand(-1, n_cross).reshape(-1),
                accumulate=True,
            ) + table / n
            vel = momentum * vel - lr_e * g_coef
            coef = coef + vel
            vel_t = momentum * vel_t - lr_e * g_tab
            table = table + vel_t
            vel_b = momentum * vel_b - lr_e * g_b
            intercept = intercept + vel_b
    widened = torch.cat([coef, torch.ones(cross_spec.n_cross, dtype=torch.float32, device=dev)])
    return LogisticParams(coef=widened, intercept=intercept), table


def mapreduce_pool_stats(x, y, scores, device=None) -> dict:
    """The labeled feedback pools' summary the conductor's retrain logs:
    rows, positives, label rate, score mean, and each feature's mean and
    std — one pass of float32 sums on ``device`` (``cuda`` unless the caller
    asks for the CPU), finished in float64 on the host, as the reference
    finishes its psum'd sums."""
    x_np = np.asarray(x, np.float32)
    if x_np.ndim == 1:
        x_np = x_np[None, :]
    n, d = x_np.shape
    if n == 0:
        zeros = np.zeros((d,), np.float64)
        return {
            "rows": 0, "positives": 0, "label_rate": 0.0,
            "score_mean": 0.0, "feature_mean": zeros, "feature_std": zeros,
        }
    dev = resolve_device(device)
    xt = torch.as_tensor(x_np, device=dev)
    yt = torch.as_tensor(np.asarray(y, np.float32).reshape(-1), device=dev)
    st = torch.as_tensor(np.asarray(scores, np.float32).reshape(-1), device=dev)
    v = torch.ones((n,), dtype=torch.float32, device=dev)
    sums = [v.sum(), (v * yt).sum(), (v * st).sum(), v @ xt, v @ (xt * xt)]
    cnt, n_pos, s_sum, fx, fx2 = (t.cpu().numpy() for t in sums)
    cnt_f = max(float(cnt), 1.0)
    mean = np.asarray(fx, np.float64) / cnt_f
    var = np.maximum(np.asarray(fx2, np.float64) / cnt_f - mean**2, 0.0)
    return {
        "rows": int(round(float(cnt))),
        "positives": int(round(float(n_pos))),
        "label_rate": float(n_pos) / cnt_f,
        "score_mean": float(s_sum) / cnt_f,
        "feature_mean": mean,
        "feature_std": np.sqrt(var),
    }
