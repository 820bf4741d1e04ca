"""The sharded weight update, the wide family's fit and the feedback pools'
summary: the JAX package's ``mesh/retrain.py``.

:func:`mesh_sgd_fit` is the cross-replica-sharded weight update (arxiv
2004.13336) over a mesh's data axis: each data shard owns 1/N of the
(feature-padded) coefficient vector and of its momentum, every step
``all_gather``-s the full vector for the forward pass, ``psum_scatter``-s
the shards' gradients straight onto the owning slices and updates only
those; the intercept and its momentum are replicated, their gradient
``psum``-ed. The same minibatch SGD, cosine learning rate and permutation
stream as the JAX package's ``_sharded_update_epoch``, as a Python loop
over minibatches (:func:`_sharded_update_epoch` one epoch); the collectives
fold in global shard order (``parallel/collectives``), so one process with
8 shards and two with 4 give the same bits.

:func:`wide_sgd_fit` is the JAX package's ``wide_sgd_fit`` for a 1×1
(data × model) mesh: the same minibatch momentum SGD over the base coef,
the intercept and the hashed-cross table, with the same padding,
permutation stream, cosine learning rate and manual gradient. The 2-D
form, with the table column-sharded over the model axis and the gradient
reduce-scattered over the data axis, is ROADMAP item 12b (second PR).

:func:`mapreduce_pool_stats` is the JAX package's MapReduce pool summary
(arxiv 2403.07128): each shard sums its rows (map), a ``psum`` reduces the
sums (reduce), finished in float64 on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from fraud_detection_tpu_torch.device import resolve_device
from fraud_detection_tpu_torch.ops.logistic import (
    LogisticParams,
    _cap_batch_size,
    _host,
    _pad_rows,
    _resolve_sample_weight,
)
from fraud_detection_tpu_torch.parallel.collectives import all_gather, psum, psum_scatter
from fraud_detection_tpu_torch.parallel.mesh import default_mesh
from fraud_detection_tpu_torch.parallel.sharding import batch_sharding, shard_batch


def _pad_features(d: int, ndev: int) -> int:
    """Parameter length padded so the shard axis divides it evenly (the
    padded coefficients start at zero, see zero gradient, and stay zero)."""
    return ((d + ndev - 1) // ndev) * ndev


def _sharded_update_epoch(
    coef_l: torch.Tensor,  # (data, d_pad/ndev): this process's shards' slices
    vel_l: torch.Tensor,  # (data, d_pad/ndev): their momentum
    intercept: torch.Tensor,  # () replicated
    vel_b: torch.Tensor,  # () replicated
    x: torch.Tensor,  # (data, n_local, d_pad): each shard's rows
    y_pm: torch.Tensor,  # (data, n_local) ±1 labels
    sw: torch.Tensor,  # (data, n_local) sample weights (0 on padding)
    valid: torch.Tensor,  # (data, n_local) row validity
    perm: torch.Tensor,  # (n_local,) the epoch's permutation, every shard's
    lr: float,
    *,
    mesh,
    c: float,
    n_total: int,
    momentum: float,
    batch: int,
):
    """One epoch of the cross-replica-sharded update: per step ``i`` every
    shard takes rows ``perm[i·batch:(i+1)·batch]`` of its segment; the full
    weight vector is the ``all_gather`` of the owned slices; each shard's
    gradient of ``(C/B_valid)·Σ sw·softplus(−ỹ·z) + 0.5·wᵀw/(n·ndev)``
    (B_valid the ``psum`` of the step's valid rows) is ``psum_scatter``-ed
    onto the owning slices, the intercept's ``psum``-ed; then ``v ←
    momentum·v − lr·g``, ``p ← p + v`` on the owned slices and the
    intercept. Returns ``(coef_l, vel_l, intercept, vel_b)``."""
    n_batches = x.shape[1] // batch
    reg = 1.0 / (n_total * mesh.global_data)  # the psum reconstitutes w/n
    shards = range(mesh.size)
    for i in range(n_batches):
        w = all_gather(coef_l, mesh).reshape(-1)
        idx = perm[i * batch:(i + 1) * batch]
        b_valid = torch.clamp(
            psum(torch.stack([valid[s][idx].sum() for s in shards]), mesh), min=1.0
        )
        gw, gb = [], []
        for s in shards:
            xb, yb, swb = x[s][idx], y_pm[s][idx], sw[s][idx]
            z = xb @ w + intercept
            # d/dz of sw·softplus(−ỹz)·C/B_valid = −ỹ·sw·sigmoid(−ỹz)·C/B_valid
            dz = -yb * swb * torch.sigmoid(-yb * z) * (c / b_valid)
            gw.append(xb.T @ dz + reg * w)
            gb.append(dz.sum())
        # reduce + shard in one collective: each shard receives the summed
        # gradient of its own slice only
        gw_l = psum_scatter(torch.stack(gw), mesh)
        g_b = psum(torch.stack(gb), mesh)
        vel_l = momentum * vel_l - lr * gw_l
        coef_l = coef_l + vel_l
        vel_b = momentum * vel_b - lr * g_b
        intercept = intercept + vel_b
    return coef_l, vel_l, intercept, vel_b


def mesh_sgd_fit(
    x,
    y,
    c: float = 1.0,
    epochs: int = 5,
    batch_size: int = 4096,
    lr: float = 0.3,
    momentum: float = 0.9,
    class_weight: dict | str | None = None,
    sample_weight=None,
    seed: int = 0,
    mesh=None,
    warm_start: LogisticParams | None = None,
) -> LogisticParams:
    """Data-parallel minibatch SGD whose weight update is sharded across
    ``mesh``'s data axis (default ``default_mesh()``: one shard on the
    serving device, or one a process of a group) instead of replicated. The objective scaling
    of ``ops/logistic.logistic_fit_sgd`` (the 1/n-scaled sklearn primal,
    cosine-decayed lr). Features are padded to a multiple of the global
    shard count, rows to ``ndev · batch`` (padded rows: label 0, weight 0,
    validity 0); the permutation of each epoch is ``np.random.default_rng(
    seed).permutation`` of the segment length. ``warm_start`` seeds the
    sharded params from the incumbent champion — the conductor's retrain.
    Every process returns the same params, on the mesh's device."""
    mesh = mesh or default_mesh()
    dev = mesh.device
    ndev = mesh.global_data
    xt = torch.as_tensor(x).float()
    y_np = _host(y)
    n, d = xt.shape
    d_pad = _pad_features(d, ndev)
    if d_pad != d:
        xt = torch.nn.functional.pad(xt, (0, d_pad - d))
    sw = _resolve_sample_weight(y_np, sample_weight, class_weight)
    batch_size = _cap_batch_size(n, ndev, batch_size)

    x_pad = _pad_rows(xt, ndev * batch_size)
    n_pad = x_pad.shape[0]
    y_pm = np.full((n_pad,), -1.0, np.float32)
    y_pm[:n] = np.where(y_np > 0, 1.0, -1.0)
    sw_pad = np.zeros((n_pad,), np.float32)
    sw_pad[:n] = sw
    valid = np.zeros((n_pad,), np.float32)
    valid[:n] = 1.0
    layout = batch_sharding(mesh)
    x_dev, y_dev, sw_dev, valid_dev = (
        layout.segments(shard_batch(a, mesh)[0]) for a in (x_pad, y_pm, sw_pad, valid)
    )

    coef0 = torch.zeros((d_pad,), dtype=torch.float32)
    b0 = torch.zeros((), dtype=torch.float32)
    if warm_start is not None:
        coef0[:d] = torch.as_tensor(warm_start.coef, dtype=torch.float32).cpu().reshape(-1)[:d]
        b0 = torch.as_tensor(warm_start.intercept, dtype=torch.float32).cpu().reshape(())
    k = d_pad // ndev
    own = slice(mesh.shard_offset, mesh.shard_offset + mesh.size)
    coef_l = coef0.reshape(ndev, k)[own].contiguous().to(dev)
    vel_l = torch.zeros_like(coef_l)
    intercept = b0.to(dev)
    vel_b = torch.zeros_like(intercept)

    n_local = n_pad // ndev
    rng = np.random.default_rng(seed)
    for e in range(epochs):
        lr_e = float(np.float32(lr * 0.5 * (1.0 + np.cos(np.pi * e / max(epochs, 1)))))
        coef_l, vel_l, intercept, vel_b = _sharded_update_epoch(
            coef_l, vel_l, intercept, vel_b, x_dev, y_dev, sw_dev, valid_dev,
            torch.as_tensor(rng.permutation(n_local), device=dev), lr_e,
            mesh=mesh, c=float(c), n_total=int(n), momentum=float(momentum),
            batch=int(batch_size),
        )
    coef = all_gather(coef_l, mesh).reshape(-1)[:d]
    return LogisticParams(coef=coef.contiguous(), intercept=intercept)


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


def mapreduce_pool_stats(x, y, scores, mesh=None, device=None) -> dict:
    """The labeled feedback pools' summary the conductor's retrain logs:
    rows, positives, label rate, score mean, and each feature's mean and
    std. Rows split over ``mesh``'s data axis (default
    ``default_mesh(device)``; ``device`` ``cuda`` unless the caller asks
    for the CPU), each shard's float32 sums over its rows (map), ``psum``
    over every shard (reduce), finished in float64 on the host, as the
    reference finishes its psum'd sums — never concatenated on one host."""
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
    mesh = mesh or default_mesh(device)
    layout = batch_sharding(mesh)
    xs, ys, ss, vs = (
        layout.segments(shard_batch(a, mesh)[0]) for a in (
            x_np, np.asarray(y, np.float32).reshape(-1),
            np.asarray(scores, np.float32).reshape(-1), np.ones((n,), np.float32),
        )
    )

    def red(f):
        return psum(torch.stack([f(s) for s in range(mesh.size)]), mesh)

    sums = [red(lambda s: vs[s].sum()), red(lambda s: (vs[s] * ys[s]).sum()),
            red(lambda s: (vs[s] * ss[s]).sum()), red(lambda s: vs[s] @ xs[s]),
            red(lambda s: vs[s] @ (xs[s] * xs[s]))]
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
