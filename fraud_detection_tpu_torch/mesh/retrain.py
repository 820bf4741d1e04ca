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

:func:`wide_sgd_fit` is the JAX package's 2-D ``wide_sgd_fit`` over a
``(data × model)`` grid (:func:`wide_training_mesh`): the same minibatch
momentum SGD over the base coef, the intercept and the hashed-cross table,
with the same padding, permutation stream, cosine learning rate and
manual gradient; the table column-sharded over the model axis and
subdivided over the data axis, its gradient reduce-scattered over the data
axis (:func:`_wide_update_epoch` one epoch). The model axis lies inside a
process; ranks split the data axis.

:func:`mapreduce_pool_stats` is the JAX package's MapReduce pool summary
(arxiv 2403.07128): each shard sums its rows (map), a ``psum`` reduces the
sums (reduce), finished in float64 on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from fraud_detection_tpu_torch import config
from fraud_detection_tpu_torch.ops.crosses import _gather_contrib_model
from fraud_detection_tpu_torch.ops.logistic import (
    LogisticParams,
    _cap_batch_size,
    _host,
    _pad_rows,
    _resolve_sample_weight,
)
from fraud_detection_tpu_torch.parallel.collectives import (
    all_gather,
    all_gather_blocks,
    psum,
    psum_scatter,
    psum_scatter_blocks,
)
from fraud_detection_tpu_torch.parallel.mesh import MeshSpec, default_mesh, global_mesh, process_count
from fraud_detection_tpu_torch.parallel.sharding import batch_sharding, data_sharding, shard_batch


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


def wide_training_mesh(model_devices: int | None = None, data_devices: int | None = None,
                       device: str | torch.device | None = None):
    """The wide family's ``(data × model)`` training grid (the JAX package's
    ``wide_training_mesh``): ``model_devices`` model shards (default
    ``MESH_MODEL_DEVICES``, 0 and unset meaning 1) and ``data_devices``
    data shards (default one a process), on the serving device (or
    ``device``). Ranks split the data axis only: a data axis the processes
    do not divide raises ``ValueError`` (``parallel.global_mesh``). A model
    axis of 1 is the 1×1 fit."""
    m = model_devices if model_devices is not None else (config.mesh_model_devices() or 1)
    d = data_devices if data_devices is not None else process_count()
    return global_mesh(MeshSpec(data=int(d), model=max(int(m), 1)), device)


def _wide_update_epoch(
    coef: torch.Tensor,  # (d,) replicated base coef
    vel: torch.Tensor,  # (d,) its momentum
    wl: torch.Tensor,  # (data, model, k): the table, shard (d, m) owning k columns
    wvl: torch.Tensor,  # (data, model, k): its momentum
    intercept: torch.Tensor,  # () replicated
    vel_b: torch.Tensor,  # () replicated
    x: torch.Tensor,  # (data, n_local, d): each data shard's rows
    idx: torch.Tensor,  # (data, n_local, n_cross) their cross indices
    has: torch.Tensor,  # (data, n_local) has-entity
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
    """One epoch of the 2-D wide update (the JAX package's
    ``_wide_update_body``). Each step: every model group's column block is
    the ``all_gather`` of its data shards' slices (:func:`~fraud_detection_
    tpu_torch.parallel.collectives.all_gather_blocks`); the data shards'
    widened blocks are every model shard's partial gather summed over the
    model axis in one assembly a step (``ops/crosses._gather_contrib_model``
    over every data shard's rows at once, a row's block its own: one real
    weight and exact zeros a cell, so the block, the logit and every
    gradient have the same bits at every model axis), masked by
    has-entity; the base
    gradient and the intercept's are ``psum``-ed over the data axis; the
    table's gradient is each data shard's scatter of its rows' ``g·has``
    onto its model groups' column blocks (one accumulating ``index_put_``
    over the ``(model, n_col)`` grid: an index names one cell of one group,
    and a cell sums its rows in batch order, on the card through a sort),
    ``psum_scatter``-ed over the data axis onto the owning slices — no
    model-axis gradient collective: a group's columns take gradient only
    from its own indices. Then ``v ← momentum·v −
    lr·g``, ``p ← p + v`` on the owned slices, the base coef and the
    intercept. Returns ``(coef, vel, wl, wvl, intercept, vel_b)``."""
    n_batches = x.shape[1] // batch
    n_model = mesh.model
    n_col = wl.shape[2] * mesh.global_data
    n_cross = idx.shape[2]
    for i in range(n_batches):
        w_col = all_gather_blocks(wl, mesh)  # (model, n_col)
        sel = perm[i * batch:(i + 1) * batch]
        b_valid = torch.clamp(
            psum(torch.stack([valid[s][sel].sum() for s in range(mesh.data)]), mesh), min=1.0
        )
        # every data shard's widened block in one model-axis assembly (the
        # logit's one psum_model a step): a row's block is its own
        ib_all, hb_all = idx[:, sel], has[:, sel]
        z_wide_all = _gather_contrib_model(
            w_col, ib_all.reshape(-1, n_cross), hb_all.reshape(-1)
        ).sum(dim=1).view(mesh.data, -1)
        gw, gb, gt = [], [], []
        for s in range(mesh.data):
            xb, ib, hb = x[s][sel], ib_all[s], hb_all[s]
            yb, swb = y_pm[s][sel], sw[s][sel]
            z = xb @ coef + z_wide_all[s] + intercept
            # d/dz of sw·softplus(−ỹz)·C/B_valid
            g = swb * (-yb) * torch.sigmoid(-yb * z) * (c / b_valid)
            gw.append(xb.T @ g)
            gb.append(g.sum())
            # every model group's block at once: an entry's cell in the
            # (model, n_col) grid is its bucket (group ib // n_col, column
            # ib mod n_col), so one accumulating index_put_ is the groups'
            # scatters of their own entries, in batch order
            gt.append(torch.zeros(n_model * n_col, dtype=wl.dtype, device=wl.device)
                      .index_put_((ib.reshape(-1),),
                                  (g * hb)[:, None].expand(-1, n_cross).reshape(-1),
                                  accumulate=True)
                      .view(n_model, n_col))
        g_coef = psum(torch.stack(gw), mesh) + coef / n_total
        g_b = psum(torch.stack(gb), mesh)
        g_loc = psum_scatter_blocks(torch.stack(gt), mesh) + wl / n_total
        vel = momentum * vel - lr * g_coef
        coef = coef + vel
        wvl = momentum * wvl - lr * g_loc
        wl = wl + wvl
        vel_b = momentum * vel_b - lr * g_b
        intercept = intercept + vel_b
    return coef, vel, wl, wvl, intercept, vel_b


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
    mesh=None,
    warm_start: tuple | None = None,
    device: str | torch.device | None = None,
) -> tuple[LogisticParams, torch.Tensor]:
    """Fit the wide family on the ``(data × model)`` grid ``mesh`` (default
    :func:`wide_training_mesh` on ``device``, resolved as every entry point
    resolves it: ``cuda`` unless the caller asks for the CPU).

    ``x`` is the scaled base block, ``idx`` the rows' cross indices
    (``ops/crosses.cross_indices`` of the RAW rows), ``has`` the has-entity
    mask: arrays or tensors. ``warm_start`` is a ``(base LogisticParams,
    table)`` pair. The rows are padded to ``data · batch`` (label 0,
    weight 0, validity 0, no entity) and split over the data axis; the
    table and its momentum are owned model-major, data-minor (shard ``(d,
    m)`` holds columns ``m·buckets/M + d·k``…, ``k = buckets/(D·M)``: JAX's
    ``WIDE_PARAM_SPEC``); the base coef and the intercept are replicated.
    Each minibatch of the epoch's permutation (``np.random.default_rng(
    seed).permutation`` of a data shard's rows) takes the gradient of
    ``(C/B_valid)·Σ sw·softplus(−ỹ·z)`` with ``z = x·w + Σ_c has·T[idx_c] +
    b``, plus ``w/n`` and ``T/n`` (:func:`_wide_update_epoch`); ``lr_e =
    lr·½(1 + cos(π·e/epochs))``. The fit has the same bits at every model
    axis for a given data axis, the 1×1 grid's being the single-device
    fit's, and two fits on the card are bitwise equal.

    Returns ``(widened LogisticParams, table)`` on the mesh's device: the
    base coef followed by one 1.0 per cross template (the contribution
    columns enter the logit with unit weight; the learned mass lives in
    the table)."""
    mesh = mesh or wide_training_mesh(device=device)
    dev = mesh.device
    n_data, n_model = mesh.global_data, mesh.model
    buckets = cross_spec.buckets
    if buckets % (n_data * n_model):
        raise ValueError(f"WIDE_BUCKETS={buckets} does not shard over the "
                         f"{n_data}x{n_model} grid")

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
    sw = _resolve_sample_weight(y_np, sample_weight, class_weight)
    batch_size = _cap_batch_size(n, n_data, batch_size)
    x_pad, idx_pad, has_pad = (_pad_rows(t, n_data * batch_size) for t in (x_t, idx_t, has_t))
    n_pad = x_pad.shape[0]
    # padding rows: label 0 (ỹ = −1), weight 0, validity 0, no entity
    y_pm = np.full((n_pad,), -1.0, np.float32)
    y_pm[:n] = np.where(y_np > 0, 1.0, -1.0)
    sw_pad = np.zeros((n_pad,), np.float32)
    sw_pad[:n] = sw
    valid = np.zeros((n_pad,), np.float32)
    valid[:n] = 1.0
    layout = data_sharding(mesh)
    x_dev, idx_dev, has_dev, y_dev, sw_dev, valid_dev = (
        layout.segments(shard_batch(a, mesh, over_model=False)[0])
        for a in (x_pad, idx_pad, has_pad, y_pm, sw_pad, valid)
    )

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
    k = buckets // (n_data * n_model)
    own = slice(mesh.shard_offset, mesh.shard_offset + mesh.data)
    wl = table.reshape(n_model, n_data, k)[:, own].transpose(0, 1).contiguous()
    vel, wvl = torch.zeros_like(coef), torch.zeros_like(wl)
    vel_b = torch.zeros_like(intercept)

    n_local = n_pad // n_data
    rng = np.random.default_rng(seed)
    for e in range(epochs):
        lr_e = float(np.float32(lr * 0.5 * (1.0 + np.cos(np.pi * e / max(epochs, 1)))))
        coef, vel, wl, wvl, intercept, vel_b = _wide_update_epoch(
            coef, vel, wl, wvl, intercept, vel_b, x_dev, idx_dev, has_dev, y_dev,
            sw_dev, valid_dev, torch.as_tensor(rng.permutation(n_local), device=dev), lr_e,
            mesh=mesh, c=float(c), n_total=int(n), momentum=float(momentum),
            batch=int(batch_size),
        )
    widened = torch.cat([coef, torch.ones(cross_spec.n_cross, dtype=torch.float32, device=dev)])
    return LogisticParams(coef=widened, intercept=intercept), all_gather_blocks(wl, mesh).reshape(-1)


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
