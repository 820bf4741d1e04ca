"""StandardScaler parameters, fit and transform (sklearn semantics: ddof=0
variance, zero-variance columns scale by 1.0). :func:`scaler_fit_sharded`
is the JAX package's sharded fit: per-shard partial sums reduced over the
data axis (``parallel/collectives.psum``), so it scales past one device's
rows; at one shard it is bitwise :func:`scaler_fit`."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class ScalerParams:
    mean: torch.Tensor  # (d,)
    scale: torch.Tensor  # (d,) — std, with 0 → 1.0 like sklearn
    var: torch.Tensor  # (d,)
    n_samples: torch.Tensor  # () float — rows seen

    def to(self, device: torch.device) -> "ScalerParams":
        return ScalerParams(
            *(t.to(device=device, dtype=torch.float32)
              for t in (self.mean, self.scale, self.var, self.n_samples))
        )


def column_sums(x: torch.Tensor) -> torch.Tensor:
    """Column sums of ``x`` (n, d) in a fixed order: rows padded with zeros
    to a power of two, then the lower half added to the upper half until
    one row is left. Every step is an elementwise IEEE float32 add, so the
    card and the CPU give the same bits (``Tensor.sum`` does not: each
    backend picks its own order)."""
    n = x.shape[0]
    size = 1 << max(n - 1, 0).bit_length()
    if size != n:
        x = torch.cat([x, x.new_zeros((size - n,) + tuple(x.shape[1:]))])
    while x.shape[0] > 1:
        half = x.shape[0] // 2
        x = x[:half] + x[half:]
    return x[0]


def scaler_fit(x) -> ScalerParams:
    """Fit on ``x`` (n, d) — a tensor (fitted where it lies) or an array
    (fitted on the CPU). Two passes in float32: the mean,
    then E[(x − mean)²]. The one-pass E[x²] − E[x]² form cancels in float32
    on high-mean, low-spread columns such as ``Time`` and can collapse their
    variance to 0. The sums run in :func:`column_sums`' fixed order and the
    square root is taken in float64 and rounded once (the correctly rounded
    float32 root; PyTorch's float32 ``sqrt`` on the CPU is not on every
    machine), so a fit on the card equals the same fit on the CPU bit for
    bit."""
    x = torch.as_tensor(x).float()
    n = torch.tensor(float(x.shape[0]), dtype=torch.float32, device=x.device)
    mean = column_sums(x) / n
    centered = x - mean
    var = column_sums(centered * centered) / n
    std = torch.sqrt(var.double()).float()
    scale = torch.where(std == 0.0, torch.ones_like(std), std)
    return ScalerParams(mean=mean, scale=scale, var=var, n_samples=n)


def scaler_fit_sharded(x, mesh=None) -> ScalerParams:
    """Host rows (or a tensor) → row-sharded over ``mesh``'s data axis
    (default ``default_mesh()``; padded to the global shard count) → the
    two passes of :func:`scaler_fit` as per-shard partial
    :func:`column_sums` reduced with ``psum`` (the fold in global shard
    order). Padded rows are masked out of the second pass and the sums
    divide by the real row count. Every process of a group gets the same
    parameters; at one shard they are bitwise :func:`scaler_fit`'s."""
    from fraud_detection_tpu_torch.parallel.collectives import psum
    from fraud_detection_tpu_torch.parallel.mesh import default_mesh
    from fraud_detection_tpu_torch.parallel.sharding import batch_sharding, shard_batch

    mesh = mesh or default_mesh()
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x, dtype=np.float32))
    xt, n_valid = shard_batch(x.float(), mesh)
    seg = batch_sharding(mesh).segments(xt)  # (shards, rows a shard, d)
    rows = seg.shape[1]
    n = torch.tensor(float(n_valid), dtype=torch.float32, device=xt.device)
    mean = psum(torch.stack([column_sums(seg[s]) for s in range(mesh.size)]), mesh) / n
    first = mesh.shard_offset * rows  # global index of this process's first row
    parts = []
    for s in range(mesh.size):
        centered = seg[s] - mean
        start = first + s * rows
        if start + rows > n_valid:  # a shard holding padded rows
            live = torch.arange(start, start + rows, device=xt.device) < n_valid
            centered = torch.where(live[:, None], centered, torch.zeros_like(centered))
        parts.append(column_sums(centered * centered))
    var = psum(torch.stack(parts), mesh) / n
    std = torch.sqrt(var.double()).float()
    scale = torch.where(std == 0.0, torch.ones_like(std), std)
    return ScalerParams(mean=mean, scale=scale, var=var, n_samples=n)


def scaler_transform(params: ScalerParams, x: torch.Tensor) -> torch.Tensor:
    return (x - params.mean) / params.scale
