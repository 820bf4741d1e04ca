"""StandardScaler parameters, fit and transform (sklearn semantics: ddof=0
variance, zero-variance columns scale by 1.0). The sharded fit of the JAX
package (``scaler_fit_sharded``) belongs to the scale-out slice."""

from __future__ import annotations

from dataclasses import dataclass

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


def scaler_transform(params: ScalerParams, x: torch.Tensor) -> torch.Tensor:
    return (x - params.mean) / params.scale
