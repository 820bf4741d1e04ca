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


def scaler_fit(x) -> ScalerParams:
    """Fit on ``x`` (n, d) — a tensor (fitted where it lies) or an array
    (fitted on the CPU). Two passes in float32: the mean,
    then E[(x − mean)²]. The one-pass E[x²] − E[x]² form cancels in float32
    on high-mean, low-spread columns such as ``Time`` and can collapse their
    variance to 0."""
    x = torch.as_tensor(x).float()
    n = torch.tensor(float(x.shape[0]), dtype=torch.float32, device=x.device)
    mean = x.sum(dim=0) / n
    centered = x - mean
    var = (centered * centered).sum(dim=0) / n
    std = torch.sqrt(var)
    scale = torch.where(std == 0.0, torch.ones_like(std), std)
    return ScalerParams(mean=mean, scale=scale, var=var, n_samples=n)


def scaler_transform(params: ScalerParams, x: torch.Tensor) -> torch.Tensor:
    return (x - params.mean) / params.scale
