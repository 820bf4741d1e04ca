"""StandardScaler parameters and transform (sklearn semantics: ddof=0
variance, zero-variance columns scale by 1.0). The fit belongs to the
training slice and is not ported yet."""

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


def scaler_transform(params: ScalerParams, x: torch.Tensor) -> torch.Tensor:
    return (x - params.mean) / params.scale
