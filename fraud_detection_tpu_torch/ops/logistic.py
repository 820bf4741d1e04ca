"""Logistic-regression parameters. The L-BFGS and SGD solvers belong to the
training slice and are not ported yet."""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class LogisticParams:
    coef: torch.Tensor  # (d,)
    intercept: torch.Tensor  # ()

    def to(self, device: torch.device) -> "LogisticParams":
        return LogisticParams(
            coef=self.coef.to(device=device, dtype=torch.float32),
            intercept=self.intercept.to(device=device, dtype=torch.float32),
        )
