"""Closed-form interventional linear SHAP.

For ``f(x) = wᵀx + b`` with an independent background, the exact SHAP
values are ``φⱼ = wⱼ·(xⱼ − μⱼ)`` with base value ``E[f] = wᵀμ + b``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class LinearShapExplainer(NamedTuple):
    coef: torch.Tensor  # (d,)
    background_mean: torch.Tensor  # (d,) — μ of the background set
    expected_value: torch.Tensor  # () — wᵀμ + b (margin space)


def make_explainer(coef, intercept, background_x=None, background_mean=None):
    coef = torch.as_tensor(coef).reshape(-1)
    if background_mean is None:
        if background_x is None:
            background_mean = torch.zeros_like(coef)
        else:
            background_mean = torch.as_tensor(background_x).mean(dim=0)
    background_mean = torch.as_tensor(background_mean).reshape(-1).to(coef)
    ev = torch.dot(coef, background_mean) + torch.as_tensor(intercept).to(coef).reshape(())
    return LinearShapExplainer(coef, background_mean, ev)


def _raw_linear_shap(
    coef: torch.Tensor, background_mean: torch.Tensor, x: torch.Tensor
) -> torch.Tensor:
    """Batched linear-SHAP body shared by the fused flush and
    :func:`linear_shap`, so serve-time reason codes are bitwise the
    standalone attributions."""
    return coef[None, :] * (x - background_mean[None, :])


def linear_shap(explainer: LinearShapExplainer, x: torch.Tensor) -> torch.Tensor:
    """SHAP values (n, d) for a batch."""
    return _raw_linear_shap(explainer.coef, explainer.background_mean, x)


def _total_order_key(phi: torch.Tensor) -> torch.Tensor:
    """int32 keys ordered like IEEE-754 totalOrder on float32 values
    (−0.0 below +0.0), the order ``jax.lax.top_k`` ranks by."""
    bits = phi.contiguous().view(torch.int32)
    return bits ^ ((bits >> 31) & 0x7FFFFFFF)


def topk_reasons(phi: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Arg-top-k reason codes over attributions (n, d) →
    ``(indices (n, k) int32, values (n, k))``, highest signed attribution
    first, ties to the LOWER feature index — the rule ``jax.lax.top_k``
    follows. ``torch.topk`` breaks ties in no fixed order, so the rank is a
    stable descending sort on total-order keys."""
    phi = phi.float()
    order = torch.sort(
        _total_order_key(phi), dim=1, descending=True, stable=True
    ).indices[:, :k]
    return order.to(torch.int32), torch.gather(phi, 1, order)
