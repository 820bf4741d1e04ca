"""SMOTE oversampling through the hand-written k-NN kernel.

The JAX package's ``ops/smote.smote`` in three steps:

1. on the host, the class counts, ``n_synth = n_maj − n_min``
   and ``k = min(k_neighbors, n_min − 1)``, with its ``ValueError``\\ s;
2. on the device, the minority rows are gathered, centred (distances are
   translation-invariant and the ``|q|² − 2q·x + |x|²`` expansion keeps
   more float32 precision near the origin) and their ``|x|²`` taken, then
   :func:`~fraud_detection_tpu_torch.ops.kernels.knn_topk` finds each row's
   k nearest minority rows;
3. :func:`interpolate` places each synthetic row at ``x_b + u·(x_nn − x_b)``.

The JAX package draws ``base``, ``slot`` and ``gap`` from ``jax.random``
(threefry), which torch does not reproduce. Here they come from a CPU
``torch.Generator`` seeded with ``seed`` and are copied to the device, so
the CPU and the card build the same synthetic rows from the same seed;
:func:`interpolate` takes the draws as tensors, which is the seam where
the two packages are held bitwise equal on the same draws.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from fraud_detection_tpu_torch.ops import kernels


def smote_draws(
    n_min: int, k: int, n_synthetic: int, seed: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``base`` (n,) int64 in [0, n_min), ``slot`` (n,) int64 in [0, k) and
    ``gap`` (n, 1) float32 in [0, 1), from a CPU generator seeded with
    ``seed`` (the same on every device)."""
    gen = torch.Generator(device="cpu")
    gen.manual_seed(int(seed))
    base = torch.randint(0, n_min, (n_synthetic,), generator=gen)
    slot = torch.randint(0, k, (n_synthetic,), generator=gen)
    gap = torch.rand((n_synthetic, 1), generator=gen, dtype=torch.float32)
    return base, slot, gap


def interpolate(
    x_min: torch.Tensor,
    nn_idx: torch.Tensor,
    base: torch.Tensor,
    slot: torch.Tensor,
    gap: torch.Tensor,
) -> torch.Tensor:
    """Synthetic rows ``x_b + gap·(x_n − x_b)`` with ``x_b = x_min[base]`` and
    ``x_n = x_min[nn_idx[base, slot]]`` — ``_interpolate`` of the JAX
    package with its random draws passed in. XLA fuses the multiply and the
    add into one fused multiply-add (one rounding); ``addcmul`` rounds the
    same way, so the rows are bitwise the JAX package's."""
    xb = x_min[base]
    xn = x_min[nn_idx[base, slot].long()]
    return torch.addcmul(xb, gap, xn - xb)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def smote(
    x,
    y,
    seed: int,
    k_neighbors: int = 5,
    timings: dict | None = None,
) -> tuple[torch.Tensor, np.ndarray]:
    """Oversample the minority class up to the majority's count.

    ``x`` is a tensor (used where it lies) or an array (used on the CPU);
    ``y`` is host labels. Returns ``(x_resampled, y_resampled)``
    with the synthetic rows appended (imblearn's layout): the rows on
    ``x``'s device, the labels as a host int32 array. ``timings``, when
    given, receives the seconds of the k-NN step (``knn``) and of the whole
    call (``smote``), with the device synchronised at both ends."""
    t0 = time.perf_counter()
    xt = torch.as_tensor(x).float()
    dev = xt.device
    y_np = (
        y.detach().cpu().numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
    ).astype(np.int32)
    classes, counts = np.unique(y_np, return_counts=True)
    if len(classes) != 2:
        raise ValueError("smote supports binary labels")
    minority = classes[np.argmin(counts)]
    n_min = int(counts.min())
    n_maj = int(counts.max())
    n_synth = n_maj - n_min
    if n_synth <= 0:
        return xt, y_np
    if n_min < 2:
        # one minority row has no neighbour to interpolate toward
        raise ValueError(f"SMOTE needs at least 2 minority samples, got {n_min}")
    k = min(k_neighbors, n_min - 1)

    # ascending row order, like jnp.nonzero in the JAX package
    min_idx = torch.as_tensor(np.nonzero(y_np == minority)[0], device=dev)
    x_min = xt[min_idx]
    xc = (x_min - x_min.mean(dim=0)).contiguous()
    sq = (xc * xc).sum(dim=1)
    _sync(dev)
    t_knn = time.perf_counter()
    nn_idx = kernels.knn_topk(xc, sq, k)
    _sync(dev)
    if timings is not None:
        timings["knn"] = time.perf_counter() - t_knn

    base, slot, gap = smote_draws(n_min, k, n_synth, seed)
    synth = interpolate(x_min, nn_idx, base.to(dev), slot.to(dev), gap.to(dev))
    x_out = torch.cat([xt, synth], dim=0)
    y_out = np.concatenate([y_np, np.full((n_synth,), minority, dtype=np.int32)])
    if timings is not None:
        _sync(dev)
        timings["smote"] = time.perf_counter() - t0
    return x_out, y_out
