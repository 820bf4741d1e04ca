"""L2-regularized logistic regression: parameters, prediction and the two
solvers of the JAX package, on one device.

- :func:`logistic_fit_lbfgs` — full-batch L-BFGS on sklearn's ``lbfgs``
  objective ``0.5·wᵀw + C·Σᵢ sᵢ·softplus(−ỹᵢ(xᵢᵀw + b))`` (intercept not
  regularized, ỹ ∈ {−1, +1}), by ``torch.optim.LBFGS`` with a strong-Wolfe
  line search. The JAX package runs optax's zoom line search; the objective
  is strictly convex, so the two agree on the optimum, not on iterates.
- :func:`logistic_fit_sgd` — minibatch momentum SGD on the 1/n-scaled
  objective with a cosine-decayed learning rate: the JAX package's
  ``shard_map`` epoch with one device, run as a Python loop over
  minibatches (padding to the batch multiple, the ``valid`` mask, the
  per-batch valid count, the host permutation stream). The sharded form is
  the scale-out slice's.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
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


def _resolve_sample_weight(
    y_np: np.ndarray, sample_weight, class_weight: dict | str | None
) -> np.ndarray:
    """sklearn's sample-weight composition: explicit weights × class weights
    ('balanced' → n/(2·n_class), or a {label: w} dict)."""
    n = y_np.shape[0]
    sw = (
        np.ones((n,), dtype=np.float32)
        if sample_weight is None
        else np.asarray(sample_weight, dtype=np.float32).copy()
    )
    if class_weight == "balanced":
        n_pos = max(int((y_np > 0).sum()), 1)
        n_neg = max(int((y_np <= 0).sum()), 1)
        sw *= np.where(y_np > 0, n / (2.0 * n_pos), n / (2.0 * n_neg)).astype(
            np.float32
        )
    elif isinstance(class_weight, dict):
        sw *= np.where(
            y_np > 0, float(class_weight.get(1, 1.0)), float(class_weight.get(0, 1.0))
        ).astype(np.float32)
    return sw


def _host(y) -> np.ndarray:
    return y.detach().cpu().numpy() if isinstance(y, torch.Tensor) else np.asarray(y)


def predict_logits(params: LogisticParams, x: torch.Tensor) -> torch.Tensor:
    return x @ params.coef + params.intercept


def predict_proba(params: LogisticParams, x: torch.Tensor) -> torch.Tensor:
    """P(class=1)."""
    return torch.sigmoid(predict_logits(params, x))


def logistic_fit_lbfgs(
    x,
    y,
    c: float = 1.0,
    max_iter: int = 100,
    tol: float = 1e-5,
    class_weight: dict | str | None = None,
    warm_start: LogisticParams | None = None,
    info: dict | None = None,
) -> LogisticParams:
    """Fit with sklearn-equivalent hyperparameters on ``x``'s device (an
    array is fitted on the CPU); ``warm_start`` seeds the solver with
    existing params. Stops when max |grad| ≤ ``tol`` (sklearn's
    criterion), when the loss stops changing in float32, or after
    ``max_iter`` iterations. ``info``, when given, receives the iteration
    and function-evaluation counts (``n_iter``, ``n_evals``).

    ``torch.optim.LBFGS`` reads the loss and the gradient norm on the host
    at every iteration, so on the card each iteration waits for the device.
    """
    xt = torch.as_tensor(x).float()
    y_np = _host(y)
    dev = xt.device
    sw = torch.as_tensor(_resolve_sample_weight(y_np, None, class_weight), device=dev)
    y_pm = torch.as_tensor(np.where(y_np > 0, 1.0, -1.0).astype(np.float32), device=dev)
    d = xt.shape[1]
    if warm_start is None:
        w = torch.zeros(d, dtype=torch.float32, device=dev)
        b = torch.zeros((), dtype=torch.float32, device=dev)
    else:
        w = warm_start.coef.detach().to(dev, torch.float32).clone()
        b = warm_start.intercept.detach().to(dev, torch.float32).reshape(()).clone()
    w.requires_grad_(True)
    b.requires_grad_(True)
    opt = torch.optim.LBFGS(
        [w, b], lr=1.0, max_iter=int(max_iter), tolerance_grad=float(tol),
        tolerance_change=1e-9, history_size=10, line_search_fn="strong_wolfe",
    )
    c = float(c)

    def closure():
        opt.zero_grad()
        z = xt @ w + b
        loss = 0.5 * torch.dot(w, w) + c * torch.sum(
            sw * torch.nn.functional.softplus(-y_pm * z)
        )
        loss.backward()
        return loss

    with torch.enable_grad():
        opt.step(closure)
    if info is not None:
        state = opt.state[opt._params[0]]
        info["n_iter"] = int(state.get("n_iter", 0))
        info["n_evals"] = int(state.get("func_evals", 0))
    return LogisticParams(coef=w.detach(), intercept=b.detach())


def _cap_batch_size(n: int, ndev: int, batch_size: int) -> int:
    """Cap the minibatch at the per-device shard size so small datasets don't
    pad up to a mostly-empty giant batch."""
    per_dev = max((n + ndev - 1) // ndev, 1)
    return max(min(batch_size, per_dev), 1)


def _pad_rows(t: torch.Tensor, mult: int) -> torch.Tensor:
    rem = (-t.shape[0]) % mult
    if rem == 0:
        return t
    return torch.cat([t, t.new_zeros((rem,) + tuple(t.shape[1:]))])


def logistic_fit_sgd(
    x,
    y,
    c: float = 1.0,
    epochs: int = 5,
    batch_size: int = 8192,
    lr: float = 0.5,
    momentum: float = 0.9,
    class_weight: dict | str | None = None,
    seed: int = 0,
    epoch_callback=None,
    resume: dict | None = None,
) -> LogisticParams:
    """Minibatch momentum SGD on one device (``x``'s; an array is fitted on
    the CPU).

    Per minibatch of the epoch's permutation: the gradient of
    ``(C/B_valid)·Σ sw·softplus(−ỹ·z) + (0.5/n)·wᵀw``, where B_valid counts
    the batch's non-padding rows; ``v ← momentum·v − lr_e·g``, ``p ← p + v``;
    ``lr_e = lr·½(1 + cos(π·e/epochs))``. The permutation of each epoch is
    ``np.random.default_rng(seed).permutation`` of the padded row count.

    ``epoch_callback(epoch, params, velocity, rng, fingerprint)`` fires
    after each epoch (``ckpt.train_state.SGDCheckpointer.epoch_callback``
    persists it), and ``resume`` is that checkpointer's saved state:
    training continues at the next epoch with the saved velocity and PRNG
    stream, so an interrupted and resumed fit is bitwise equal to one that
    never stopped. The checkpoint's ``fingerprint`` (with ``ndev: 1``) must
    match this fit's."""
    ndev = 1
    xt = torch.as_tensor(x).float()
    dev = xt.device
    y_np = _host(y)
    n, d = xt.shape
    sw = _resolve_sample_weight(y_np, None, class_weight)
    batch_size = _cap_batch_size(n, ndev, batch_size)

    # pad rows to the batch multiple; padded rows carry weight 0 and
    # validity 0, so they are inert in the loss
    mult = ndev * batch_size
    x_pad = _pad_rows(xt, mult)
    n_pad = x_pad.shape[0]
    y_pm = np.full((n_pad,), -1.0, np.float32)
    y_pm[:n] = np.where(y_np > 0, 1.0, -1.0)
    sw_pad = np.zeros((n_pad,), np.float32)
    sw_pad[:n] = sw
    valid = np.zeros((n_pad,), np.float32)
    valid[:n] = 1.0
    y_dev = torch.as_tensor(y_pm, device=dev)
    sw_dev = torch.as_tensor(sw_pad, device=dev)
    valid_dev = torch.as_tensor(valid, device=dev)

    coef = torch.zeros(d, dtype=torch.float32, device=dev)
    intercept = torch.zeros((), dtype=torch.float32, device=dev)
    v_coef = torch.zeros_like(coef)
    v_intercept = torch.zeros_like(intercept)
    rng = np.random.default_rng(seed)
    start_epoch = 0
    # everything the lr schedule, the permutation stream and the shapes
    # depend on: a checkpoint under another fingerprint cannot resume this
    # fit bitwise, so it is refused
    fingerprint = {
        "n": int(n), "d": int(d), "epochs": int(epochs),
        "batch_size": int(batch_size), "lr": float(lr),
        "momentum": float(momentum), "seed": int(seed), "ndev": int(ndev),
    }
    if resume is not None:
        saved_fp = resume.get("fingerprint")
        if saved_fp is not None and saved_fp != fingerprint:
            diff = {
                k: (saved_fp.get(k), fingerprint[k])
                for k in fingerprint
                if saved_fp.get(k) != fingerprint[k]
            }
            raise ValueError(
                f"checkpoint does not match this fit (saved vs current): {diff}"
            )
        if np.asarray(resume["coef"]).shape != (d,):
            raise ValueError(
                f"checkpoint coef shape {np.asarray(resume['coef']).shape} "
                f"does not match {d} features"
            )

        def dev32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)

        coef, intercept = dev32(resume["coef"]), dev32(resume["intercept"]).reshape(())
        v_coef = dev32(resume["v_coef"])
        v_intercept = dev32(resume["v_intercept"]).reshape(())
        rng.bit_generator.state = resume["rng_state"]
        start_epoch = int(resume["epoch"]) + 1

    c = float(c)
    reg = 1.0 / (n * ndev)  # d/dw of 0.5·wᵀw/(n·ndev)
    n_batches = n_pad // batch_size
    for e in range(start_epoch, epochs):
        lr_e = float(np.float32(lr * 0.5 * (1.0 + np.cos(np.pi * e / max(epochs, 1)))))
        perm = torch.as_tensor(rng.permutation(n_pad), device=dev)
        for i in range(n_batches):
            idx = perm[i * batch_size:(i + 1) * batch_size]
            xb, yb, swb = x_pad[idx], y_dev[idx], sw_dev[idx]
            b_valid = torch.clamp(valid_dev[idx].sum(), min=1.0)
            z = xb @ coef + intercept
            # d/dz of sw·softplus(−ỹz)·C/B_valid = −ỹ·sw·sigmoid(−ỹz)·C/B_valid
            dz = -yb * swb * torch.sigmoid(-yb * z) * (c / b_valid)
            g_coef = xb.T @ dz + reg * coef
            g_intercept = dz.sum()
            v_coef = momentum * v_coef - lr_e * g_coef
            v_intercept = momentum * v_intercept - lr_e * g_intercept
            coef = coef + v_coef
            intercept = intercept + v_intercept
        if epoch_callback is not None:
            epoch_callback(
                e, LogisticParams(coef, intercept),
                LogisticParams(v_coef, v_intercept), rng, fingerprint,
            )
    return LogisticParams(coef=coef, intercept=intercept)
