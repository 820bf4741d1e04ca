"""L2-regularized logistic regression: parameters, prediction and the two
solvers of the JAX package.

- :func:`logistic_fit_lbfgs` — full-batch L-BFGS on sklearn's ``lbfgs``
  objective ``0.5·wᵀw + C·Σᵢ sᵢ·softplus(−ỹᵢ(xᵢᵀw + b))`` (intercept not
  regularized, ỹ ∈ {−1, +1}), by ``torch.optim.LBFGS`` with a strong-Wolfe
  line search, stopping on the JAX package's rule alone (max|grad| ≤ tol,
  or ``max_iter`` iterations). The JAX package runs optax's zoom line
  search; the objective is strictly convex, so the two agree on the
  optimum, not on iterates. The loss value the line search reads is the
  float64 sum of float64 terms over a float64 copy of the rows (the
  parameters and the gradient stay float32: the gradient is the float32
  graph's): a float32 sum stops changing long before the gradient is
  small, and the line search then takes a zero step. With ``sharded=True``
  the rows split over a mesh's
  data axis and the data term is the ``psum`` of the shards' float64
  partial losses, differentiated through the fold
  (``parallel/collectives``).
- :func:`logistic_fit_sgd` — minibatch momentum SGD on the 1/n-scaled
  objective with a cosine-decayed learning rate: the JAX package's
  ``shard_map`` epoch as a Python loop over minibatches (padding to the
  batch multiple, the ``valid`` mask, the per-batch valid count, the host
  permutation stream), each shard's gradient ``psum``-ed over the mesh's
  data axis.

At one shard either sharded fit is bitwise the unsharded fit: a one-shard
``psum`` returns its partial unchanged.
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
    mesh=None,
    sharded: bool = False,
) -> LogisticParams:
    """Fit with sklearn-equivalent hyperparameters on ``x``'s device (an
    array is fitted on the CPU; ``sharded`` fits on the mesh's device);
    ``warm_start`` seeds the solver with existing params. Stops, as the
    JAX package's ``_run_lbfgs`` does, when max|grad| ≤ ``tol`` (sklearn's
    criterion) or after ``max_iter`` iterations: no loss-change or
    function-evaluation stop ends the fit first. ``info``, when given,
    receives the iteration and function-evaluation counts (``n_iter``,
    ``n_evals``), the float32 max|grad| at the last iterate
    (``max_grad``), the restarts from steepest descent (``restarts``) and
    what ended the fit (``stop``: ``grad``, ``max_iter`` or
    ``fixed_point``, below).

    With ``sharded=True`` the rows are padded and split over ``mesh``'s
    data axis (default ``default_mesh()``, every process of a group; padded
    rows carry weight 0): each shard computes its partial loss on its own
    rows with its copy of the parameters (``replicate``), the data term is
    their ``psum``, and the gradient reaching the parameters is the fold of
    the shards' gradients — the same on every process. One global shard
    takes the unsharded graph on the mesh's device.

    ``torch.optim.LBFGS`` reads the loss and the gradient norm on the host
    at every iteration, so on the card each iteration waits for the device.
    """
    y_np = _host(y)
    sw_np = _resolve_sample_weight(y_np, None, class_weight)
    y_pm_np = np.where(y_np > 0, 1.0, -1.0).astype(np.float32)
    if sharded:
        from fraud_detection_tpu_torch.parallel.mesh import default_mesh

        mesh = mesh or default_mesh()
        if mesh.size * mesh.processes == 1:
            # one global shard: the unsharded graph, whose bits the
            # one-shard fold gives anyway, without its per-shard copies
            sharded = False
            x = torch.as_tensor(x).float().to(mesh.device)
    if sharded:
        from fraud_detection_tpu_torch.parallel.collectives import psum, replicate
        from fraud_detection_tpu_torch.parallel.sharding import batch_sharding, shard_batch

        layout = batch_sharding(mesh)
        x_in = x.float() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)
        xt = layout.segments(shard_batch(x_in, mesh)[0])
        sw = layout.segments(shard_batch(sw_np, mesh)[0])  # pad weight 0: inert
        y_pm = layout.segments(shard_batch(y_pm_np, mesh)[0])
        dev = mesh.device
    else:
        xt = torch.as_tensor(x).float()
        dev = xt.device
        sw = torch.as_tensor(sw_np, device=dev)
        y_pm = torch.as_tensor(y_pm_np, device=dev)
    d = xt.shape[-1]
    if warm_start is None:
        w = torch.zeros(d, dtype=torch.float32, device=dev)
        b = torch.zeros((), dtype=torch.float32, device=dev)
    else:
        w = warm_start.coef.detach().to(dev, torch.float32).clone()
        b = warm_start.intercept.detach().to(dev, torch.float32).reshape(()).clone()
    w.requires_grad_(True)
    b.requires_grad_(True)
    c = float(c)
    # the rows once more in float64, for the loss value alone
    x64 = [xt[s].double() for s in range(mesh.size)] if sharded else xt.double()
    sw64, y64 = (
        ([v.double() for v in sw], [v.double() for v in y_pm]) if sharded
        else (sw.double(), y_pm.double())
    )
    softplus = torch.nn.functional.softplus

    def data_term(x64_, sw_, sw64_, y_, y64_, z):
        """The float32 graph's sum for the gradient, carrying the float64
        sum of the float64 terms as its value: ``p32 + (p64 − p32)`` is
        ``p64`` exactly (the two agree well within a factor of 2), and its
        backward reaches the float32 terms alone."""
        p32 = torch.sum(sw_ * softplus(-y_ * z)).double()
        with torch.no_grad():
            z64 = x64_ @ w.detach().double() + b.detach().double()
            p64 = torch.sum(sw64_ * softplus(-y64_ * z64))
        return p32 + (p64 - p32.detach())

    def closure():
        w.grad = b.grad = None
        w64 = w.double()
        if not sharded:
            loss = 0.5 * torch.dot(w64, w64) + c * data_term(
                x64, sw, sw64, y_pm, y64, xt @ w + b)
        else:
            # each shard's copy of (w, b); the fold of the copies' gradients
            # reaches w and b, after the regularizer's (the unsharded graph's
            # order, so one shard gives its bits)
            w_s, b_s = replicate(w, mesh), replicate(b, mesh)
            loss = 0.5 * torch.dot(w64, w64) + c * psum(torch.stack([
                data_term(x64[s], sw[s], sw64[s], y_pm[s], y64[s], xt[s] @ w_s[s] + b_s[s])
                for s in range(mesh.size)
            ]), mesh)
        loss.backward()
        return loss

    def max_grad() -> float:
        closure()
        return float(torch.maximum(w.grad.abs().max(), b.grad.abs()))

    # JAX's stop: max|grad| ≤ tol or max_iter iterations. tolerance_change 0
    # leaves LBFGS no loss-change stop, and the evaluation budget never runs
    # out first. A line search that finds no lower loss still ends
    # LBFGS.step, with a zero step (optax's zoom steps on where it fails), so
    # the fit restarts from steepest descent there. A restart that cannot
    # move either has reached a fixed point: every later restart repeats it
    # bit for bit (the closure is deterministic), so the fit ends there
    # ("fixed_point": the float32 parameter lattice next to the optimum
    # need not hold a point whose float32 gradient is within tol)
    n_iter = n_evals = restarts = 0
    with torch.enable_grad():
        while True:
            before = (w.detach().clone(), b.detach().clone())
            opt = torch.optim.LBFGS(
                [w, b], lr=1.0, max_iter=int(max_iter) - n_iter,
                max_eval=2**62, tolerance_grad=float(tol), tolerance_change=0.0,
                history_size=10, line_search_fn="strong_wolfe",
            )
            opt.step(closure)
            state = opt.state[opt._params[0]]
            n_iter += int(state.get("n_iter", 0))
            n_evals += int(state.get("func_evals", 0))
            g = max_grad()
            if g <= tol:
                stop = "grad"
            elif n_iter >= max_iter:
                stop = "max_iter"
            elif torch.equal(w.detach(), before[0]) and torch.equal(b.detach(), before[1]):
                stop = "fixed_point"
            else:
                restarts += 1
                continue
            break
    if info is not None:
        info.update(n_iter=n_iter, n_evals=n_evals, max_grad=g, restarts=restarts,
                    stop=stop)
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
    mesh=None,
) -> LogisticParams:
    """Data-parallel minibatch momentum SGD over ``mesh``'s data axis
    (default: ``default_mesh`` on ``x``'s device — one shard, or one a
    process of a group; an array is fitted on the CPU).

    Rows are padded to ``ndev · batch`` (``ndev`` the global shard count;
    padded rows carry weight 0 and validity 0) and split into the shards'
    equal segments. Per step ``i`` of an epoch every shard takes rows
    ``perm[i·B:(i+1)·B]`` of its own segment (``perm`` one permutation of
    the segment length, the same on every shard, as the JAX package's
    ``_sgd_epoch_fn``) and the gradient of ``(C/B_valid)·Σ sw·softplus(−ỹ·z)
    + (0.5/(n·ndev))·wᵀw`` there; B_valid is the ``psum`` of the shards'
    non-padding rows in the step, and the gradient the ``psum`` of the
    shards'. Then ``v ← momentum·v − lr_e·g``, ``p ← p + v``, ``lr_e =
    lr·½(1 + cos(π·e/epochs))``; every shard holds the same parameters.
    The permutation of each epoch is ``np.random.default_rng(seed)
    .permutation`` of the segment length.

    ``epoch_callback(epoch, params, velocity, rng, fingerprint)`` fires
    after each epoch (``ckpt.train_state.SGDCheckpointer.epoch_callback``
    persists it), and ``resume`` is that checkpointer's saved state:
    training continues at the next epoch with the saved velocity and PRNG
    stream, so an interrupted and resumed fit is bitwise equal to one that
    never stopped. The checkpoint's ``fingerprint`` (``ndev`` the global
    shard count, so a JAX checkpoint saved on 8 devices resumes here at 8
    shards and is refused at 4) must match this fit's."""
    from fraud_detection_tpu_torch.parallel.collectives import psum
    from fraud_detection_tpu_torch.parallel.mesh import default_mesh
    from fraud_detection_tpu_torch.parallel.sharding import batch_sharding, shard_batch

    xt = torch.as_tensor(x).float()
    mesh = mesh or default_mesh(xt.device)
    ndev = mesh.global_data
    dev = mesh.device
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
    layout = batch_sharding(mesh)
    x_dev, y_dev, sw_dev, valid_dev = (
        layout.segments(shard_batch(a, mesh)[0]) for a in (x_pad, y_pm, sw_pad, valid)
    )
    n_local = n_pad // ndev

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
    reg = 1.0 / (n * ndev)  # d/dw of 0.5·wᵀw/(n·ndev), once a shard
    n_batches = n_local // batch_size
    shards = range(mesh.size)
    for e in range(start_epoch, epochs):
        lr_e = float(np.float32(lr * 0.5 * (1.0 + np.cos(np.pi * e / max(epochs, 1)))))
        perm = torch.as_tensor(rng.permutation(n_local), device=dev)
        for i in range(n_batches):
            idx = perm[i * batch_size:(i + 1) * batch_size]
            b_valid = torch.clamp(
                psum(torch.stack([valid_dev[s][idx].sum() for s in shards]), mesh), min=1.0
            )
            g_coef, g_intercept = [], []
            for s in shards:
                xb, yb, swb = x_dev[s][idx], y_dev[s][idx], sw_dev[s][idx]
                z = xb @ coef + intercept
                # d/dz of sw·softplus(−ỹz)·C/B_valid = −ỹ·sw·sigmoid(−ỹz)·C/B_valid
                dz = -yb * swb * torch.sigmoid(-yb * z) * (c / b_valid)
                g_coef.append(xb.T @ dz + reg * coef)
                g_intercept.append(dz.sum())
            g_coef = psum(torch.stack(g_coef), mesh)
            g_intercept = psum(torch.stack(g_intercept), mesh)
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
