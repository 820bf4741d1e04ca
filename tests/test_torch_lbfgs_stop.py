"""The port's L-BFGS stops where the JAX package's does: on max|grad| ≤
``tol`` or after ``max_iter`` iterations (``_run_lbfgs``), with the loss
value summed in float64 so that the line search resolves the decreases
left near the optimum. Where the float32 parameter lattice next to the
optimum holds no point whose float32 gradient is within ``tol``, the fit
ends at a fixed point no restart moves (``info["stop"] ==
"fixed_point"``), which these tests verify by restarting from it.

The range's champions (``build_model``, ``build_ledger_model``) at seeds
7, 2026 and 2027 are within 1e-6 · max(1, max|coef|) of JAX's,
coefficients and intercept (measured ≤ 3.2e-7 on the CPU); the training
fixture's fits within 1e-5 · max|coef| (measured ≤ 2.1e-7)."""

import numpy as np
import pytest
import torch

from fraud_detection_tpu.ops.logistic import logistic_fit_lbfgs as jax_lbfgs
from fraud_detection_tpu.range import scenarios as jsc
from fraud_detection_tpu_torch.ops import logistic as tl
from fraud_detection_tpu_torch.range import scenarios as tsc

torch.set_num_threads(1)


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@pytest.fixture(scope="module")
def fixture_rows():
    """``tests/test_torch_train.py``'s data: 3000 rows × 30, ~3% positive."""
    rng = np.random.default_rng(21)
    n, d = 3000, 30
    x = rng.standard_normal((n, d)).astype(np.float32)
    w = rng.standard_normal(d).astype(np.float32)
    y = (rng.random(n) < 1 / (1 + np.exp(-(x @ w - 4.5)))).astype(np.int32)
    return x, y


def _assert_stopped_on_the_rule(info: dict, max_iter: int, tol: float, refit) -> None:
    """The fit ended on JAX's rule, or at a fixed point a restart from it
    leaves bitwise where it is."""
    assert info["stop"] in ("grad", "max_iter", "fixed_point"), info
    if info["stop"] == "grad":
        assert info["max_grad"] <= tol
    elif info["stop"] == "max_iter":
        assert info["n_iter"] == max_iter
    else:
        assert info["n_iter"] < max_iter and info["max_grad"] > tol
        again_info: dict = {}
        params, again = refit(again_info)
        assert torch.equal(again.coef, params.coef)
        assert torch.equal(again.intercept, params.intercept)
        assert again_info["stop"] == "fixed_point" and again_info["n_iter"] == 1


def _recording_fit(monkeypatch):
    """Wrap the port's fit to keep each call's arguments, params and info."""
    calls = []
    real = tl.logistic_fit_lbfgs

    def fit(*args, **kw):
        info = kw.setdefault("info", {})
        params = real(*args, **kw)
        calls.append((args, dict(kw), params, info))
        return params

    monkeypatch.setattr(tl, "logistic_fit_lbfgs", fit)
    return real, calls


@pytest.mark.parametrize("builder", ["build_model", "build_ledger_model"])
@pytest.mark.parametrize("seed", [7, 2026, 2027])
def test_range_champions_match_jax(builder, seed, monkeypatch):
    real, calls = _recording_fit(monkeypatch)
    j = getattr(jsc, builder)(seed=seed)
    t = getattr(tsc, builder)(seed=seed, device="cpu")
    if builder == "build_ledger_model":
        j, t = j[0], t[0]
    jc, tc = _np(j.model.params.coef), _np(t.model.params.coef)
    bound = 1e-6 * max(1.0, float(np.abs(jc).max()))
    gap = float(np.abs(tc - jc).max())
    b_gap = abs(float(_np(t.model.params.intercept)) - float(_np(j.model.params.intercept)))
    (args, kw, params, info), = calls
    print(f"{builder} seed {seed}: coef gap {gap:.3e}, intercept gap {b_gap:.3e}, "
          f"bound {bound:.3e}, {info}")
    assert gap <= bound and b_gap <= bound
    kw = {k: v for k, v in kw.items() if k != "info"}

    def refit(again_info):
        return params, real(*args, **kw, warm_start=params, info=again_info)

    _assert_stopped_on_the_rule(info, kw["max_iter"], 1e-5, refit)


@pytest.mark.parametrize("class_weight", [None, "balanced"])
def test_fixture_fit_matches_jax_and_stops_on_the_rule(fixture_rows, class_weight):
    x, y = fixture_rows
    info: dict = {}
    got = tl.logistic_fit_lbfgs(x, y, max_iter=200, class_weight=class_weight, info=info)
    want = jax_lbfgs(x, y, max_iter=200, class_weight=class_weight)
    wc, wb = np.asarray(want.coef), float(want.intercept)
    scale = float(np.abs(wc).max())
    gap = float(np.abs(got.coef.numpy() - wc).max())
    print(f"class_weight {class_weight}: gap / max|coef| {gap / scale:.3e}, "
          f"intercept gap {abs(float(got.intercept) - wb):.3e}, {info}")
    assert gap <= 1e-5 * scale
    assert abs(float(got.intercept) - wb) <= 1e-5 * scale

    def refit(again_info):
        return got, tl.logistic_fit_lbfgs(x, y, max_iter=200, class_weight=class_weight,
                                          warm_start=got, info=again_info)

    _assert_stopped_on_the_rule(info, 200, 1e-5, refit)


def test_a_fit_given_fewer_iterations_stops_at_max_iter(fixture_rows):
    x, y = fixture_rows
    info: dict = {}
    tl.logistic_fit_lbfgs(x, y, max_iter=3, info=info)
    assert info["stop"] == "max_iter" and info["n_iter"] == 3
    assert info["max_grad"] > 1e-5


def test_a_fit_from_its_optimum_stops_on_the_gradient(fixture_rows):
    """A warm start whose float32 gradient is already within ``tol`` takes
    no iteration."""
    x, y = fixture_rows
    info: dict = {}
    p = tl.logistic_fit_lbfgs(x, y, max_iter=200, class_weight="balanced", info=info)
    assert info["stop"] == "grad"
    again: dict = {}
    q = tl.logistic_fit_lbfgs(x, y, max_iter=200, class_weight="balanced",
                              warm_start=p, info=again)
    assert again["n_iter"] == 0 and again["stop"] == "grad"
    assert torch.equal(q.coef, p.coef) and torch.equal(q.intercept, p.intercept)
