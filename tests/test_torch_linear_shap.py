"""The port's linear SHAP and top-k reason codes against the JAX package's
(``fraud_detection_tpu/ops/linear_shap.py``), including the tie rule:
``jax.lax.top_k`` ranks by IEEE total order and resolves ties toward the
lower feature index; ``torch.topk`` does neither, so the port ranks with a
stable sort on total-order keys."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# the modules, not the same-named functions their packages re-export
jls = importlib.import_module("fraud_detection_tpu.ops.linear_shap")
tls = importlib.import_module("fraud_detection_tpu_torch.ops.linear_shap")

torch.set_num_threads(1)


def _tied_rows(seed: int = 11) -> np.ndarray:
    """Attribution rows built to tie: repeated values, ±0.0, runs of equal
    maxima, and rows that are all one value."""
    rng = np.random.default_rng(seed)
    levels = np.array([-1.5, -0.0, 0.0, 0.25, 0.25, 1.0, 1.0, 3.0], np.float32)
    phi = rng.choice(levels, size=(64, 30)).astype(np.float32)
    phi[0] = 0.0
    phi[1] = -0.0
    phi[2] = np.where(np.arange(30) % 2 == 0, 0.0, -0.0).astype(np.float32)
    phi[3] = 1.0
    phi[4, [3, 9, 17]] = 5.0
    return phi


@pytest.mark.parametrize("k", [1, 3, 5, 30])
def test_topk_indices_equal_lax_top_k_on_ties(k):
    phi = _tied_rows()
    want_idx, want_val = jls.topk_reasons(jnp.asarray(phi), k)
    got_idx, got_val = tls.topk_reasons(torch.from_numpy(phi), k)
    assert got_idx.dtype == torch.int32
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    # values are gathered from the same f32 inputs: bitwise equal, sign of
    # zero included
    np.testing.assert_array_equal(
        got_val.numpy().view(np.int32), np.asarray(want_val).view(np.int32)
    )


def test_topk_on_random_attributions():
    rng = np.random.default_rng(3)
    phi = rng.standard_normal((257, 30)).astype(np.float32)
    want_idx, want_val = jls.topk_reasons(jnp.asarray(phi), 3)
    got_idx, got_val = tls.topk_reasons(torch.from_numpy(phi), 3)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(got_val.numpy(), np.asarray(want_val))


def test_linear_shap_matches_jax():
    """Same f32 elementwise expression w·(x − μ): bitwise equal."""
    rng = np.random.default_rng(4)
    coef = rng.standard_normal(30).astype(np.float32)
    mu = rng.standard_normal(30).astype(np.float32)
    x = rng.standard_normal((50, 30)).astype(np.float32)
    je = jls.make_explainer(coef, np.float32(0.3), background_mean=mu)
    te = tls.make_explainer(
        torch.from_numpy(coef), torch.tensor(0.3), background_mean=torch.from_numpy(mu)
    )
    np.testing.assert_array_equal(
        tls.linear_shap(te, torch.from_numpy(x)).numpy(),
        np.asarray(jls.linear_shap(je, jnp.asarray(x))),
    )
    # f32 dot in a different summation order: 1e-5 on a value of order 5
    np.testing.assert_allclose(
        float(te.expected_value), float(je.expected_value), rtol=0, atol=1e-5
    )


def test_make_explainer_background_rows_and_default():
    rng = np.random.default_rng(6)
    coef = rng.standard_normal(8).astype(np.float32)
    bg = rng.standard_normal((40, 8)).astype(np.float32)
    te = tls.make_explainer(torch.from_numpy(coef), 0.0, background_x=bg)
    je = jls.make_explainer(coef, 0.0, background_x=bg)
    np.testing.assert_allclose(
        te.background_mean.numpy(), np.asarray(je.background_mean), rtol=0, atol=1e-6
    )
    zero = tls.make_explainer(torch.from_numpy(coef), 0.0)
    assert torch.equal(zero.background_mean, torch.zeros(8))
