"""The port's GBT numerics (``ops/gbt.py``, the ``gbt_hist`` kernel's plain
version) against the JAX package's ``ops/gbt.py`` on the same numpy
inputs, at small sizes (3–20 trees, depth 2–5, 16–64 bins)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from fraud_detection_tpu.ops import gbt as jgbt
from fraud_detection_tpu.ops.scaler import scaler_fit as jax_scaler_fit
from fraud_detection_tpu_torch import convert
from fraud_detection_tpu_torch.ops import gbt, kernels
from fraud_detection_tpu_torch.ops.scaler import scaler_fit

torch.set_num_threads(1)


def _data(seed: int, n: int = 1200, d: int = 30):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    w = rng.standard_normal(d).astype(np.float32)
    y = (rng.random(n) < 1 / (1 + np.exp(-(x @ w - 2)))).astype(np.int32)
    return x, y


# ---------------------------------------------------------------------------
# binning
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_bins, max_sample", [(16, 200_000), (64, 200_000), (32, 500)])
def test_bin_edges_and_bins_are_bitwise_jax(n_bins, max_sample):
    """Edges from the same numpy quantiles (and the same subsample seed
    above ``max_sample``); bins by the same strict-below count."""
    x, _ = _data(3)
    x[:40, 2] = 0.25  # a feature with a run of equal values
    got = gbt.compute_bin_edges(x, n_bins, max_sample=max_sample)
    want = jgbt.compute_bin_edges(x, n_bins, max_sample=max_sample)
    assert got.tobytes() == want.tobytes()
    x[5, 3] = got[3, 7]  # a value on an edge stays left
    b = gbt.bin_features(torch.from_numpy(x), torch.from_numpy(got))
    assert b.dtype == torch.int32
    np.testing.assert_array_equal(b.numpy(), np.asarray(jgbt.bin_features(x, want)))
    np.testing.assert_array_equal(gbt.bin_features_host(x, got, n_bins), b.numpy())
    assert gbt.bin_features_host(x, got, n_bins).dtype == np.uint8


def test_nan_and_inf_binning_rule():
    """NaN goes to the last bin, n_bins − 1, on the host and the device
    path alike; +inf to the last bin and −inf to bin 0 past finite edges.
    The JAX package's host binning and its CPU ``bin_features`` give the
    same bins."""
    edges = np.array([[0.0, 1.0, 2.0], [-1.0, 0.0, 5.0]], np.float32)
    x = np.array([[np.nan, 0.5], [np.inf, -np.inf], [-np.inf, np.nan],
                  [1.0, 5.0], [2.5, np.nan]], np.float32)
    want = np.array([[3, 2], [3, 0], [0, 3], [1, 2], [3, 3]])
    dev_path = gbt.bin_features(torch.from_numpy(x), torch.from_numpy(edges)).numpy()
    host_path = gbt.bin_features_host(x, edges, 4)
    np.testing.assert_array_equal(dev_path, want)
    np.testing.assert_array_equal(host_path, want)
    np.testing.assert_array_equal(np.asarray(jgbt.bin_features(x, edges)), want)
    np.testing.assert_array_equal(
        np.stack([np.searchsorted(edges[f], x[:, f], side="left") for f in range(2)], 1),
        want,
    )


# ---------------------------------------------------------------------------
# the histogram kernel's plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n, d, n_bins, n_nodes", [(2048, 10, 64, 4), (1000, 5, 32, 4),
                                                   (777, 30, 16, 1), (513, 7, 64, 16)])
def test_hist_reference_matches_segment_and_pallas(n, d, n_bins, n_nodes):
    """Within 1e-5 of ``_hist_segment`` (exact f32, the same row order), and
    within 0.05 of ``_hist_pallas(interpret=True)`` — its bf16 rounding of
    g and h (the tolerance of tests/test_gbt.py)."""
    rng = np.random.default_rng(n + d)
    binned = rng.integers(0, n_bins, (n, d))
    local = rng.integers(0, n_nodes, (n,)).astype(np.int32)
    g = rng.standard_normal(n).astype(np.float32)
    h = (rng.random(n) * 0.25).astype(np.float32)
    got = kernels.gbt_hist(
        torch.from_numpy(binned.astype(np.uint8)), torch.from_numpy(local),
        torch.from_numpy(g), torch.from_numpy(h), n_nodes, n_bins,
    ).numpy()
    assert got.shape == (d, n_nodes, n_bins, 2)
    args = (jnp.asarray(binned, jnp.int32), jnp.asarray(local), jnp.asarray(g),
            jnp.asarray(h), n_nodes, n_bins)
    np.testing.assert_allclose(got, np.asarray(jgbt._hist_segment(*args)), rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        got, np.asarray(jgbt._hist_pallas(*args, interpret=True)), rtol=0, atol=0.05
    )
    assert kernels.GBT_HIST_LAUNCHES == 0  # the CPU path never counts


def test_hist_inert_rows_and_float64_bound():
    """Rows outside the level and bins ≥ n_bins add nothing; every cell is
    within 1e-6·Σ|value| of its float64 sum (the kernel's tolerance on the
    card)."""
    rng = np.random.default_rng(7)
    n, d, n_bins, n_nodes = 3001, 6, 16, 2
    binned = rng.integers(0, 20, (n, d)).astype(np.uint8)
    local = rng.integers(-1, 3, (n,)).astype(np.int32)
    g = rng.standard_normal(n).astype(np.float32)
    h = rng.random(n).astype(np.float32)
    g[::5] = 0.0
    h[::5] = 0.0
    got = kernels.gbt_hist_reference(
        torch.from_numpy(binned), torch.from_numpy(local), torch.from_numpy(g),
        torch.from_numpy(h), n_nodes, n_bins,
    ).numpy()
    want = np.zeros((d, n_nodes, n_bins, 2))
    absum = np.zeros_like(want)
    for r in range(n):
        for f in range(d):
            m, b = local[r], binned[r, f]
            if 0 <= m < n_nodes and b < n_bins:
                want[f, m, b] += (g[r], h[r])
                absum[f, m, b] += (abs(g[r]), abs(h[r]))
    assert np.all(np.abs(got - want) <= 1e-6 * absum + 1e-30)


def test_hist_wrapper_checks_inputs():
    z = torch.zeros(4, dtype=torch.float32)
    with pytest.raises(TypeError, match="int32 local"):
        kernels.gbt_hist(torch.zeros((4, 2), dtype=torch.uint8), z, z, z, 1, 4)
    with pytest.raises(ValueError, match="row count"):
        kernels.gbt_hist(torch.zeros((4, 2), dtype=torch.uint8),
                         torch.zeros(3, dtype=torch.int32), z, z, 1, 4)


# ---------------------------------------------------------------------------
# tree growth and the fit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("depth, n_bins", [(2, 16), (3, 32), (5, 64)])
def test_grow_tree_matches_jax_on_the_same_gradients(depth, n_bins):
    """One tree from the same bins, g and h: the same splits, bitwise the
    same leaf values and row leaves (the exact-f32 segment path)."""
    rng = np.random.default_rng(depth)
    n, d = 1500, 12
    binned = rng.integers(0, n_bins, (n, d))
    g = rng.standard_normal(n).astype(np.float32)
    h = (rng.random(n) * 0.25 + 0.01).astype(np.float32)
    h[:50] = 0.0  # inert rows
    g[:50] = 0.0
    cfg_kw = dict(max_depth=depth, n_bins=n_bins, min_child_weight=0.5, gamma=0.01)
    jf, jt, jl, jr = jgbt._grow_tree(
        jnp.asarray(binned, jnp.int32), jnp.asarray(g), jnp.asarray(h),
        jgbt.GBTConfig(**cfg_kw), None, "segment",
    )
    pf, pt, pl, pr = gbt._grow_tree(
        torch.from_numpy(binned.astype(np.uint8)), torch.from_numpy(g),
        torch.from_numpy(h), gbt.GBTConfig(**cfg_kw),
    )
    np.testing.assert_array_equal(pf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(pr.numpy(), np.asarray(jr))
    assert pl.numpy().tobytes() == np.asarray(jl).tobytes()


def test_pass_through_on_a_pure_node():
    """No positive gain anywhere: every node passes its rows left (feature
    0, bin n_bins − 1), as in the JAX package."""
    x = np.random.default_rng(0).standard_normal((200, 3)).astype(np.float32)
    y = np.zeros(200, np.int32)
    m = gbt.gbt_fit(x, y, gbt.GBTConfig(n_trees=3, max_depth=3, n_bins=16), device="cpu")
    assert (m.split_feature == 0).all() and (m.split_bin == 15).all()
    jm = jgbt.gbt_fit(x, y, jgbt.GBTConfig(n_trees=3, max_depth=3, n_bins=16))
    np.testing.assert_allclose(m.leaf_value.numpy(), np.asarray(jm.leaf_value), atol=1e-6)


@pytest.mark.parametrize(
    "seed, cfg_kw",
    [
        (0, dict(n_trees=10, max_depth=5, n_bins=64)),
        (1, dict(n_trees=20, max_depth=4, n_bins=32)),
        (2, dict(n_trees=6, max_depth=5, n_bins=16, learning_rate=0.3)),
        (0, dict(n_trees=3, max_depth=2, n_bins=16)),
        (1, dict(n_trees=8, max_depth=3, n_bins=32, scale_pos_weight=5.0)),
    ],
)
def test_gbt_fit_matches_jax_unsharded_cpu_fit(seed, cfg_kw):
    """The same forest split for split; leaf values and probabilities within
    1e-6. (``torch.sigmoid`` and XLA's logistic differ in the last bit on
    ~0.4% of inputs, so on other data a gain within rounding of a tie can
    pick another split some trees in; these fixtures have none.)"""
    x, y = _data(seed)
    jm = jgbt.gbt_fit(x, y, jgbt.GBTConfig(**cfg_kw))
    pm = gbt.gbt_fit(x, y, gbt.GBTConfig(**cfg_kw), device="cpu")
    assert pm.split_feature.dtype == torch.int32 and pm.leaf_value.dtype == torch.float32
    np.testing.assert_array_equal(pm.split_feature.numpy(), np.asarray(jm.split_feature))
    np.testing.assert_array_equal(pm.split_bin.numpy(), np.asarray(jm.split_bin))
    np.testing.assert_allclose(pm.leaf_value.numpy(), np.asarray(jm.leaf_value), rtol=0, atol=1e-6)
    assert pm.bin_edges.numpy().tobytes() == np.asarray(jm.bin_edges).tobytes()
    assert float(pm.base_logit) == float(jm.base_logit)
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(
        gbt.gbt_predict_proba(pm, xt).numpy(), np.asarray(jgbt.gbt_predict_proba(jm, x)),
        rtol=0, atol=1e-6,
    )


def test_dense_and_walk_predictions_reach_the_same_leaves():
    x, y = _data(4)
    m = gbt.gbt_fit(x, y, gbt.GBTConfig(n_trees=12, max_depth=4, n_bins=32), device="cpu")
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(
        gbt._predict_logits_dense(m, xt).numpy(), gbt._predict_logits_walk(m, xt).numpy(),
        rtol=0, atol=2e-6,
    )
    jm = convert.gbt_from_arrays({f: np.asarray(getattr(m, f)) for f in m._fields})
    np.testing.assert_allclose(
        np.asarray(jgbt._predict_logits_dense(jgbt.GBTModel(*map(jnp.asarray, m)), x)),
        gbt._predict_logits_dense(jm, xt).numpy(), rtol=0, atol=2e-6,
    )


def test_scaler_fold_is_exact():
    """Folding the scaler into the edges scores raw rows exactly as the
    unfolded forest scores the scaled rows (same bins per row), and the
    folded edges equal the JAX package's fold of the same forest."""
    x, y = _data(5)
    x_raw = x * np.linspace(0.5, 40.0, 30, dtype=np.float32) + 3.0
    scaler = scaler_fit(x_raw)
    xs = ((torch.from_numpy(x_raw) - scaler.mean) / scaler.scale).numpy()
    m = gbt.gbt_fit(xs, y, gbt.GBTConfig(n_trees=5, max_depth=3, n_bins=32), device="cpu")
    folded = gbt.fold_scaler_into_gbt(m, scaler)
    raw_bins = gbt.bin_features(torch.from_numpy(x_raw), folded.bin_edges)
    scaled_bins = gbt.bin_features(torch.from_numpy(xs), m.bin_edges)
    assert (raw_bins != scaled_bins).float().mean() < 1e-3  # edge-rounding only
    jm = jgbt.GBTModel(*map(jnp.asarray, m))
    jfold = jgbt.fold_scaler_into_gbt(jm, jax_scaler_fit(x_raw)._replace(
        mean=jnp.asarray(scaler.mean.numpy()), scale=jnp.asarray(scaler.scale.numpy())))
    assert folded.bin_edges.numpy().tobytes() == np.asarray(jfold.bin_edges).tobytes()
    np.testing.assert_allclose(
        gbt.gbt_predict_proba(folded, torch.from_numpy(x_raw)).numpy(),
        np.asarray(jgbt.gbt_predict_proba(jfold, x_raw)), rtol=0, atol=1e-6,
    )
