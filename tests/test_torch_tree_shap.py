"""The port's TreeSHAP (``ops/tree_shap.py``, the ``tree_shap`` kernel's
plain version and its compact tables) against the JAX package's on the
same forest and background: ``bg_table``/``expected_value``, the plain body
against JAX's XLA body (``use_kernel=False``) and its Pallas kernel
(``use_kernel=True``, interpreted), top-k index parity, additivity, and the
fused-vs-standalone bitwise contract inside the port."""

import importlib
from itertools import combinations
from math import factorial

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from fraud_detection_tpu.ops import gbt as jgbt
from fraud_detection_tpu.ops.linear_shap import topk_reasons as jax_topk
from fraud_detection_tpu_torch import convert
from fraud_detection_tpu_torch.monitor.drift import _topk_attributions
from fraud_detection_tpu_torch.ops import gbt, kernels
from fraud_detection_tpu_torch.ops import tree_shap as ts
from fraud_detection_tpu_torch.ops.linear_shap import topk_reasons

jts = importlib.import_module("fraud_detection_tpu.ops.tree_shap")

torch.set_num_threads(1)

PHI_RTOL, PHI_ATOL = 1e-4, 2e-5  # tests/test_tree_shap.py's kernel tolerance


def _forest(seed: int, depth: int, trees: int, d: int = 5, n: int = 400):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    y = (x[:, 0] + x[:, 1] * x[:, 2] > 0.2).astype(np.int32)
    jm = jgbt.gbt_fit(x, y, jgbt.GBTConfig(n_trees=trees, max_depth=depth,
                                           learning_rate=0.3, n_bins=16))
    pm = convert.gbt_from_arrays({f: np.asarray(getattr(jm, f)) for f in jm._fields})
    return x, jm, pm


def _compact_emulation(model, tables: kernels.TreeShapTables, binned: torch.Tensor) -> np.ndarray:
    """The kernel's arithmetic from its compact tables, vectorized in numpy:
    each leaf's pattern of failed levels, the ``leaf_sums`` lookup, the sum
    over the leaves below each node, and each feature's nodes in
    ``node_order`` — so the tables the card reads are checked here too.
    ``leaf_sums`` must equal the subset loop over the Shapley coefficients
    it folds."""
    b = binned.numpy()
    pf, pt, ls, no, ns, nc = (np.asarray(getattr(tables, k)) for k in (
        "path_feat", "path_thr", "leaf_sums", "node_order", "node_start", "node_count"))
    mask_bits, coef = (np.asarray(a) for a in ts._shapley_coefficients(model, tables.bg_table))
    n_trees, leaves, depth = pf.shape
    n, d = b.shape
    want_right = (np.arange(leaves)[:, None] >> (depth - 1 - np.arange(depth))[None, :]) & 1
    phi = np.zeros((n, d), np.float32)
    for t in range(n_trees):
        right = (b[:, pf[t]] > pt[t]).astype(np.int64)  # (n, L, D)
        viol = ((right != want_right) << np.arange(depth)).sum(axis=2)  # (n, L)
        ind = (viol[:, None, :] & mask_bits[t][None]) == 0  # (n, M, L)
        s_loop = np.einsum("nml,mkl->nlk", ind.astype(np.float32), coef[t])  # (n, L, D)
        s = ls[t][np.arange(leaves)[None, :], viol]  # (n, L, D)
        np.testing.assert_allclose(s, s_loop, rtol=1e-5, atol=1e-7)
        node_val = np.zeros((n, leaves - 1), np.float32)
        for k in range(depth):
            run = leaves >> k  # leaves below one node at level k
            node_val[:, 2**k - 1:2**(k + 1) - 1] = s[:, :, k].reshape(n, 2**k, run).sum(axis=2)
        for j in range(d):
            phi[:, j] += node_val[:, no[t, ns[t, j]:ns[t, j] + nc[t, j]]].sum(axis=1)
    return phi


def _assert_parity(got, want, k=3):
    np.testing.assert_allclose(got, want, rtol=PHI_RTOL, atol=PHI_ATOL)
    gi, _ = topk_reasons(torch.from_numpy(np.ascontiguousarray(got)), k)
    wi, _ = jax_topk(jnp.asarray(want), k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


def _brute_force_shap(predict_logits, x_row, background, d):
    """Interventional Shapley by full subset enumeration."""

    def v(subset):
        z = background.copy()
        for j in subset:
            z[:, j] = x_row[j]
        return float(np.mean(predict_logits(z)))

    phi = np.zeros(d)
    for i in range(d):
        others = [j for j in range(d) if j != i]
        for k in range(len(others) + 1):
            for s in combinations(others, k):
                w = factorial(len(s)) * factorial(d - len(s) - 1) / factorial(d)
                phi[i] += w * (v(set(s) | {i}) - v(set(s)))
    return phi


@pytest.mark.parametrize("depth, trees, n_rows", [(2, 1, 9), (3, 16, 33), (5, 100, 9)])
def test_plain_body_matches_jax_sweep(depth, trees, n_rows):
    """The sweep of tests/test_tree_shap.py: the port's plain body against
    JAX's XLA body and its Pallas kernel (interpreted) within rtol 1e-4 /
    atol 2e-5 with equal top-3 indices; the kernel's compact tables
    reproduce it; additivity Σφ + E[f] = f(x); brute-force exactness."""
    x, jm, pm = _forest(depth * 1000 + trees, depth, trees)
    bg = x[:8]
    je = jts.build_tree_explainer(jm, bg)
    pe = ts.build_tree_explainer(pm, bg)
    assert pe.tables is None  # a CPU explainer: nothing would read them
    assert pe.bg_table.numpy().tobytes() == np.asarray(je.bg_table).tobytes()
    assert float(pe.expected_value) == pytest.approx(float(je.expected_value), abs=1e-6)
    rows = x[100:100 + n_rows]
    xt = torch.from_numpy(rows)
    got = ts.tree_shap(pe, xt).numpy()
    xla = np.asarray(jts._raw_tree_shap(jm, je.bg_table, jnp.asarray(rows), use_kernel=False))
    pallas = np.asarray(jts._raw_tree_shap(jm, je.bg_table, jnp.asarray(rows), use_kernel=True))
    _assert_parity(got, xla)
    _assert_parity(got, pallas)
    binned = gbt.bin_features(xt, pm.bin_edges)
    tables = ts.build_tables(pm, pe.bg_table)
    _assert_parity(_compact_emulation(pm, tables, binned), got)
    assert torch.equal(kernels.tree_shap(binned, tables), ts.tree_shap(pe, xt))
    recon = got.sum(axis=1) + float(pe.expected_value)
    np.testing.assert_allclose(recon, gbt.gbt_predict_logits(pm, xt).numpy(), rtol=1e-3, atol=1e-4)

    def predict(z):
        return gbt.gbt_predict_logits(pm, torch.from_numpy(z.astype(np.float32))).numpy()

    for i in range(2):
        np.testing.assert_allclose(got[i], _brute_force_shap(predict, rows[i], bg, 5),
                                   rtol=1e-4, atol=1e-5)


def test_duplicate_feature_on_every_path():
    """Every node splits feature 0: the dup/canonical slaving confines the
    attribution to feature 0 and both packages agree."""
    rng = np.random.default_rng(11)
    trees, depth, d = 2, 3, 6
    nodes, leaves = 2**depth - 1, 2**depth
    arrays = dict(
        split_feature=np.zeros((trees, nodes), np.int32),
        split_bin=rng.integers(2, 14, size=(trees, nodes)).astype(np.int32),
        leaf_value=rng.standard_normal((trees, leaves)).astype(np.float32),
        bin_edges=np.sort(rng.standard_normal((d, 15)), axis=1).astype(np.float32),
        base_logit=np.float32(0.0),
    )
    jm = jgbt.GBTModel(**{k: jnp.asarray(v) for k, v in arrays.items()})
    pm = convert.gbt_from_arrays(arrays)
    bg = rng.standard_normal((16, d)).astype(np.float32)
    je, pe = jts.build_tree_explainer(jm, bg), ts.build_tree_explainer(pm, bg)
    rows = rng.standard_normal((9, d)).astype(np.float32)
    got = ts.tree_shap(pe, torch.from_numpy(rows)).numpy()
    _assert_parity(got, np.asarray(jts._raw_tree_shap(jm, je.bg_table, jnp.asarray(rows),
                                                      use_kernel=False)))
    _assert_parity(got, np.asarray(jts._raw_tree_shap(jm, je.bg_table, jnp.asarray(rows),
                                                      use_kernel=True)))
    assert np.all(got[:, 1:] == 0.0)
    tables = ts.build_tables(pm, pe.bg_table)
    assert tables.node_count[:, 1:].sum() == 0  # one run, feature 0
    binned = gbt.bin_features(torch.from_numpy(rows), pm.bin_edges)
    _assert_parity(_compact_emulation(pm, tables, binned), got)
    recon = got.sum(axis=1) + float(pe.expected_value)
    np.testing.assert_allclose(
        recon, gbt.gbt_predict_logits(pm, torch.from_numpy(rows)).numpy(), rtol=1e-4, atol=1e-5
    )


def test_background_table_on_the_recipe_width_and_carry_over(imbalanced_data):
    """d = 30, depth 5, a background subsampled from 300 rows by the seed:
    ``bg_table`` bitwise and ``expected_value`` within 1e-6 of the JAX
    package's; a JAX ``bg_table`` carried over explains identically."""
    x, y = imbalanced_data
    jm = jgbt.gbt_fit(x, y, jgbt.GBTConfig(n_trees=6, max_depth=5, n_bins=32))
    pm = convert.gbt_from_arrays({f: np.asarray(getattr(jm, f)) for f in jm._fields})
    je = jts.build_tree_explainer(jm, x[:300], max_background=64, seed=3)
    pe = ts.build_tree_explainer(pm, x[:300], max_background=64, seed=3)
    assert pe.bg_table.numpy().tobytes() == np.asarray(je.bg_table).tobytes()
    assert abs(float(pe.expected_value) - float(je.expected_value)) <= 1e-6
    carried = convert.tree_explainer_from_arrays(
        pm, np.asarray(je.bg_table), np.asarray(je.expected_value)
    )
    rows = torch.from_numpy(x[400:440])
    assert torch.equal(ts.tree_shap(carried, rows), ts.tree_shap(pe, rows))
    _assert_parity(ts.tree_shap(pe, rows).numpy(),
                   np.asarray(jts._raw_tree_shap(jm, je.bg_table, jnp.asarray(x[400:440]),
                                                 use_kernel=False)))


def test_background_subsample_seed(monkeypatch):
    x, jm, pm = _forest(5, 3, 4, d=6, n=300)
    a = ts.build_tree_explainer(pm, x, max_background=64, seed=0)
    b = ts.build_tree_explainer(pm, x, max_background=64, seed=1)
    assert not torch.equal(a.bg_table, b.bg_table)
    monkeypatch.setenv("EXPLAIN_BG_SEED", "1")
    assert torch.equal(ts.build_tree_explainer(pm, x, max_background=64).bg_table, b.bg_table)


def test_fused_reason_codes_are_bitwise_the_standalone_ones(imbalanced_data):
    """The fused flush's explain leg (``drift._topk_attributions``, GBT
    dispatch) and ``tree_shap_topk`` share one body: equal bits."""
    x, y = imbalanced_data
    pm = gbt.gbt_fit(x, y, gbt.GBTConfig(n_trees=8, max_depth=3, n_bins=32), device="cpu")
    pe = ts.build_tree_explainer(pm, x[:32])
    xf = torch.from_numpy(x[50:83])
    fi, fv = _topk_attributions(xf, pe, 3)
    si, sv = ts.tree_shap_topk(pe, xf, 3)
    assert torch.equal(fi, si) and torch.equal(fv, sv)
    assert fi.dtype == torch.int32 and fi.shape == (33, 3)
    np.testing.assert_allclose(ts.tree_shap_single(pe, xf[0]).numpy(),
                               ts.tree_shap(pe, xf[:1])[0].numpy(), rtol=0, atol=0)


def test_deeper_forests_take_the_plain_body(caplog):
    """Above the kernel's depth cap the explainer holds no kernel tables
    and the plain body runs (the JAX package's dispatch above depth 5)."""
    x, jm, pm = _forest(9, 6, 2, d=5, n=500)
    pe = ts.build_tree_explainer(pm, x[:16])
    assert pe.tables is None
    rows = x[200:207]
    je = jts.build_tree_explainer(jm, x[:16])
    got = ts.tree_shap(pe, torch.from_numpy(rows)).numpy()
    _assert_parity(got, np.asarray(jts._raw_tree_shap(jm, je.bg_table, jnp.asarray(rows))))
