"""The ``gbt_hist`` kernel's arithmetic on the CPU: its fixed-point model
(``kernels.gbt_hist_fixed_point_reference`` — the power-of-two quantum per
channel, g and h rounded away from zero to int64 multiples of it, int64 sums,
one float32 rounding) against float64 sums and the JAX package's exact-f32
``_hist_segment``, and the properties the fit leans on: a floored hessian
still adds, no int64 cell can overflow, zero weights give zero cells. The
card's bitwise check against the same model is in ``test_torch_cuda.py``."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from fraud_detection_tpu.ops import gbt as jgbt
from fraud_detection_tpu_torch.ops import kernels

torch.set_num_threads(1)


def _inputs(seed: int, n: int, d: int, n_nodes: int, n_bins: int):
    rng = np.random.default_rng(seed)
    binned = rng.integers(0, n_bins, (n, d)).astype(np.uint8)
    local = rng.integers(0, n_nodes, (n,)).astype(np.int32)
    g = rng.standard_normal(n).astype(np.float32)
    h = (rng.random(n) * 0.25).astype(np.float32)
    return binned, local, g, h


def _float64_sums(binned, local, g, h, n_nodes: int, n_bins: int):
    """(sum, Σ|value|) per cell in float64, (d, n_nodes, n_bins, 2)."""
    n, d = binned.shape
    want = np.zeros((d, n_nodes, n_bins, 2))
    absum = np.zeros_like(want)
    live = (local >= 0) & (local < n_nodes)
    for f in range(d):
        keep = live & (binned[:, f] < n_bins)
        for c, v in ((0, g), (1, h)):
            idx = (f, local[keep], binned[keep, f], c)
            np.add.at(want, idx, v[keep].astype(np.float64))
            np.add.at(absum, idx, np.abs(v[keep].astype(np.float64)))
    return want, absum


def _model(binned, local, g, h, n_nodes: int, n_bins: int):
    out, quanta = kernels.gbt_hist_fixed_point_reference(
        *(torch.from_numpy(a) for a in (binned, local, g, h)), n_nodes, n_bins
    )
    return out.numpy(), quanta


@pytest.mark.parametrize("n, d, n_bins, n_nodes", [(2048, 10, 64, 4), (1000, 5, 32, 4),
                                                   (777, 30, 16, 1), (513, 7, 64, 16)])
def test_fixed_point_model_matches_float64_and_segment(n, d, n_bins, n_nodes):
    """Within 1e-6·Σ|value| of the float64 sum (the kernel's tolerance on
    the card) and within 1e-5 of ``_hist_segment``, on the fixtures of the
    plain version's test in test_torch_gbt.py."""
    binned, local, g, h = _inputs(n + d, n, d, n_nodes, n_bins)
    got, quanta = _model(binned, local, g, h, n_nodes, n_bins)
    assert got.shape == (d, n_nodes, n_bins, 2) and got.dtype == np.float32
    want, absum = _float64_sums(binned, local, g, h, n_nodes, n_bins)
    assert np.all(np.abs(got - want) <= 1e-6 * absum)
    args = (jnp.asarray(binned, jnp.int32), jnp.asarray(local), jnp.asarray(g),
            jnp.asarray(h), n_nodes, n_bins)
    np.testing.assert_allclose(got, np.asarray(jgbt._hist_segment(*args)), rtol=0, atol=1e-5)
    for q, v in zip(quanta, (g, h)):
        assert q == 2.0 ** round(math.log2(q))
        assert n * float(np.abs(v).max()) / q < 2.0**62


@pytest.mark.parametrize("n", [1000, 31684])
def test_a_cell_of_floored_hessians_comes_out_positive(n):
    """The fit floors h at 1e-16 and sets a leaf only where H > 0: a cell
    whose rows all carry h = 1e-16, beside rows at h ≈ 0.25, still adds at
    least one quantum a row (rounding away from zero), where a
    round-to-nearest quantisation would give 0 once q > 2e-16."""
    rng = np.random.default_rng(n)
    leaf = rng.integers(0, 32, n).astype(np.uint8)[:, None]
    h = (0.2 + 0.05 * rng.random(n)).astype(np.float32)
    h[leaf[:, 0] == 0] = np.float32(1e-16)
    g = (rng.standard_normal(n) * 1e-3).astype(np.float32)
    local = np.zeros(n, np.int32)
    got, (_, qh) = _model(leaf, local, g, h, 1, 32)
    rows = int((leaf[:, 0] == 0).sum())
    assert rows > 0
    assert got[0, 0, 0, 1] > 0.0
    per_row = math.ceil(float(np.float32(1e-16)) / qh)  # 1 where q > 1e-16
    assert got[0, 0, 0, 1] == np.float32(rows * per_row * qh)
    want, absum = _float64_sums(leaf, local, g, h, 1, 32)
    assert np.all(np.abs(got[0, 0, 1:] - want[0, 0, 1:]) <= 1e-6 * absum[0, 0, 1:])


@pytest.mark.parametrize("max_abs", [100.0, 25.0, 1.0, 0.25, 1e-16, 3.4e38])
def test_no_int64_cell_can_overflow_at_the_largest_row_count(max_abs):
    """At n = 2^31 − 1 rows of weight up to ``scale_pos_weight`` ≈ 100 (the
    trainer's n_neg/n_pos on the committed CSV) and beyond: n·max/q < 2^62,
    and with one extra quantum a row from rounding up the sum stays below
    2^63; the quantum is a power of two no coarser than n·max·2^-61."""
    n = 2**31 - 1
    q, _ = kernels.gbt_hist_quanta(n, (max_abs, 0.0))
    assert q == math.ldexp(1.0, math.frexp(q)[1] - 1)
    assert n * max_abs / q < 2.0**62
    assert n * (max_abs / q + 1.0) < 2.0**63
    assert q <= n * max_abs * 2.0**-61


@pytest.mark.parametrize("inert", [False, True])
def test_all_zero_inputs_give_all_zero_cells(inert):
    n, d, n_nodes, n_bins = 600, 4, 2, 16
    binned, local, _, _ = _inputs(3, n, d, n_nodes, n_bins)
    if inert:
        local[::3] = -1
    z = np.zeros(n, np.float32)
    got, _ = _model(binned, local, z, z, n_nodes, n_bins)
    assert not got.any() and np.all(np.isfinite(got))


@pytest.mark.parametrize("bad", [np.nan, np.inf])
def test_a_non_finite_channel_comes_out_nan_and_leaves_the_other(bad):
    n, d, n_nodes, n_bins = 500, 3, 2, 8
    binned, local, g, h = _inputs(4, n, d, n_nodes, n_bins)
    g[17] = bad
    local[18] = -1
    g[18] = np.nan  # a row outside the level never counts
    got, (qg, _) = _model(binned, local, g, h, n_nodes, n_bins)
    assert math.isnan(qg) and np.isnan(got[..., 0]).all()
    clean, _ = _model(binned, local, np.zeros_like(g), h, n_nodes, n_bins)
    np.testing.assert_array_equal(got[..., 1], clean[..., 1])


@pytest.mark.parametrize("seed", [0, 1])
def test_model_bits_do_not_depend_on_the_row_order(seed):
    """Integer sums are associative: the same rows in another order give
    the same bits — which is what lets the kernel add in any order."""
    n, d, n_nodes, n_bins = 3000, 6, 4, 32
    binned, local, g, h = _inputs(seed, n, d, n_nodes, n_bins)
    g *= 100.0
    perm = np.random.default_rng(seed + 1).permutation(n)
    a, qa = _model(binned, local, g, h, n_nodes, n_bins)
    b, qb = _model(binned[perm], local[perm], g[perm], h[perm], n_nodes, n_bins)
    assert qa == qb
    np.testing.assert_array_equal(a, b)
