"""The port's data loader, split indices, scaler fit, k-NN plain version and
SMOTE against the JAX package on the same numpy inputs.

The k-NN kernel itself runs only on the card (tests/test_torch_cuda.py and
``chip_smoke.py`` hold it against ``knn_topk_reference``); here the plain
version is held against the JAX package's ``_knn_indices`` (the XLA path)
and its Pallas ``knn_topk`` in interpret mode."""

import os

import jax
import numpy as np
import pytest
import torch

from fraud_detection_tpu.data.loader import load_creditcard_csv as jax_load
from fraud_detection_tpu.data.loader import stratified_kfold_indices as jax_kfold
from fraud_detection_tpu.data.loader import stratified_split as jax_split
from fraud_detection_tpu.ops.pallas_kernels import knn_topk as jax_knn_pallas
from fraud_detection_tpu.ops.scaler import scaler_fit as jax_scaler_fit
from fraud_detection_tpu.ops.smote import _interpolate as jax_interpolate
from fraud_detection_tpu.ops.smote import _knn_indices as jax_knn_indices
from fraud_detection_tpu_torch.data.loader import (
    load_creditcard_csv,
    stratified_kfold_indices,
    stratified_split,
)
from fraud_detection_tpu_torch.ops import kernels
from fraud_detection_tpu_torch.ops.scaler import scaler_fit
from fraud_detection_tpu_torch.ops.smote import interpolate, smote, smote_draws

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSV = os.path.join(ROOT, "data", "creditcard.csv")


@pytest.fixture(scope="module")
def committed():
    return load_creditcard_csv(CSV)


def _centred(x: np.ndarray):
    xt = torch.from_numpy(x)
    xc = (xt - xt.mean(dim=0)).contiguous()
    return xc, (xc * xc).sum(dim=1)


def _port_knn(x: np.ndarray, k: int) -> np.ndarray:
    xc, sq = _centred(x)
    return kernels.knn_topk_reference(xc, sq, k).numpy()


def _lattice(n_half: int, d: int, seed: int) -> np.ndarray:
    """Integer points in [-3, 3]^d, closed under x → −x: the column mean is
    exactly 0 and every squared distance is an exact small integer in
    float32 under any summation order, so ties are exact ties everywhere."""
    half = np.random.default_rng(seed).integers(-3, 4, (n_half, d))
    return np.concatenate([half, -half]).astype(np.float32)


def _duplicated(seed: int) -> np.ndarray:
    base = np.random.default_rng(seed).standard_normal((40, 30)).astype(np.float32)
    return np.concatenate([base, base, base[:9]])


# ---------------------------------------------------------------------------
# loader, split and fold indices
# ---------------------------------------------------------------------------


def test_loader_matches_jax_on_the_committed_csv(committed):
    """Names and labels equal. Features within 1 ulp of float32: the port
    rounds each value once from float64, the JAX package's native parser
    may round the decimal string to float32 directly; the two agree on all
    but a handful of values, and those differ by 1 ulp."""
    x, y, names = committed
    jx, jy, jnames = jax_load(CSV)
    assert names == jnames
    assert x.dtype == np.float32 and y.dtype == np.int32
    assert x.shape == jx.shape == (20000, 30)
    np.testing.assert_array_equal(y, jy)
    ulp = np.abs(x.view(np.int32).astype(np.int64) - jx.view(np.int32).astype(np.int64))
    assert ulp.max() <= 1
    assert int(y.sum()) == 197


def test_split_and_fold_indices_equal_jax(committed):
    _, y, _ = committed
    for seed in (0, 42):
        tr, te = stratified_split(y, 0.2, seed)
        jtr, jte = jax_split(y, 0.2, seed)
        np.testing.assert_array_equal(tr, jtr)
        np.testing.assert_array_equal(te, jte)
        folds = list(stratified_kfold_indices(y[tr], 5, seed))
        jfolds = list(jax_kfold(y[tr], 5, seed))
        assert len(folds) == len(jfolds) == 5
        for (a, b), (ja, jb) in zip(folds, jfolds):
            np.testing.assert_array_equal(a, ja)
            np.testing.assert_array_equal(b, jb)
    # the committed data's default run: 158 minority rows in train
    tr, _ = stratified_split(y, 0.2, 42)
    assert int(y[tr].sum()) == 158


def test_scaler_fit_matches_jax(committed):
    """rtol 1e-6 on var and scale: both packages take the two-pass float32
    form and differ only in summation order. The means are held to 1e-6 of
    each column's scale: most V-columns have means of ~1e-3 or below, where
    the two summation orders' float32 rounding (~1e-8 absolute) is several
    1e-6 relative to the mean itself but ~1e-8 of the column's spread."""
    x, _, _ = committed
    got = scaler_fit(x)
    want = jax_scaler_fit(x)
    gap = np.abs(got.mean.numpy() - np.asarray(want.mean)) / np.asarray(want.scale)
    assert gap.max() <= 1e-6
    np.testing.assert_allclose(got.var.numpy(), np.asarray(want.var), rtol=1e-6)
    np.testing.assert_allclose(got.scale.numpy(), np.asarray(want.scale), rtol=1e-6)
    assert float(got.n_samples) == 20000.0


def test_scaler_fit_two_pass_keeps_a_high_mean_column():
    """The one-pass E[x²] − E[x]² form collapses this column's variance in
    float32; the two-pass fit keeps it, and a constant column scales by 1."""
    rng = np.random.default_rng(3)
    x = np.stack(
        [1e5 + rng.standard_normal(4096), np.full(4096, 7.0)], axis=1
    ).astype(np.float32)
    got = scaler_fit(x)
    assert got.scale[0] == pytest.approx(np.std(x[:, 0].astype(np.float64)), rel=1e-2)
    assert float(got.var[1]) == 0.0 and float(got.scale[1]) == 1.0


# ---------------------------------------------------------------------------
# k-NN: the plain version against the JAX package
# ---------------------------------------------------------------------------


def _fixture(name: str) -> tuple[np.ndarray, int]:
    if name.startswith("gauss"):
        m = int(name[5:])
        rng = np.random.default_rng(m)
        return rng.standard_normal((m, 30)).astype(np.float32), min(5, m - 1)
    if name == "lattice":
        return _lattice(60, 30, 11), 5
    if name == "duplicated":
        return _duplicated(12), 5
    raise KeyError(name)


@pytest.mark.parametrize(
    "name", ["gauss2", "gauss6", "gauss37", "gauss300", "lattice", "duplicated"]
)
def test_knn_reference_matches_jax_xla_path(name):
    x, k = _fixture(name)
    got = _port_knn(x, k)
    want = np.asarray(jax_knn_indices(x, k))
    assert got.dtype == np.int32 and got.shape == (x.shape[0], k)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize(
    "name", ["gauss2", "gauss6", "gauss37", "gauss300", "lattice", "duplicated"]
)
def test_knn_reference_matches_jax_pallas_interpret(name):
    x, k = _fixture(name)
    got = _port_knn(x, k)
    want = np.asarray(jax_knn_pallas(x, k, interpret=True))
    np.testing.assert_array_equal(got, want)


def test_knn_reference_on_the_csv_minority_rows(committed):
    """The real minority rows (197, scaled as training scales them) against
    the XLA path and the Pallas kernel in interpret mode."""
    x, y, _ = committed
    s = scaler_fit(x)
    xm = ((torch.from_numpy(x[y == 1]) - s.mean) / s.scale).numpy()
    got = _port_knn(xm, 5)
    np.testing.assert_array_equal(got, np.asarray(jax_knn_indices(xm, 5)))
    np.testing.assert_array_equal(got, np.asarray(jax_knn_pallas(xm, 5, interpret=True)))


def test_knn_lattice_ties_go_to_the_lowest_index():
    """Every row of the lattice has a mirror image; rows that repeat are at
    distance 0 from each other, and equal distances rank by index."""
    x = np.concatenate([_lattice(20, 4, 2), _lattice(20, 4, 2)])  # each row twice
    xc, sq = _centred(x)
    idx = kernels.knn_topk_reference(xc, sq, 6).numpy()
    x64 = x.astype(np.float64)
    for i in range(x.shape[0]):
        d2 = ((x64 - x64[i]) ** 2).sum(axis=1)
        d2[i] = np.inf
        want = np.lexsort((np.arange(x.shape[0]), d2))[:6]
        np.testing.assert_array_equal(idx[i], want)


def test_knn_reference_query_subset_and_blocks():
    x, k = _fixture("gauss300")
    xc, sq = _centred(x)
    full = kernels.knn_topk_reference(xc, sq, k)
    rows = torch.tensor([0, 17, 299, 5])
    assert torch.equal(kernels.knn_topk_reference(xc, sq, k, rows=rows), full[rows])
    assert torch.equal(kernels.knn_topk_reference(xc, sq, k, block=7), full)


def test_knn_wrapper_on_cpu_takes_the_plain_version_and_does_not_count():
    x, k = _fixture("gauss37")
    xc, sq = _centred(x)
    kernels.reset_launch_counts()
    got = kernels.knn_topk(xc, sq, k)
    assert torch.equal(got, kernels.knn_topk_reference(xc, sq, k))
    assert kernels.launch_counts()["knn_topk"] == 0


@pytest.mark.parametrize(
    "bad, match",
    [
        (dict(k=6), "k < m"),
        (dict(k=0), "k < m"),
        (dict(xc=torch.zeros(6, 3, dtype=torch.float64)), "float32 xc"),
        (dict(sq=torch.zeros(5)), r"sq \(m,\)"),
        (dict(xc=torch.zeros(1, 3), sq=torch.zeros(1), k=1), "m >= 2"),
    ],
)
def test_knn_wrapper_rejects_bad_inputs(bad, match):
    args = dict(xc=torch.zeros(6, 3), sq=torch.zeros(6), k=2)
    args.update(bad)
    with pytest.raises((TypeError, ValueError), match=match):
        kernels.knn_topk(args["xc"], args["sq"], args["k"])


def test_knn_kernel_source_names_what_it_replaces():
    assert "knn_topk" in kernels.kernel_names()
    src = (kernels.CSRC_DIR / "knn_topk.cu").read_text()
    assert "_knn_kernel" in src and "Bound on the H100" in src
    assert "kMaxK = 32" in src and "kMaxD = 128" in src
    assert (kernels.KNN_MAX_K, kernels.KNN_MAX_D) == (32, 128)


# ---------------------------------------------------------------------------
# SMOTE
# ---------------------------------------------------------------------------


def test_interpolation_seam_is_bitwise_equal_to_jax():
    """The port's interpolate fed the draws JAX's _interpolate makes from
    the same key (recomputed as ops/smote.py:74-77 makes them) gives the
    same rows bit for bit."""
    rng = np.random.default_rng(4)
    x_min = rng.standard_normal((57, 30)).astype(np.float32) * 3.0
    nn_idx = _port_knn(x_min, 5)
    n_synth, k = 1000, 5
    key = jax.random.key(9)
    want = np.asarray(jax_interpolate(x_min, nn_idx, key, n_synth))
    k_base, k_nn, k_gap = jax.random.split(key, 3)
    base = np.asarray(jax.random.randint(k_base, (n_synth,), 0, x_min.shape[0]))
    slot = np.asarray(jax.random.randint(k_nn, (n_synth,), 0, k))
    gap = np.asarray(jax.random.uniform(k_gap, (n_synth, 1), dtype=np.float32))
    got = interpolate(
        torch.from_numpy(x_min), torch.from_numpy(nn_idx),
        torch.from_numpy(base.copy()).long(), torch.from_numpy(slot.copy()).long(),
        torch.from_numpy(gap.copy()),
    ).numpy()
    assert got.tobytes() == want.tobytes()


def test_smote_class_counts_and_segments():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((600, 30)).astype(np.float32)
    y = np.zeros(600, np.int32)
    y[rng.choice(600, 41, replace=False)] = 1
    xs, ys = smote(x, y, seed=7)
    xs = xs.numpy()
    assert xs.shape == (2 * 559, 30) and ys.shape == (2 * 559,)
    assert int((ys == 1).sum()) == int((ys == 0).sum()) == 559
    np.testing.assert_array_equal(xs[:600], x)
    np.testing.assert_array_equal(ys[:600], y)
    # every synthetic row lies on the segment from its base row to one of
    # the base row's 5 nearest minority neighbours
    x_min = x[y == 1]
    nn = _port_knn(x_min, 5)
    base, slot, gap = smote_draws(41, 5, 559 - 41, 7)
    for r, b, s, g in zip(xs[600:], base.numpy(), slot.numpy(), gap.numpy()[:, 0]):
        a, e = x_min[b], x_min[nn[b, s]]
        np.testing.assert_allclose(r, a + g * (e - a), rtol=0, atol=1e-6)
        # on the segment: within the bounding box of its two ends
        assert np.all(r >= np.minimum(a, e) - 1e-6) and np.all(r <= np.maximum(a, e) + 1e-6)
        assert 0.0 <= g < 1.0


def test_smote_draws_are_reproducible_and_device_independent():
    a = smote_draws(158, 5, 15684, 1042)
    b = smote_draws(158, 5, 15684, 1042)
    for u, v in zip(a, b):
        assert torch.equal(u, v) and u.device.type == "cpu"
    assert int(a[0].max()) < 158 and int(a[1].max()) < 5


def test_smote_errors_and_small_minority_like_jax():
    x = np.zeros((10, 3), np.float32)
    with pytest.raises(ValueError, match="binary"):
        smote(x, np.zeros(10, np.int32), seed=0)
    y = np.zeros(10, np.int32)
    y[0] = 1
    with pytest.raises(ValueError, match="at least 2"):
        smote(x, y, seed=0)
    # n_min <= k_neighbors: k drops to n_min - 1
    rng = np.random.default_rng(1)
    x = rng.standard_normal((20, 3)).astype(np.float32)
    y = np.zeros(20, np.int32)
    y[:3] = 1
    xs, ys = smote(x, y, seed=0)
    assert xs.shape[0] == 34 and int(ys.sum()) == 17
    # already balanced: returned unchanged
    y = np.array([0, 1] * 10, np.int32)
    xs, ys = smote(x, y, seed=0)
    assert xs.shape[0] == 20
