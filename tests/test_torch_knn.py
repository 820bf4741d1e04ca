"""The k-NN kernel's selection arithmetic on the CPU: the packed (d2, index)
keys, the split of the keys over blocks and the merge of the splits
(``kernels.knn_topk_split_reference``) against the plain version
(``kernels.knn_topk_reference``) and the JAX package's ``_knn_indices``.

The kernel itself runs only on the card (tests/test_torch_cuda.py,
``chip_smoke.py`` and ``python -m fraud_detection_tpu_torch.knn_topk_turns``
hold it against the plain version and the earlier kernel); here the way it
selects and merges is held to the plain version's rule: ascending by d2,
equal distances (−0.0 equal to +0.0) to the lower index, self excluded."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from fraud_detection_tpu.ops.smote import _knn_indices as jax_knn_indices
from fraud_detection_tpu_torch.ops import kernels

torch.set_num_threads(1)


def _centred(x: np.ndarray):
    xt = torch.from_numpy(x)
    xc = (xt - xt.mean(dim=0)).contiguous()
    return xc, (xc * xc).sum(dim=1)


def _gauss(m: int, d: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((m, d)).astype(np.float32)


@pytest.mark.parametrize(
    "m, d, k, splits, tile",
    [
        (158, 30, 5, 5, 32),   # the final fit's m, five 32-key splits
        (126, 30, 5, 4, 32),   # a fold's m
        (158, 30, 5, 3, 32),   # splits that do not divide the tiles
        (100, 30, 5, 7, 32),   # more splits than tiles: empty splits
        (1025, 30, 5, 9, 128),  # 128-key tiles, a one-row last tile
        (257, 30, 5, 2, 32),
        (300, 7, 1, 6, 32),    # k = 1
        (200, 30, 32, 3, 32),  # k = 32
        (6, 30, 5, 1, 32),     # m = k + 1
        (33, 128, 32, 2, 32),  # m = k + 1 at k = 32, d = 128
        (500, 1, 5, 4, 32),    # d = 1
    ],
)
def test_split_reference_equals_the_plain_version(m, d, k, splits, tile):
    xc, sq = _centred(_gauss(m, d, m + d + k))
    got = kernels.knn_topk_split_reference(xc, sq, k, splits, tile)
    assert got.dtype == torch.int32 and got.shape == (m, k)
    assert torch.equal(got, kernels.knn_topk_reference(xc, sq, k))


def _duplicated() -> np.ndarray:
    base = _gauss(40, 30, 12)
    return np.concatenate([base, base, base[:29]])


def _lattice() -> np.ndarray:
    half = np.random.default_rng(11).integers(-3, 4, (150, 30))
    return np.concatenate([half, -half]).astype(np.float32)


@pytest.mark.parametrize("fixture", ["duplicated", "lattice"])
@pytest.mark.parametrize("splits", [1, 2, 3, 7])
def test_split_reference_keeps_the_tie_order(fixture, splits):
    """Rows at distance exactly 0 (duplicates) and exact integer ties (the
    lattice) go to the lower index in every split, as in the plain version
    and the JAX package's XLA path."""
    x = _duplicated() if fixture == "duplicated" else _lattice()
    xc, sq = _centred(x)
    got = kernels.knn_topk_split_reference(xc, sq, 5, splits)
    assert torch.equal(got, kernels.knn_topk_reference(xc, sq, 5))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_knn_indices(x, 5)))


def _hand_made_d2() -> torch.Tensor:
    """A (9, 9) distance matrix with −0.0 beside +0.0, negative entries
    (cancellation between near-duplicate rows) and repeated values."""
    z, n = 0.0, -0.0
    rows = [
        [9.0, n, z, -1e-7, 2.0, n, -1e-7, 3.0, z],
        [n, 9.0, -2.0, -2.0, z, n, 1.0, 1.0, -0.0],
        [z, -2.0, 9.0, n, n, z, -3.0, 5.0, -3.0],
        [-1e-7, -2.0, n, 9.0, 1e-30, -1e-30, 0.5, n, 0.5],
        [2.0, z, n, 1e-30, 9.0, z, n, -1.0, 4.0],
        [n, n, z, -1e-30, z, 9.0, z, n, z],
        [-1e-7, 1.0, -3.0, 0.5, n, z, 9.0, -1e-7, -1e-7],
        [3.0, 1.0, 5.0, n, -1.0, n, -1e-7, 9.0, 1.0],
        [z, n, -3.0, 0.5, 4.0, z, -1e-7, 1.0, 9.0],
    ]
    return torch.tensor(rows, dtype=torch.float32)


@pytest.mark.parametrize("k", [1, 3, 5, 8])
@pytest.mark.parametrize("splits, tile", [(1, 32), (2, 4), (3, 2), (4, 2), (5, 1)])
def test_selection_on_signed_zeros_and_negative_distances(k, splits, tile):
    d2 = _hand_made_d2()
    ids = torch.arange(d2.shape[0])
    want = kernels.knn_select_reference(d2.clone(), ids, k)
    got = kernels.knn_select_split_reference(d2, k, splits, tile)
    assert torch.equal(got, want)
    # row 5: its one negative entry, then −0.0 and +0.0 tied in index order
    if k >= 5:
        assert got[5, :5].tolist() == [3, 0, 1, 2, 4]


def test_empty_slot_is_above_every_candidate():
    big = kernels.knn_pack_keys(torch.tensor([float("inf")]), torch.tensor([2**31 - 2]))
    assert int(big) < kernels.KNN_EMPTY_KEY
    empty = kernels.knn_pack_keys(torch.tensor([float("inf")]), torch.tensor([2**31 - 1]))
    assert int(empty) == kernels.KNN_EMPTY_KEY


def test_nan_distances_are_never_candidates():
    d2 = _hand_made_d2()
    d2[0, 1] = float("nan")
    got = kernels.knn_select_split_reference(d2, 8, 3, 2)
    assert 1 not in got[0].tolist()
    # seven candidates left: the eighth slot stays empty
    assert got[0].tolist() == [3, 6, 2, 5, 8, 4, 7, 2**31 - 1]


_floats = st.floats(width=32, allow_nan=False) | st.sampled_from(
    [0.0, -0.0, float("inf"), float("-inf"), 1e-45, -1e-45]
)
_index = st.integers(min_value=0, max_value=2**31 - 2)


@settings(max_examples=300, deadline=None)
@given(a=_floats, i=_index, b=_floats, j=_index)
def test_packed_order_is_the_distance_then_index_rule(a, i, b, j):
    ka, kb = (int(v) for v in kernels.knn_pack_keys(
        torch.tensor([a, b], dtype=torch.float32), torch.tensor([i, j])))
    fa, fb = np.float32(a), np.float32(b)
    assert (ka < kb) == bool(fa < fb or (fa == fb and i < j))
    assert (ka == kb) == bool(fa == fb and i == j)


def test_turns_script_refuses_without_a_card(monkeypatch, capsys):
    from fraud_detection_tpu_torch import knn_topk_turns

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert knn_topk_turns.main(["--earlier-source", "earlier.cu"]) == 2
    assert "needs a CUDA card" in capsys.readouterr().err


def test_ptxas_usage_reads_every_instantiation():
    """The resource lines nvcc prints with -Xptxas -v, as chip_smoke.py's
    phase 1 reads them for knn_topk's instantiations."""
    log = "\n".join([
        "ptxas info    : Compiling entry function '_Z5splitILi8EEv' for 'sm_90a'",
        "ptxas info    : Function properties for _Z5splitILi8EEv",
        "    24 bytes stack frame, 20 bytes spill stores, 36 bytes spill loads",
        "ptxas info    : Used 128 registers, used 1 barriers, 400 bytes cmem[0]",
        "ptxas info    : Compiling entry function '_Z5mergev' for 'sm_90a'",
        "ptxas info    : Function properties for _Z5mergev",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 32 registers, used 0 barriers, 380 bytes cmem[0]",
    ])
    assert kernels.ptxas_usage(log) == [
        {"function": "_Z5splitILi8EEv", "stack": 24, "spill_stores": 20,
         "spill_loads": 36, "registers": 128},
        {"function": "_Z5mergev", "stack": 0, "spill_stores": 0, "spill_loads": 0,
         "registers": 32},
    ]
    assert "-v" in kernels.NVCC_FLAGS
