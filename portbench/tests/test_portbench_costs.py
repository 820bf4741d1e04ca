"""The cost functions against counts made by hand at small shapes."""

from __future__ import annotations

from portbench import peaks, registry


def test_fused_score_counts_a_multiply_add_an_element():
    # 4 rows of 3: 2·12 multiply-adds + 4·4 (bias, exp, add, divide);
    # 48 B of rows, 12 B coef, 4 B bias, 16 B scores
    assert registry.cost("fused_score").cost(n=4, d=3) == (40, 80)
    assert registry.cost("fused_score").cost(n=4, d=3, elem_bytes=2) == (40, 56)


def test_tree_shap_counts_l_times_d_a_row_and_tree():
    # 2 rows, 3 trees of depth 2: L = 4 leaves, D = 2 → 2·2·3·4·2 = 96
    ops, nbytes = registry.cost("tree_shap").cost(n=2, d=5, trees=3, depth=2)
    assert ops == 96
    # bins 2·5·4 = 40; forest 3·(8·3 + 4·4) = 120; factors 4·3·4·4 = 192; φ 40
    assert nbytes == 40 + 120 + 192 + 40


def test_gbt_hist_reads_bins_and_gradients_once():
    ops, nbytes = registry.cost("gbt_hist").cost(n=10, d=2, n_nodes=4, n_bins=8)
    assert ops == 40
    # 20 B of bins, 40 B each of node, g, h, 8·2·4·8 B of histogram
    assert nbytes == 20 + 120 + 512
    plan = registry.cost("gbt_hist").fit_calls(n=10, d=2, trees=3, depth=2, n_bins=8)
    assert plan == [({"n": 10, "d": 2, "n_nodes": 1, "n_bins": 8}, 3),
                    ({"n": 10, "d": 2, "n_nodes": 2, "n_bins": 8}, 3),
                    ({"n": 10, "d": 1, "n_nodes": 1, "n_bins": 4}, 3)]


def test_fit_counts_gradients_levels_and_leaves():
    # n = 10, d = 2, one tree of depth 1, 4 bins: 13n + 2n + 3·2 = 156, the
    # level 2·10·2 + 22·2·1·4 + 4·10 = 256
    assert registry.cost("fit").cost(10, 2, 1, 1, 4) == (156 + 256, 0)


def test_flush_matches_its_parts():
    flush = registry.cost("flush")
    # a linear flush of 8 rows of 2, no explain, 2 feature bins, 2 score bins
    ops, nbytes = flush.cost(8, 2, feature_bins=2, score_bins=2)
    window = 2 * 2 + 2 + 1
    assert ops == (2 * 8 * 2 + 4 * 8) + (8 * 2 * 2 + 8 * 2 + 2 * window)
    assert nbytes == (4 * 16 + 32) + (8 + 4) + 2 * 4 * window + 4 * (2 * 1 + 1) + 32
    # the forest's explain leg adds TreeSHAP's count and the reason codes
    a, _ = flush.cost(8, 2, explain_k=0, forest=(3, 2, 16))
    b, _ = flush.cost(8, 2, explain_k=1, forest=(3, 2, 16))
    assert b - a == 2 * 8 * 3 * 4 * 2


def test_least_time_takes_the_larger_bound():
    pk = {"fp32_flops": 10.0, "hbm_bytes_per_s": 100.0}
    assert peaks.least_seconds(50, 100, pk) == 5.0
    assert peaks.least_seconds(5, 1000, pk) == 10.0
    assert peaks.peaks_for("NVIDIA H100 80GB HBM3")["fp32_flops"] == 67e12
    assert peaks.peaks_for("cpu") is None
