"""One fused serving flush over a bucket of n rows of d (the port's
``telemetry/roofline.flush_cost``, shape for shape): the score (the
linear ``fused_score``, or a forest's compares and leaf adds and the
sigmoid), the explain leg (linear n·d; TreeSHAP's L·D a (row, tree)) and
the drift window's fold (a compare an (element, interior edge), a
weighted add an element, the same for the score, the decay's multiply-add
on every window cell). Bytes: the rows at ``elem_bytes`` and the valid
mask, the model's parameters, the window state and its edges, each read
once; the scores, the window state and the reason codes written once."""


def fused_score_cost(n: int, d: int, elem_bytes: int = 4) -> tuple[int, int]:
    return 2 * n * d + 4 * n, elem_bytes * n * d + 4 * d + 4 + 4 * n


def tree_shap_ops(n: int, trees: int, depth: int) -> int:
    return 2 * n * trees * (1 << depth) * depth


def forest_score_ops(n: int, trees: int, depth: int) -> int:
    return n * trees * (depth + 1) + 4 * n


def drift_fold_ops(n: int, d: int, feature_bins: int, score_bins: int) -> int:
    window = d * feature_bins + score_bins + 1
    return n * d * feature_bins + n * score_bins + 2 * window


def cost(n: int, d: int, *, feature_bins: int = 16, score_bins: int = 20,
         elem_bytes: int = 4, out_bytes: int = 4, explain_k: int = 0,
         forest: tuple[int, int, int] | None = None) -> tuple[float, float]:
    ops = 0
    nbytes = elem_bytes * n * d + 4 * n
    if forest is None:
        score_ops, _ = fused_score_cost(n, d, elem_bytes)
        ops += score_ops
        nbytes += 4 * d + 4
    else:
        trees, depth, n_bins = forest
        ops += forest_score_ops(n, trees, depth)
        internal, leaves = (1 << depth) - 1, 1 << depth
        nbytes += trees * (8 * internal + 4 * leaves) + 4 * d * (n_bins - 1) + 4
    if explain_k:
        if forest is None:
            ops += n * d
            nbytes += 4 * d
        else:
            ops += tree_shap_ops(n, forest[0], forest[1])
        idx_bytes = 1 if d <= 256 else 4
        val_bytes = 4 if out_bytes == 4 else 2
        nbytes += n * explain_k * (idx_bytes + val_bytes)
    ops += drift_fold_ops(n, d, feature_bins, score_bins)
    window = d * feature_bins + score_bins + 1
    nbytes += 2 * 4 * window + 4 * (d * (feature_bins - 1) + score_bins - 1)
    nbytes += out_bytes * n
    return float(ops), float(nbytes)
