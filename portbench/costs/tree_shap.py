"""Exact interventional TreeSHAP over n rows of a forest of ``trees``
perfect trees of ``depth`` against a background: per (row, tree) a
compare and an add for each of the L·D (leaf, level) pairs, L = 2^depth
(the port's ``telemetry/roofline.tree_shap_ops``). Bytes: the rows' bin
ids (int32) read once; the forest (split feature and bin an internal
node, int32, and a leaf value, f32) and the background's expectation
factors (a float for each (tree, leaf, level subset), 2^depth subsets)
read once; φ (n, d) f32 written once."""


def cost(n: int, d: int, trees: int, depth: int) -> tuple[int, int]:
    leaves = 1 << depth
    internal = leaves - 1
    ops = 2 * n * trees * leaves * depth
    nbytes = (4 * n * d + trees * (8 * internal + 4 * leaves)
              + 4 * trees * leaves * (1 << depth) + 4 * n * d)
    return ops, nbytes
