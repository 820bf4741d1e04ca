"""One level's gradient and hessian histograms: n rows of d uint8 bin ids,
each row's node within the level (int32), g and h (f32) read once; two
adds a (row, feature); the (d, n_nodes, n_bins, 2) f32 histogram written
once. The leaf sums are the same call over one column of leaf ids, one
node and 2^depth bins."""


def cost(n: int, d: int, n_nodes: int, n_bins: int) -> tuple[int, int]:
    ops = 2 * n * d
    nbytes = n * d + 4 * n + 4 * n + 4 * n + 8 * d * n_nodes * n_bins
    return ops, nbytes


def fit_calls(n: int, d: int, trees: int, depth: int, n_bins: int) -> list[tuple[dict, int]]:
    """Each distinct call of a whole fit and how many times it runs: a
    level's histogram at 2^level nodes, and the leaf sums, once a tree."""
    calls = [({"n": n, "d": d, "n_nodes": 1 << level, "n_bins": n_bins}, trees)
             for level in range(depth)]
    calls.append(({"n": n, "d": 1, "n_nodes": 1, "n_bins": 1 << depth}, trees))
    return calls
