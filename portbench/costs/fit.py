"""One whole fit of the histogram booster on the device (the host's
binning is not device work and is not counted), per tree over n rows of
d, ``trees`` trees of ``depth``, ``n_bins`` bins:

- the loss's gradients: the sigmoid (4 a row), g = w·(p − y) (2), h =
  max(w·p·(1 − p), 1e-16)·sign(w) (5), and the margin update (2): 13n;
- a level at 2^l nodes: the histograms (2 adds a (row, feature)), the
  gains over its d·2^l·n_bins cells (two cumulative sums, the right sides
  2, the three score terms 9, the gain 4, the validity 3, the masked max
  and argmax 2: 22 a cell), the row's decision and next node (4 a row);
- the leaf sums (2n) and values (3 a leaf).

Bytes are not counted: a fit's step is not one kernel."""


def cost(n: int, d: int, trees: int, depth: int, n_bins: int) -> tuple[int, int]:
    per_tree = 13 * n + 2 * n + 3 * (1 << depth)
    for level in range(depth):
        per_tree += 2 * n * d + 22 * d * (1 << level) * n_bins + 4 * n
    return trees * per_tree, 0
