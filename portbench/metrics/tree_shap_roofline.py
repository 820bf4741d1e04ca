"""``tree_shap``'s share of its roofline in the traced stretch, %: its
calls' least time (``costs/tree_shap``: L·D compares and adds a (row,
tree), the inputs read and φ written once, at the published peaks) over
their device time (both of its kernels, by name in the trace). A call
scores a flush's bucket of rows."""

from portbench.metrics._trace import kernel_roofline, least


def read(run):
    m, d = run.cfg["model"], run.cfg["data"]["d"]
    cost = run.cost("tree_shap").cost

    def call(b, pk):
        return least(cost(n=b, d=d, trees=m["n_trees"], depth=m["max_depth"]), pk)

    return kernel_roofline(run, "tree_shap_groups", "tree_shap_", call)
