"""The histogram booster of the ``XGBClassifier`` recipe in plain PyTorch,
float64, on any device: the judge of a fitted forest, and (in a lower
precision) the control that stands in for the program.

The recipe: quantile bin edges from at most 200,000 rows (a subsample
drawn with seed 0), bins = the count of edges below a value; per tree, the
logistic loss's g = p − y and h = max(p(1 − p), 1e-16); perfect trees
grown level by level, each node's split the (feature, bin) of the largest
gain ``½(G_L²/(H_L+λ) + G_R²/(H_R+λ) − G²/(H+λ)) − γ`` among splits with
both sides' hessian at least ``min_child_weight`` (first feature, then
first bin, among ties), a node with no positive gain sending every row
left; leaves ``−lr·G/(H+λ)``.

**Judging** (:meth:`Booster.judge`) follows the program's forest tree by
tree and level by level: at every node it computes the histogram and the
gains of the rows the forest routes there, from its own margins, and
reads how far the gain of the split the forest chose falls below the best
one, beyond what the program's float32 state can explain (as a share of
the node's score terms); it reads each leaf's gap to ``−lr·G/(H+λ)``;
then it routes the rows by the forest's split and adds its own leaf
values to its own margins. So a near-tie that float32 breaks the other
way costs nothing, and each tree is judged on the reference's state,
never the program's. The held-out rows are scored by the forest's splits
and the reference's leaves.

**Growing** (:meth:`Booster.grow`) takes each node's best split itself:
the control runs it with the gradients stored in bfloat16 and summed in
float32.
"""

from __future__ import annotations

import numpy as np
import torch

#: printed in place of an infinite gap (a chosen split that is not valid)
GAP_CAP = 1e30
#: float32's unit roundoff. The judge holds the program to the recipe
#: within twice the bound on how far the program's sums can lie from the
#: reference's (:meth:`Booster._gains`): each row's g and h differ by its
#: margin's drift (the program's margins carry its own leaves, in float32)
#: and by float32's p; a side is a float32 prefix sum of cells, each
#: rounded once from its fixed-point sum, and a sum of m nonzero cells,
#: added in any order, is off by at most m·u of the sum of magnitudes;
#: the right side is the total less the left, and carries both errors and
#: one rounding. The min_child_weight test and the gains are read within
#: those bounds.
F32_U = 2.0 ** -24


def recipe_edges(x: np.ndarray, n_bins: int, max_sample: int = 200_000) -> np.ndarray:
    x = np.asarray(x, np.float32)
    n = x.shape[0]
    if n > max_sample:
        x = x[np.random.default_rng(0).choice(n, max_sample, replace=False)]
    qs = np.linspace(0.0, 1.0, n_bins + 1)[1:-1]
    edges = np.quantile(x, qs, axis=0).T.astype(np.float32)
    return np.maximum.accumulate(edges, axis=1)


def bin_rows(x: np.ndarray, edges: np.ndarray) -> np.ndarray:
    """(n, d) int64 bin ids: the count of edges strictly below the value."""
    x = np.asarray(x, np.float32)
    return np.stack([np.searchsorted(edges[j], x[:, j], side="left")
                     for j in range(x.shape[1])], axis=1).astype(np.int64)


class Booster:
    def __init__(self, x: np.ndarray, y: np.ndarray, model: dict, device="cpu",
                 dtype=torch.float64, grad_dtype=None):
        self.model = model
        self.dev = torch.device(device)
        self.dtype = dtype
        self.grad_dtype = grad_dtype or dtype
        self.nb = int(model["n_bins"])
        self.edges = recipe_edges(x, self.nb)
        bins = torch.from_numpy(bin_rows(x, self.edges)).to(self.dev)
        self.n, self.d = bins.shape
        self.bins = bins
        self.bin_off = bins + torch.arange(self.d, device=self.dev)[None, :] * self.nb
        self.y = torch.as_tensor(np.asarray(y), dtype=dtype, device=self.dev)
        base = model.get("base_score", 0.5)
        self.base = float(np.float32(np.log(base / (1.0 - base))))
        self.depth = int(model["max_depth"])

    # -- one tree ------------------------------------------------------------

    def _grad(self, margin, drift: float = 0.0):
        """g and h of every row, and bounds on how far the program's float32
        g and h of the row lie from these when its margin is off by at most
        ``drift``: dp / d margin = h, and d ln h / d margin = 1 − 2p lies in
        [−1, 1]; float32's p adds 2u·p, p − y u·|g|, and p(1 − p) 3u·h and
        2u·p² (1 − p rounded near 1)."""
        p = torch.sigmoid(margin)
        g = p - self.y
        h = torch.clamp_min(p * (1.0 - p), 1e-16)
        err = {"g": drift * np.exp(drift) * h + F32_U * (2 * p + g.abs()),
               "h": (np.expm1(drift) + 3 * F32_U) * h + 2 * F32_U * p * p}
        # the control stores them narrower, and sums them at ``dtype``
        return g.to(self.grad_dtype).to(self.dtype), h.to(self.grad_dtype).to(self.dtype), err

    def _hist(self, local, n_nodes, v):
        key = (local[:, None] * (self.d * self.nb) + self.bin_off).reshape(-1)
        out = torch.zeros(n_nodes * self.d * self.nb, dtype=self.dtype, device=self.dev)
        out.index_add_(0, key, v[:, None].expand(self.n, self.d).reshape(-1))
        return out.reshape(n_nodes, self.d, self.nb)

    def _sides(self, local, n_nodes, v, err, m_l):
        """A quantity's left, right and total sums at every (node, feature,
        bin), and twice the bound on the program's float32 error of each:
        the rows' own errors (``err``) and the sums' roundings (F32_U)."""
        left = torch.cumsum(self._hist(local, n_nodes, v), dim=2)
        total = left[..., -1:]
        right = total - left
        mag = torch.cumsum(self._hist(local, n_nodes, v.abs()), dim=2)
        e = torch.cumsum(self._hist(local, n_nodes, err), dim=2)
        m_t = m_l[..., -1:]
        e_l = 2.0 * (e + F32_U * m_l * mag)
        e_t = 2.0 * (e[..., -1:] + F32_U * m_t * mag[..., -1:])
        e_r = 2.0 * (e[..., -1:] - e + F32_U * (m_t * mag[..., -1:] + m_l * mag + right.abs()))
        return (left, right, total), (e_l, e_r, e_t)

    def _gains(self, local, n_nodes, g, h, err, growing: bool):
        """Every candidate's gain (−inf where min_child_weight refuses it
        beyond doubt), each node's best over the candidates valid beyond
        doubt, its (feature·bin) index, the node's scale, and a bound on
        the program's float32 error of every candidate's gain. A hessian
        side closer to min_child_weight than its error bound is on the
        boundary: either verdict on it is sound."""
        lam, gamma, mcw = (float(self.model[k]) for k in
                           ("reg_lambda", "gamma", "min_child_weight"))
        # h > 0 on every row (the floor), so a cell holds rows iff h's does
        m_l = torch.cumsum((self._hist(local, n_nodes, h) > 0).to(self.dtype), dim=2)
        (gl, gr, gt), eg = self._sides(local, n_nodes, g, err["g"], m_l)
        (hl, hr, ht), eh = self._sides(local, n_nodes, h, err["h"], m_l)
        sl, sr, st = gl * gl / (hl + lam), gr * gr / (hr + lam), gt * gt / (ht + lam)
        raw = 0.5 * (sl + sr - st) - gamma

        def score_err(gs, hs, e_g, e_h):  # of G²/(H+λ) with G, H off by e_g, e_h
            d = hs + lam - e_h
            bound = (2 * gs.abs() * e_g + e_g * e_g) / d + gs * gs * e_h / ((hs + lam) * d)
            return torch.where(d > 0, bound, torch.full_like(bound, torch.inf))

        gain_err = 0.5 * sum(score_err(*a) for a in zip((gl, gr, gt), (hl, hr, ht), eg, eh))
        gain_err = gain_err + 4 * F32_U * (sl + sr + st)
        sure = (hl >= mcw + eh[0]) & (hr >= mcw + eh[1])
        maybe = (hl >= mcw - eh[0]) & (hr >= mcw - eh[1])
        if growing:  # the booster's own choice takes the rule as it stands
            sure = (hl >= mcw) & (hr >= mcw)
        sure[..., -1] = False
        maybe[..., -1] = False
        ninf = torch.full_like(raw, -torch.inf)
        flat = torch.where(sure, raw, ninf).reshape(n_nodes, -1)
        best, arg = flat.max(dim=1)  # first (feature, bin) among ties
        # each node's magnitude: its score terms at the best split
        terms = (sl + sr).reshape(n_nodes, -1).gather(1, arg[:, None])[:, 0]
        scale = st[:, 0, 0] + torch.where(torch.isfinite(best), terms, 0.0)
        return torch.where(maybe, raw, ninf), best, arg, scale, gain_err

    def _tree(self, margin, split_feature=None, split_bin=None, drift: float = 0.0):
        """One tree on the current margins. Given the forest's splits for
        this tree (internal nodes, heap order) it follows them and returns
        the worst split gap, with the program's margins at most ``drift``
        from these; else it chooses its own. Returns (feature, bin, leaf
        values, row leaf, split gap)."""
        g, h, err = self._grad(margin, drift)
        internal = (1 << self.depth) - 1
        node = torch.zeros(self.n, dtype=torch.int64, device=self.dev)
        feat = torch.zeros(internal, dtype=torch.int64, device=self.dev)
        thr = torch.full((internal,), self.nb - 1, dtype=torch.int64, device=self.dev)
        gap = torch.zeros((), dtype=self.dtype, device=self.dev)
        rows = torch.arange(self.n, device=self.dev)
        for level in range(self.depth):
            base, n_nodes = (1 << level) - 1, 1 << level
            local = node - base
            gain, best, arg, scale, gain_err = self._gains(local, n_nodes, g, h, err,
                                                            split_feature is None)
            if split_feature is None:
                split = best > 0.0
                f = torch.where(split, arg // self.nb, 0)
                b = torch.where(split, arg % self.nb, self.nb - 1)
            else:
                f = split_feature[base:base + n_nodes].long()
                b = split_bin[base:base + n_nodes].long()
                passthrough = b >= self.nb - 1
                at = (torch.arange(n_nodes, device=self.dev), f, b.clamp_max(self.nb - 1))
                chosen = torch.where(passthrough, 0.0, gain[at])
                # a shortfall within the two gains' error bounds is a
                # near-tie the program's float32 state may break either way
                slack = torch.where(passthrough, 0.0, gain_err[at])
                slack = slack + torch.where(best > 0.0,
                                            gain_err.reshape(n_nodes, -1).gather(
                                                1, arg[:, None])[:, 0], 0.0)
                shortfall = torch.clamp_min(best, 0.0) - chosen - slack
                tiny = torch.finfo(self.dtype).tiny
                node_gap = torch.where(shortfall > 0, shortfall / scale.clamp_min(tiny),
                                       torch.zeros_like(shortfall))
                gap = torch.maximum(gap, node_gap.max())
            feat[base:base + n_nodes] = f
            thr[base:base + n_nodes] = b
            right = self.bins[rows, f[local]] > b[local]
            node = 2 * node + 1 + right.long()
        leaves = 1 << self.depth
        row_leaf = node - internal
        lam, lr = float(self.model["reg_lambda"]), float(self.model["learning_rate"])
        gs = torch.zeros(leaves, dtype=self.dtype, device=self.dev).index_add_(0, row_leaf, g)
        hs = torch.zeros(leaves, dtype=self.dtype, device=self.dev).index_add_(0, row_leaf, h)
        leaf = torch.where(hs > 0, -gs / (hs + lam), torch.zeros_like(gs)) * lr
        return feat, thr, leaf, row_leaf, gap

    # -- the two uses --------------------------------------------------------

    def grow(self) -> dict:
        """The booster's own forest, in the layout of the program's."""
        margin = torch.full((self.n,), self.base, dtype=self.dtype, device=self.dev)
        feats, thrs, leaves = [], [], []
        for _ in range(int(self.model["n_trees"])):
            f, b, leaf, row_leaf, _ = self._tree(margin)
            margin = margin + leaf[row_leaf]
            feats.append(f)
            thrs.append(b)
            leaves.append(leaf)
        return {
            "split_feature": torch.stack(feats).to(torch.int32).cpu().numpy(),
            "split_bin": torch.stack(thrs).to(torch.int32).cpu().numpy(),
            "leaf_value": torch.stack(leaves).float().cpu().numpy(),
            "bin_edges": self.edges,
            "base_logit": np.float32(self.base),
        }

    def judge(self, forest: dict, x_test: np.ndarray, p_test: np.ndarray) -> dict:
        """The numbers that decide a fit: ``edges_gap`` (the forest's bin
        edges against the recipe's), ``split_gap`` (the worst node's gain
        shortfall), ``leaf_gap`` (the worst leaf against −lr·G/(H+λ) of the
        rows the forest routes there) and ``heldout_gap`` (the worst
        held-out row's P(fraud), ``p_test`` the program's, against the
        forest's splits with the reference's leaves)."""
        sf = torch.as_tensor(np.asarray(forest["split_feature"]), device=self.dev)
        sb = torch.as_tensor(np.asarray(forest["split_bin"]), device=self.dev)
        lv = np.asarray(forest["leaf_value"], np.float64)
        edges = np.asarray(forest["bin_edges"], np.float32)
        edges_gap = (float(np.abs(edges - self.edges).max())
                     if edges.shape == self.edges.shape else GAP_CAP)
        margin = torch.full((self.n,), self.base, dtype=self.dtype, device=self.dev)
        split_gap = leaf_gap = 0.0
        ref_leaves = []
        # how far the program's margins can lie from these: the leaves'
        # gaps so far, and a float32 rounding of each tree's add
        leaf_drift = 0.0
        for t in range(sf.shape[0]):
            drift = leaf_drift + (t + 1) * F32_U * (float(margin.abs().max()) + leaf_drift)
            _, _, leaf, row_leaf, gap = self._tree(margin, sf[t], sb[t], drift)
            margin = margin + leaf[row_leaf]
            split_gap = max(split_gap, float(gap))
            ref = leaf.cpu().numpy()
            tree_gap = float(np.abs(lv[t] - ref).max())
            leaf_gap = max(leaf_gap, tree_gap)
            leaf_drift += tree_gap
            ref_leaves.append(ref)
        held = {
            "split_feature": np.asarray(forest["split_feature"]),
            "split_bin": np.asarray(forest["split_bin"]),
            "leaf_value": np.stack(ref_leaves), "bin_edges": self.edges,
            "base_logit": self.base,
        }
        from portbench.reference.forest import forest_margin

        # the recipe's rule: x > edge goes right, in bins; on the edges the
        # reference made
        p_ref = 1.0 / (1.0 + np.exp(-forest_margin(held, x_test)))
        heldout_gap = float(np.abs(np.asarray(p_test, np.float64) - p_ref).max())
        return {"edges_gap": edges_gap, "split_gap": min(split_gap, GAP_CAP),
                "leaf_gap": min(leaf_gap, GAP_CAP), "heldout_gap": heldout_gap}
