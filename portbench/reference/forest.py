"""A static-depth forest's margin and its exact interventional TreeSHAP,
in NumPy float64, written from the definitions.

The forest (``split_feature``, ``split_bin``, ``leaf_value`` over trees,
nodes in heap order, ``bin_edges`` (d, n_bins − 1), ``base_logit``): a row
goes right at a node when its value exceeds the node's edge,
``bin_edges[f, split_bin]``; a ``split_bin`` past the last edge never goes
right.

TreeSHAP against a background set B: the forest is a sum of leaf
indicators, and Shapley values are linear in the game, so each leaf is
explained on its own. A leaf's indicator for the hybrid row that takes
features S from x and the rest from b is ``Π_j (A_j if j ∈ S else B_j)``
over the leaf path's distinct features j, where A_j (B_j) says whether x
(b) meets every condition the path puts on j. Its Shapley value for j is a
function of the two bit patterns A and B alone (:func:`pattern_shapley`,
enumerated from the definition); averaged over the background's patterns
of that leaf it gives a table a leaf, read at x's pattern.
"""

from __future__ import annotations

import functools
from math import factorial

import numpy as np


@functools.lru_cache(maxsize=None)
def tree_paths(depth: int) -> tuple[np.ndarray, np.ndarray]:
    """(ancestors (L, D), directions (L, D)): leaf l's internal node and
    its go-right bit at each level, heap order."""
    leaves = 1 << depth
    anc = np.zeros((leaves, depth), np.int64)
    direc = np.zeros((leaves, depth), bool)
    for leaf in range(leaves):
        node = 0
        for k in range(depth):
            bit = (leaf >> (depth - 1 - k)) & 1
            anc[leaf, k] = node
            direc[leaf, k] = bool(bit)
            node = 2 * node + 1 + bit
    return anc, direc


@functools.lru_cache(maxsize=None)
def pattern_shapley(u: int) -> np.ndarray:
    """``G[a, b, j]`` (2^u, 2^u, u): player j's Shapley value in the u-player
    game ``v(S) = Π_{i∈S} a_i Π_{i∉S} b_i`` for bit patterns a and b,
    ``Σ_{S ∌ j} |S|!(u−|S|−1)!/u! · (v(S ∪ j) − v(S))``."""
    pats = np.arange(1 << u)
    bits = (pats[:, None] >> np.arange(u)[None, :]) & 1  # (P, u)
    # v[a, b, S]
    take_a = bits[None, None, :, :].astype(bool)  # S's members
    va = bits[:, None, None, :]
    vb = bits[None, :, None, :]
    v = np.where(take_a, va, vb).prod(axis=3).astype(np.float64)  # (P, P, P)
    g = np.zeros((1 << u, 1 << u, u))
    size = bits.sum(axis=1)
    for j in range(u):
        for s in pats[bits[:, j] == 0]:
            w = factorial(size[s]) * factorial(u - size[s] - 1) / factorial(u)
            g[:, :, j] += w * (v[:, :, s | (1 << j)] - v[:, :, s])
    return g


def _thresholds(w: dict) -> np.ndarray:
    """(T, I) float64 edges of every node; +inf where the split never goes
    right."""
    edges = np.asarray(w["bin_edges"], np.float64)
    sf, sb = np.asarray(w["split_feature"]), np.asarray(w["split_bin"])
    n_edges = edges.shape[1]
    thr = edges[sf, np.minimum(sb, n_edges - 1)]
    return np.where(sb >= n_edges, np.inf, thr)


def _right(w: dict, thr: np.ndarray, t: int, x: np.ndarray) -> np.ndarray:
    """(n, I) bool: each row's go-right decision at each node of tree t."""
    return x[:, np.asarray(w["split_feature"][t], np.int64)] > thr[t][None, :]


def forest_margin(w: dict, x: np.ndarray) -> np.ndarray:
    """The forest's margin (n,) float64: base plus each tree's leaf."""
    x = np.asarray(x, np.float64)
    sf = np.asarray(w["split_feature"])
    trees, internal = sf.shape
    depth = (internal + 1).bit_length() - 1
    thr = _thresholds(w)
    n = x.shape[0]
    margin = np.full(n, float(w["base_logit"]))
    rows = np.arange(n)
    for t in range(trees):
        right = _right(w, thr, t, x)
        node = np.zeros(n, np.int64)
        for _ in range(depth):
            node = 2 * node + 1 + right[rows, node]
        margin += np.asarray(w["leaf_value"][t], np.float64)[node - internal]
    return margin


def _leaf_structure(sf_t: np.ndarray, anc: np.ndarray):
    """Per leaf: each level's slot among the path's distinct features (in
    order of first occurrence), the distinct count u, and each slot's
    feature (−1 past u)."""
    leaves, depth = anc.shape
    feats = sf_t[anc]  # (L, D)
    slot = np.zeros((leaves, depth), np.int64)
    u = np.zeros(leaves, np.int64)
    slot_feat = np.full((leaves, depth), -1, np.int64)
    for l in range(leaves):
        seen: list[int] = []
        for k in range(depth):
            f = int(feats[l, k])
            if f not in seen:
                seen.append(f)
            slot[l, k] = seen.index(f)
        u[l] = len(seen)
        slot_feat[l, :len(seen)] = seen
    return slot, u, slot_feat


def _patterns(right: np.ndarray, anc, direc, slot, u) -> np.ndarray:
    """(n, L) bit patterns: bit s set when the row meets every condition
    the leaf's path puts on its slot-s feature."""
    n = right.shape[0]
    leaves, depth = anc.shape
    ok = np.ones((n, leaves, depth), bool)
    lidx = np.arange(leaves)
    for k in range(depth):
        cond = right[:, anc[:, k]] == direc[None, :, k]  # (n, L)
        ok[:, lidx, slot[:, k]] &= cond
    live = np.arange(depth)[None, :] < u[:, None]  # (L, D)
    weights = np.where(live, 1 << np.arange(depth)[None, :], 0)
    return (ok * weights[None]).sum(axis=2)


def forest_shap(w: dict, x: np.ndarray) -> np.ndarray:
    """Exact interventional TreeSHAP φ (n, d) float64 in margin space
    against ``w["background"]``; ``Σ_j φ_j = margin(x) − mean_b margin(b)``."""
    x = np.asarray(x, np.float64)
    bg = np.asarray(w["background"], np.float64)
    sf = np.asarray(w["split_feature"], np.int64)
    trees, internal = sf.shape
    depth = (internal + 1).bit_length() - 1
    leaves = 1 << depth
    d = np.asarray(w["bin_edges"]).shape[0]
    anc, direc = tree_paths(depth)
    thr = _thresholds(w)
    tables = {u: pattern_shapley(u) for u in range(1, depth + 1)}
    phi = np.zeros((x.shape[0], d))
    lidx = np.arange(leaves)
    for t in range(trees):
        slot, u, slot_feat = _leaf_structure(sf[t], anc)
        px = _patterns(_right(w, thr, t, x), anc, direc, slot, u)  # (n, L)
        pb = _patterns(_right(w, thr, t, bg), anc, direc, slot, u)  # (nb, L)
        # h[l, a, s]: the leaf's Shapley value for slot s at x-pattern a,
        # averaged over the background's patterns, times the leaf value
        h = np.zeros((leaves, 1 << depth, depth))
        lv = np.asarray(w["leaf_value"][t], np.float64)
        for l in range(leaves):
            ul = int(u[l])
            freq = np.bincount(pb[:, l], minlength=1 << ul) / bg.shape[0]
            h[l, :1 << ul, :ul] = lv[l] * np.einsum("abs,b->as", tables[ul], freq)
        vals = h[lidx[None, :], px]  # (n, L, D)
        onehot = np.zeros((leaves, depth, d))
        live = slot_feat >= 0
        onehot[np.nonzero(live)[0], np.nonzero(live)[1], slot_feat[live]] = 1.0
        phi += vals.reshape(x.shape[0], -1) @ onehot.reshape(-1, d)
    return phi
