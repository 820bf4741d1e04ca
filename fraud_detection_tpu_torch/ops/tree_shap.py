"""Exact interventional TreeSHAP for the static-depth GBT forest.

The JAX package's ``ops/tree_shap.py`` in PyTorch. The forest is a sum of
leaf indicators and Shapley values are linear in the game, so each leaf's
indicator is explained on its own. A leaf's indicator is a conjunction of
``depth`` threshold conditions; the ``2^depth`` subsets of *levels* are
enumerated as bitmasks, levels sharing a feature slaved to its first
occurrence (``dup``), so every enumerated subset is feature-consistent.
The background factor ``E_b ∏_{k∉σ} c_k(b)`` does not depend on the
explained row and is precomputed once per explainer as
``bg_table[t, l, mask]``; Shapley weights ``|S|!(u−|S|−1)!/u!`` over the
``u ≤ depth`` distinct path features complete the sum.

Dispatch (``_raw_tree_shap``), the JAX package's rule: on the card, depth
≤ 5 (the kernel's cap) launches the hand-written CUDA kernel
(``kernels.tree_shap``) over the compact per-tree tables
(:func:`build_tables`), built once per explainer and cached on it; a CPU
explainer holds no tables and takes the plain version (the port of the JAX
XLA body), and a deeper forest takes that plain body on any device, as the
JAX package does above depth 5. The fused flush and the standalone
explainer share this one body, so serve-time reason codes are bitwise the
standalone ones.
"""

from __future__ import annotations

import functools
import logging
from math import factorial
from typing import NamedTuple

import numpy as np
import torch

from fraud_detection_tpu_torch.ops import kernels
from fraud_detection_tpu_torch.ops.gbt import GBTModel, bin_features
from fraud_detection_tpu_torch.ops.linear_shap import topk_reasons

log = logging.getLogger("fraud_detection_tpu_torch.tree_shap")


class TreeShapExplainer(NamedTuple):
    model: GBTModel
    bg_table: torch.Tensor  # (n_trees, n_leaves, n_masks) — E_b factors
    expected_value: torch.Tensor  # () — E_b[f(b)], margin space
    #: the kernel's compact tables (None on the CPU and above the kernel's
    #: depth cap: see :func:`kernel_tables`)
    tables: kernels.TreeShapTables | None = None


@functools.lru_cache(maxsize=8)
def _tree_static(depth: int):
    """Static path structure of a perfect binary tree: ancestor internal
    node and go-right direction per (leaf, level), the level-subset bit
    table, and each (mask, level)'s mask with that level added."""
    n_leaves = 2**depth
    anc = np.zeros((n_leaves, depth), np.int32)
    direc = np.zeros((n_leaves, depth), np.int32)
    for leaf in range(n_leaves):
        node = 0
        for j in range(depth):
            d = (leaf >> (depth - 1 - j)) & 1
            anc[leaf, j] = node
            direc[leaf, j] = d
            node = 2 * node + 1 + d
    masks = 2**depth
    bits = ((np.arange(masks)[:, None] >> np.arange(depth)[None, :]) & 1).astype(bool)
    pair = np.arange(masks)[:, None] | (1 << np.arange(depth))[None, :]
    return anc, direc, bits, pair.astype(np.int32)


def _shapley_weights(depth: int) -> np.ndarray:
    """W[u, s] = s!(u−1−s)!/u! — the weight of adding a player to an
    s-subset of a u-player game."""
    w = np.zeros((depth + 1, depth), np.float64)
    for u in range(1, depth + 1):
        for s in range(u):
            w[u, s] = factorial(s) * factorial(u - 1 - s) / factorial(u)
    return w


def _path_conditions(binned, feat, thr, direc):
    """Per-(row, leaf, level) truth of the path condition: ``binned``
    (..., d), ``feat``/``thr``/``direc`` (leaves, depth); the right child
    means ``bin > thr``."""
    gathered = binned[..., feat]  # (..., leaves, depth)
    return (gathered > thr) == (direc == 1)


def _dup_structure(feat):
    """For each (leaf, level k): the first level with the same feature
    (``dup``), whether k is that first occurrence (``canonical``), and the
    distinct-feature count u per leaf."""
    depth = feat.shape[1]
    eq = feat[:, :, None] == feat[:, None, :]  # (leaves, k, j)
    dup = torch.argmax(eq.to(torch.int32), dim=2)  # first j with an equal feature
    canonical = dup == torch.arange(depth, device=feat.device)[None, :]
    u = canonical.sum(dim=1)
    return dup, canonical, u


def _tree_paths(model: GBTModel, t: int, anc: torch.Tensor):
    return model.split_feature[t].long()[anc], model.split_bin[t].long()[anc]


def _shapley_coefficients(model: GBTModel, bg_table: torch.Tensor):
    """The per-tree Shapley coefficients of the compact form (the
    counterpart of the JAX package's ``_chisel_tables``, without its padding
    or dense form), on the model's device:

    - ``mask_bits`` (T, M, L) int32: bit k set when level subset m fixes
      level k of leaf l (``bits[m, dup[l, k]]``);
    - ``coef`` (T, M, D, L) float32: the Shapley weight of (m, l) on
      canonical level k — ``bit_k(m)·W[m∖k] − W[m]`` of the include-masked
      weight, as in ``_chisel_tables`` — times the background factor and
      the leaf value (0 off the canonical levels).

    φ of a row is Σ over (tree, m, l) with no fixed level of l failing, of
    ``coef[m, k, l]`` into feature ``path_feat[l, k]``."""
    dev = model.split_feature.device
    depth = model.depth
    anc_np, _, bits_np, _ = _tree_static(depth)
    anc = torch.as_tensor(anc_np, device=dev).long()
    bits = torch.as_tensor(bits_np, device=dev)  # (M, D)
    masks = bits.shape[0]
    # the full mask's size (depth) only indexes masks that include no level;
    # clamp it into the table, as JAX's indexing does
    size = bits.sum(dim=1).clamp_max(depth - 1)
    wtab = torch.as_tensor(_shapley_weights(depth), dtype=torch.float32, device=dev)
    kb = torch.arange(depth, device=dev)
    ar_m = torch.arange(masks, device=dev)
    bitk = (ar_m[:, None] >> kb[None, :]) & 1  # (M, D)
    low = ar_m[:, None] ^ (1 << kb)[None, :]  # (M, D)
    mask_bits, coefs = [], []
    for t in range(model.split_feature.shape[0]):
        feat, _ = _tree_paths(model, t, anc)  # (L, D)
        dup, canonical, u = _dup_structure(feat)
        bitdup = bits[:, dup]  # (M, L, D)
        mask_bits.append((bitdup.to(torch.int32) << kb.to(torch.int32)).sum(dim=2))
        valid = (canonical[None, :, :] | ~bits[:, None, :]).all(dim=2)  # (M, L)
        w_ml = wtab[u[None, :], size[:, None]]  # (M, L)
        include = valid[:, None, :] & ~bits[:, :, None] & canonical.T[None, :, :]
        wi = torch.where(include, w_ml[:, None, :], 0.0)  # (M, D, L)
        wi_low = wi[low, kb[None, :], :]
        dmat = torch.where(bitk[:, :, None] == 1, wi_low, 0.0) - wi
        coefs.append(dmat * (bg_table[t].T * model.leaf_value[t][None, :])[:, None, :])
    return (torch.stack(mask_bits).to(torch.int32).contiguous(),
            torch.stack(coefs).to(torch.float32).contiguous())


def build_tables(model: GBTModel, bg_table: torch.Tensor) -> kernels.TreeShapTables:
    """The compact per-tree tables the ``tree_shap`` kernel reads, on the
    model's device (N = 2^D − 1 internal nodes in heap order, L = 2^D
    leaves, G = ``kernels.TREE_SHAP_GROUP``):

    - ``node_key`` (T, 32): ``split_bin << 8 | split_feature`` of each node,
      padded to 32 words (one 128-byte bulk copy a tree);
    - ``leaf_sums`` (T, L, D, V), V = 2^D: the subset loop folded over the
      only thing it reads of the row — the pattern v of leaf l's failed
      levels: ``Σ_m [v & mask_bits[m, l] == 0] · coef[m, k, l]``, added in
      ascending m (:func:`_shapley_coefficients`); v is the fastest axis,
      so a warp whose lanes (rows) differ only in v reads 32 banks;
    - ``group_order``/``group_start``/``group_count``: for each group of G
      consecutive trees, its nodes ``w·N + q`` (tree w of the group, node q)
      grouped by split feature, ascending (w, q) within one feature, and
      each feature's run — the fixed order in which the kernel adds them."""
    dev = model.split_feature.device
    depth = model.depth
    d = int(model.bin_edges.shape[0])
    sf, sb = model.split_feature, model.split_bin
    if sf.numel() and (int(sf.min()) < 0 or int(sf.max()) >= d):
        raise ValueError(f"split_feature outside [0, {d})")
    if sb.numel() and (int(sb.min()) < 0 or int(sb.max()) >= 1 << 23):
        raise ValueError("split_bin outside [0, 2^23)")
    mask_bits, coef = _shapley_coefficients(model, bg_table)
    n_trees, masks, leaves = mask_bits.shape
    nodes = leaves - 1
    patterns = torch.arange(2**depth, device=dev)
    # holds[t, l, v, m]: with pattern v failing, subset m's fixed levels hold
    holds = (patterns[None, None, :, None] & mask_bits.transpose(1, 2)[:, :, None, :]) == 0
    coef_l = coef.permute(0, 1, 3, 2)  # (T, M, L, D)
    leaf_sums = torch.zeros((n_trees, leaves, patterns.numel(), depth),
                            dtype=torch.float32, device=dev)
    for m in range(masks):
        leaf_sums += torch.where(holds[:, :, :, m, None], coef_l[:, m, :, None, :], 0.0)
    node_key = torch.zeros((n_trees, 32), dtype=torch.int32, device=dev)
    node_key[:, :nodes] = (sb.to(torch.int32) << 8) | sf.to(torch.int32)
    # within a group, nodes by (feature, tree, node): a stable sort of the
    # features over the group's (tree, node) rows, group by group
    g = kernels.TREE_SHAP_GROUP
    groups = -(-n_trees // g)
    order, starts, counts = [], [], []
    for first in range(0, n_trees, g):
        feats = sf[first:first + g].long().reshape(-1)
        order.append(torch.sort(feats, stable=True).indices)
        cnt = torch.bincount(feats, minlength=d)
        counts.append(cnt)
        starts.append(torch.cumsum(cnt, 0) - cnt)
    return kernels.TreeShapTables(
        split_feature=sf, split_bin=sb,
        leaf_value=model.leaf_value, bg_table=bg_table,
        node_key=node_key.contiguous(),
        leaf_sums=leaf_sums.transpose(2, 3).contiguous(),
        group_order=torch.cat(order).to(torch.int32).contiguous(),
        group_start=torch.stack(starts).reshape(groups, d).to(torch.int32).contiguous(),
        group_count=torch.stack(counts).reshape(groups, d).to(torch.int32).contiguous(),
    )


def kernel_tables(model: GBTModel, bg_table: torch.Tensor) -> kernels.TreeShapTables | None:
    """The tables an explainer caches: :func:`build_tables` for a model on
    the card at depth ≤ the kernel's cap, else None (nothing would read
    them: the CPU and deeper forests take the plain body)."""
    if model.split_feature.device.type != "cuda" or model.depth > kernels.TREE_SHAP_MAX_DEPTH:
        return None
    return build_tables(model, bg_table)


def build_tree_explainer(
    model: GBTModel,
    background_x,
    max_background: int = 128,
    seed: int | None = None,
) -> TreeShapExplainer:
    """The background expectation table over a (subsampled) background
    set, in the model's input space, and — depth permitting — the kernel's
    tables. ``seed`` pins the numpy subsample (``None``: ``EXPLAIN_BG_SEED``),
    so the same model, background and seed give ``bg_table`` bitwise, and
    the JAX package's own."""
    from fraud_detection_tpu_torch import config

    bg = np.asarray(background_x, np.float32)
    if bg.ndim == 1:
        bg = bg[None, :]
    if bg.shape[0] > max_background:
        if seed is None:
            seed = config.explain_background_seed()
        idx = np.random.default_rng(seed).choice(bg.shape[0], max_background, replace=False)
        bg = bg[idx]

    dev = model.split_feature.device
    depth = model.depth
    anc_np, direc_np, bits_np, _ = _tree_static(depth)
    anc = torch.as_tensor(anc_np, device=dev).long()
    direc = torch.as_tensor(direc_np, device=dev)
    bits = torch.as_tensor(bits_np, device=dev)
    binned_bg = bin_features(torch.from_numpy(bg).to(dev), model.bin_edges).long()
    ev = model.base_logit.float()
    tables = []
    for t in range(model.split_feature.shape[0]):
        feat, thr = _tree_paths(model, t, anc)
        dup, _, _ = _dup_structure(feat)
        cb = _path_conditions(binned_bg, feat, thr, direc)  # (bg, leaves, depth)
        selb = torch.where(bits[:, dup][None], True, cb[:, None])
        bg_t = selb.all(dim=3).float().sum(dim=0) / bg.shape[0]  # (masks, leaves)
        bg_t = bg_t.T.contiguous()  # (leaves, masks)
        ev = ev + torch.sum(model.leaf_value[t] * bg_t[:, 0])  # mask 0: all background
        tables.append(bg_t)
    bg_table = torch.stack(tables)
    return TreeShapExplainer(model=model, bg_table=bg_table, expected_value=ev,
                             tables=kernel_tables(model, bg_table))


@functools.lru_cache(maxsize=None)
def _note_plain_body(depth: int) -> None:
    log.info(
        "TreeSHAP at depth %d runs the plain body: the kernel takes depth <= %d",
        depth, kernels.TREE_SHAP_MAX_DEPTH,
    )


def _raw_tree_shap(
    model: GBTModel,
    bg_table: torch.Tensor,
    x: torch.Tensor,
    tables: kernels.TreeShapTables | None = None,
) -> torch.Tensor:
    """The batched TreeSHAP body shared by the fused flush and
    :func:`tree_shap`: φ (n, d) float32 in margin space, exact —
    ``Σ_j φ_j + expected_value == gbt_predict_logits(model, x)``.

    With the explainer's kernel ``tables`` (a model on the card at depth ≤
    the kernel's cap) it goes through ``kernels.tree_shap``; without them
    the plain body runs — on the CPU, or above the cap on any device
    (logged once per depth). A card forest within the cap without its
    tables raises: the card never takes the plain body there."""
    binned = bin_features(x, model.bin_edges)
    if tables is not None:
        return kernels.tree_shap(binned, tables)
    if model.depth > kernels.TREE_SHAP_MAX_DEPTH:
        _note_plain_body(model.depth)
    elif binned.device.type == "cuda":
        raise ValueError(
            "TreeSHAP on the card at depth <= "
            f"{kernels.TREE_SHAP_MAX_DEPTH} needs the explainer's kernel tables"
        )
    return kernels.tree_shap_reference(
        binned, model.split_feature, model.split_bin, model.leaf_value, bg_table
    )


def tree_shap(explainer: TreeShapExplainer, x: torch.Tensor) -> torch.Tensor:
    """SHAP values (n, d) in margin space — the standalone explainer over
    :func:`_raw_tree_shap` (one body with the serve-time reason codes)."""
    return _raw_tree_shap(explainer.model, explainer.bg_table, x,
                          tables=explainer.tables)


def tree_shap_single(explainer: TreeShapExplainer, x: torch.Tensor) -> torch.Tensor:
    """SHAP values (d,) for one row."""
    return tree_shap(explainer, x[None, :])[0]


def tree_shap_topk(
    explainer: TreeShapExplainer, x: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Standalone top-k GBT reason codes, highest first, ties to the lower
    feature index (``topk_reasons``) — the reference the fused flush's
    reason codes equal bitwise."""
    return topk_reasons(tree_shap(explainer, x), k)
