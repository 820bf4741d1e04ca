"""Histogram gradient-boosted trees on one device.

The JAX package's ``ops/gbt.py`` — the reference's ``XGBClassifier`` recipe
(100 trees, depth 5, learning rate 0.1, λ = 1, 256 bins) — in PyTorch:

- **Quantile binning**: edges on the host (:func:`compute_bin_edges`, a
  numpy copy, bitwise the JAX one); the fit bins on the host into uint8
  and keeps the bins uint8 on the device, where the histogram kernel reads
  bytes; prediction bins on the device (:func:`bin_features`).
- **NaN rule**: a NaN feature value goes to the last bin, ``n_bins − 1``,
  on the host path and the device path alike. It is mapped explicitly, so
  the rule never depends on how a backend's search orders NaN. (The JAX
  package's host ``np.searchsorted`` and its CPU ``jnp.searchsorted`` give
  the same bin.)
- **Perfect static-depth trees**, grown level by level (node ``i`` →
  children ``2i+1``, ``2i+2``); a node with no positive gain passes all its
  rows left. Gains from cumulative sums of the per-(feature, node, bin)
  gradient/hessian histograms, which the hand-written ``gbt_hist`` CUDA
  kernel computes on the card in int64 fixed point, deterministic whatever
  the order of its adds (:mod:`.kernels`; its plain version, the JAX
  package's exact-f32 ``_hist_segment``, on the CPU). ``argmax`` ties
  go to the first index, as in ``jnp.argmax``.
- **Leaf sums** go through the same histogram kernel over the one column
  of leaf ids (one node, ``n_leaves`` bins): deterministic on the card,
  where a float ``index_add_`` changes from run to run.
- **Boosting** is a Python loop over trees (JAX: ``lax.scan``); the whole
  loop stays on the device with no host sync.

``_hist_matmul`` (a TPU MXU idiom) and the ``GBT_HIST``/``GBT_MATMUL_HIST``/
``GBT_DENSE_PREDICT`` switches are not ported: the device of the tensors
decides. The fit is the JAX package's unsharded fit (one device); its
sharded fit (histogram allreduce) is ROADMAP queue 1, item 12.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from fraud_detection_tpu_torch.device import resolve_device
from fraud_detection_tpu_torch.ops import kernels


@dataclass(frozen=True)
class GBTConfig:
    """Hyperparameters, the JAX package's defaults: the reference's
    ``XGBClassifier`` (100 trees, depth 5, lr 0.1, λ = 1, γ = 0,
    min_child_weight 1)."""

    n_trees: int = 100
    max_depth: int = 5
    learning_rate: float = 0.1
    n_bins: int = 256
    reg_lambda: float = 1.0
    gamma: float = 0.0
    min_child_weight: float = 1.0
    scale_pos_weight: float = 1.0
    base_score: float = 0.5  # prior probability; logit(0.5) = 0


class GBTModel(NamedTuple):
    """A fitted forest of static-depth trees (stacked over trees).

    ``split_feature``/``split_bin`` cover internal nodes in heap order;
    ``leaf_value`` the 2^depth bottom-level leaves; ``bin_edges[f, j]`` is
    the j-th upper bin boundary of feature f (x > edge goes right)."""

    split_feature: torch.Tensor  # (n_trees, 2^depth − 1) int32
    split_bin: torch.Tensor  # (n_trees, 2^depth − 1) int32
    leaf_value: torch.Tensor  # (n_trees, 2^depth) float32
    bin_edges: torch.Tensor  # (d, n_bins − 1) float32
    base_logit: torch.Tensor  # () float32

    def to(self, device) -> "GBTModel":
        return GBTModel(*(t.to(device) for t in self))

    @property
    def depth(self) -> int:
        return (int(self.split_feature.shape[1]) + 1).bit_length() - 1


# ---------------------------------------------------------------------------
# Binning
# ---------------------------------------------------------------------------


def compute_bin_edges(
    x: np.ndarray, n_bins: int = 256, max_sample: int = 200_000, seed: int = 0
) -> np.ndarray:
    """Per-feature quantile bin edges (d, n_bins − 1) float32, from a row
    subsample above ``max_sample`` rows; made non-decreasing."""
    x = np.asarray(x, np.float32)
    n = x.shape[0]
    if n > max_sample:
        idx = np.random.default_rng(seed).choice(n, max_sample, replace=False)
        x = x[idx]
    qs = np.linspace(0.0, 1.0, n_bins + 1)[1:-1]
    edges = np.quantile(x, qs, axis=0).T.astype(np.float32)
    return np.maximum.accumulate(edges, axis=1)


def bin_features(x: torch.Tensor, bin_edges: torch.Tensor) -> torch.Tensor:
    """Bin ids (n, d) int32 in [0, n_bins): the count of edges strictly
    below the value (``right=False``), so x == edge stays left and the
    split predicate ``bin > split_bin`` means ``x > edge``. NaN goes to the
    last bin, ``n_bins − 1``."""
    x = x.float()
    nan = torch.isnan(x)
    clean = torch.where(nan, torch.zeros_like(x), x)
    b = torch.searchsorted(
        bin_edges.contiguous(), clean.T.contiguous(), right=False, out_int32=True
    ).T
    return torch.where(nan, torch.full_like(b, bin_edges.shape[1]), b).contiguous()


def bin_features_host(x: np.ndarray, edges: np.ndarray, n_bins: int) -> np.ndarray:
    """The fit's host binning: uint8 ids for ≤ 256 bins (the wire and the
    kernel read bytes), int32 above; the rule of :func:`bin_features`."""
    x = np.asarray(x, np.float32)
    out = np.empty(x.shape, dtype=np.uint8 if n_bins <= 256 else np.int32)
    for f in range(x.shape[1]):
        col = x[:, f]
        b = np.searchsorted(edges[f], col, side="left")
        b[np.isnan(col)] = edges.shape[1]
        out[:, f] = b
    return out


# ---------------------------------------------------------------------------
# Tree growth
# ---------------------------------------------------------------------------


def _grow_tree(binned: torch.Tensor, g: torch.Tensor, h: torch.Tensor, cfg: GBTConfig):
    """Grow one static-depth tree; returns (split_feature, split_bin,
    leaf_value, row_leaf) with ``row_leaf`` the bottom-level leaf index of
    every row. ``binned`` (n, d) uint8 (or int32 above 256 bins); ``g``/``h``
    (n,) float32 (0 for inert rows). One ``gbt_hist`` launch per level and
    one for the leaf sums; no host sync."""
    dev = binned.device
    n, d = binned.shape
    n_bins = cfg.n_bins
    depth = cfg.max_depth
    n_internal = 2**depth - 1
    lam, gamma, mcw = cfg.reg_lambda, cfg.gamma, cfg.min_child_weight

    node = torch.zeros((n,), dtype=torch.int32, device=dev)
    feat = torch.zeros((n_internal,), dtype=torch.int32, device=dev)
    thresh = torch.full((n_internal,), n_bins - 1, dtype=torch.int32, device=dev)
    for level in range(depth):
        level_base = 2**level - 1
        n_nodes = 2**level
        local = node - level_base
        hist = kernels.gbt_hist(binned, local, g, h, n_nodes, n_bins)

        gl = torch.cumsum(hist[..., 0], dim=2)  # (d, n_nodes, n_bins)
        hl = torch.cumsum(hist[..., 1], dim=2)
        g_tot = gl[..., -1:]
        h_tot = hl[..., -1:]
        gr = g_tot - gl
        hr = h_tot - hl

        def score(gs, hs):
            return (gs * gs) / (hs + lam)

        gain = 0.5 * (score(gl, hl) + score(gr, hr) - score(g_tot, h_tot)) - gamma
        valid = (hl >= mcw) & (hr >= mcw)
        # bin b splits after bin b; the last bin has no right side
        valid[..., -1] = False
        gain = torch.where(valid, gain, torch.full_like(gain, -torch.inf))

        gain_fb = torch.amax(gain, dim=2)  # (d, n_nodes)
        bin_fb = torch.argmax(gain, dim=2)  # first index among ties
        best_f = torch.argmax(gain_fb, dim=0)  # (n_nodes,)
        best_gain = torch.amax(gain_fb, dim=0)
        best_bin = bin_fb[best_f, torch.arange(n_nodes, device=dev)]

        # no positive gain → pass-through: every row left
        no_split = ~(best_gain > 0.0)
        best_f = torch.where(no_split, 0, best_f).to(torch.int32)
        best_bin = torch.where(no_split, n_bins - 1, best_bin).to(torch.int32)

        feat[level_base:level_base + n_nodes] = best_f
        thresh[level_base:level_base + n_nodes] = best_bin

        lidx = local.long()
        row_f = best_f.long()[lidx]
        row_b = best_bin[lidx]
        go_right = binned.gather(1, row_f[:, None])[:, 0].to(torch.int32) > row_b
        node = 2 * node + 1 + go_right.to(torch.int32)

    # leaf values −G/(H+λ) from bottom-level sums: the histogram kernel over
    # the column of leaf ids (one node, n_leaves bins)
    n_leaves = 2**depth
    row_leaf = node - n_internal
    leaf_ids = row_leaf.to(torch.uint8 if n_leaves <= 256 else torch.int32)[:, None]
    leaf_gh = kernels.gbt_hist(
        leaf_ids.contiguous(), torch.zeros_like(row_leaf), g, h, 1, n_leaves
    )[0, 0]  # (n_leaves, 2)
    leaf_value = torch.where(
        leaf_gh[:, 1] > 0.0,
        -leaf_gh[:, 0] / (leaf_gh[:, 1] + lam),
        torch.zeros_like(leaf_gh[:, 0]),
    ) * cfg.learning_rate
    return feat, thresh, leaf_value, row_leaf


def _boost(binned, y, w, base_logit: float, cfg: GBTConfig):
    """Loop over boosting rounds; returns the stacked tree arrays. ``w``
    carries both inert rows (0) and ``scale_pos_weight``."""
    n = binned.shape[0]
    logits = torch.full((n,), base_logit, dtype=torch.float32, device=binned.device)
    feats, threshs, leaves = [], [], []
    sign_w = torch.sign(w)
    for _ in range(cfg.n_trees):
        p = torch.sigmoid(logits)
        g = w * (p - y)
        h = torch.clamp_min(w * p * (1.0 - p), 1e-16) * sign_w
        feat, thresh, leaf, row_leaf = _grow_tree(binned, g, h, cfg)
        logits = logits + leaf[row_leaf.long()]
        feats.append(feat)
        threshs.append(thresh)
        leaves.append(leaf)
    return torch.stack(feats), torch.stack(threshs), torch.stack(leaves)


def gbt_fit(
    x,
    y,
    cfg: GBTConfig = GBTConfig(),
    sample_weight=None,
    device: str | torch.device | None = None,
) -> GBTModel:
    """Fit the forest on one device: ``x``'s device for a tensor, else
    ``device`` (default ``DEVICE``, itself ``cuda``). The JAX package's
    unsharded fit: edges and bins on the host, bins (uint8) + labels +
    weights to the device, the boosting loop there. Returns the model on
    that device, after the device finished (a synchronous fit)."""
    if isinstance(x, torch.Tensor):
        dev = x.device if device is None else resolve_device(device)
        x_np = x.detach().float().cpu().numpy()
    else:
        dev = resolve_device(device)
        x_np = np.asarray(x, dtype=np.float32)
    y_np = (y.detach().cpu().numpy() if isinstance(y, torch.Tensor)
            else np.asarray(y)).astype(np.float32)
    n = x_np.shape[0]
    w = (np.ones((n,), np.float32) if sample_weight is None
         else np.asarray(sample_weight, np.float32).copy())
    if cfg.scale_pos_weight != 1.0:
        w = w * np.where(y_np > 0, cfg.scale_pos_weight, 1.0).astype(np.float32)

    edges = compute_bin_edges(x_np, cfg.n_bins)
    base_logit = float(np.float32(np.log(cfg.base_score / (1.0 - cfg.base_score))))
    binned = torch.from_numpy(bin_features_host(x_np, edges, cfg.n_bins)).to(dev)
    feats, threshs, leaves = _boost(
        binned, torch.from_numpy(y_np).to(dev), torch.from_numpy(w).to(dev),
        base_logit, cfg,
    )
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return GBTModel(
        split_feature=feats,
        split_bin=threshs,
        leaf_value=leaves,
        bin_edges=torch.from_numpy(edges).to(dev),
        base_logit=torch.tensor(base_logit, dtype=torch.float32, device=dev),
    )


def fold_scaler_into_gbt(model: GBTModel, scaler) -> GBTModel:
    """A model scoring *raw* inputs as the original scores scaled ones:
    binning is monotone thresholding and standardization an increasing
    affine map, so ``raw_edge = edge·scale + mean`` per feature."""
    if scaler is None:
        return model
    dev = model.bin_edges.device
    scale = torch.as_tensor(scaler.scale, dtype=torch.float32).to(dev)[:, None]
    mean = torch.as_tensor(scaler.mean, dtype=torch.float32).to(dev)[:, None]
    return model._replace(bin_edges=model.bin_edges * scale + mean)


# ---------------------------------------------------------------------------
# Prediction
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=8)
def _leaf_paths(depth: int) -> tuple[np.ndarray, np.ndarray]:
    """``nodes[k, l]``: the internal node visited at level k on the way to
    leaf l; ``bits[k, l]``: the go-right decision toward l."""
    n_leaves = 2**depth
    nodes = np.zeros((depth, n_leaves), np.int32)
    bits = np.zeros((depth, n_leaves), bool)
    for leaf in range(n_leaves):
        node = 0
        for k in range(depth):
            b = (leaf >> (depth - 1 - k)) & 1
            nodes[k, leaf] = node
            bits[k, leaf] = bool(b)
            node = 2 * node + 1 + b
    return nodes, bits


def _leaf_contrib(model: GBTModel, x: torch.Tensor) -> torch.Tensor:
    """(n, trees, leaves): each tree's leaf value where the row lands, 0 at
    every other leaf. Every internal node's compare for every (row, tree)
    at once, each leaf selected by AND-ing its path's decisions."""
    binned = bin_features(x, model.bin_edges)
    n = binned.shape[0]
    n_trees, n_internal = model.split_feature.shape
    nodes, bits = _leaf_paths(model.depth)
    dev = binned.device
    go_right = (
        binned[:, model.split_feature.reshape(-1).long()]
        > model.split_bin.reshape(-1)[None, :]
    ).reshape(n, n_trees, n_internal)
    ind = None
    for k in range(model.depth):
        sel = go_right[:, :, torch.as_tensor(nodes[k], device=dev).long()] == \
            torch.as_tensor(bits[k], device=dev)[None, None, :]
        ind = sel if ind is None else ind & sel
    return torch.where(ind, model.leaf_value[None], 0.0)


def _predict_logits_dense(model: GBTModel, x: torch.Tensor) -> torch.Tensor:
    """Margin prediction as dense tensor ops: :func:`_leaf_contrib`, then
    ``Σ leaf_value·indicator``. About 3·depth + 6 kernel launches, plus
    ⌈log2 trees⌉ + 1 for the tree sum's halvings, whatever the forest's
    size — the card's path, where the walk's ~4·trees·depth small launches
    would cost milliseconds of host time per batch."""
    contrib = _leaf_contrib(model, x)
    # one leaf a tree is non-zero, so the sum over leaves is exact; the sum
    # over trees halves, so a row's margin does not depend on its batch (one
    # reduction kernel over (trees, leaves) sums in an order that follows
    # the batch's shape)
    return model.base_logit + kernels.halving_sum(contrib.sum(dim=2))


def _predict_logits_walk(model: GBTModel, x: torch.Tensor) -> torch.Tensor:
    """Margin prediction by level-wise traversal (a gather per level) — the
    CPU path, where gathers are cheap and the walk touches far fewer
    elements than the dense form. Leaf values add tree by tree."""
    binned = bin_features(x, model.bin_edges)
    n = binned.shape[0]
    n_internal = model.split_feature.shape[1]
    logits = model.base_logit.expand(n).clone()
    for t in range(model.split_feature.shape[0]):
        feat, thresh, leaf = (model.split_feature[t].long(), model.split_bin[t],
                              model.leaf_value[t])
        node = torch.zeros((n,), dtype=torch.long, device=binned.device)
        for _ in range(model.depth):
            go_right = binned.gather(1, feat[node][:, None])[:, 0] > thresh[node]
            node = 2 * node + 1 + go_right.long()
        logits = logits + leaf[node - n_internal]
    return logits


def gbt_predict_logits(model: GBTModel, x: torch.Tensor) -> torch.Tensor:
    """Margin prediction, ``XGBClassifier``'s decision_function analogue:
    the dense form on the card, the walk on the CPU. Both reach the same
    leaf per row; they differ only in the f32 order of the sum over trees."""
    if x.device.type == "cuda":
        return _predict_logits_dense(model, x)
    return _predict_logits_walk(model, x)


def gbt_predict_proba(model: GBTModel, x: torch.Tensor) -> torch.Tensor:
    """P(class = 1), matching ``XGBClassifier.predict_proba[:, 1]``; the
    same row gets the same bits in any batch (``kernels.row_sigmoid``)."""
    return kernels.row_sigmoid(gbt_predict_logits(model, x))
