"""Everything a run feeds the program, made from ``--seed`` with numpy.

- the rows: a copy of the Kaggle-schema generator the port carries in
  ``data/synthetic.generate_synthetic_rows`` (the same numpy calls in the
  same order, so the same seed gives the same rows): ``Time`` sorted
  uniform over 48 h, V1..V28 standard normal, ``Amount`` log-normal, fraud
  labels at the configuration's rate, the fraud rows shifted along one fixed
  direction in V-space;
- the served model's weights and its drift profile, written in the layout
  the port's loader reads (``model.npz``, ``feature_names.json``,
  ``monitor_profile.npz``), and handed as arrays to the reference;
- the fit's training split: an 80/20 stratified split, a standard scaler
  fitted on the 80%, SMOTE (k = 5) bringing the frauds up to the
  legitimate rows' count.

Each use of the seed draws from a stream of its own (:func:`rng`), so
adding a draw to one leaves the others as they were. Nothing here imports
torch or the program.
"""

from __future__ import annotations

import json
import os

import numpy as np

KAGGLE_FEATURES = ["Time"] + [f"V{i}" for i in range(1, 29)] + ["Amount"]

#: the fraud direction is fixed across seeds (the port's ``_SHIFT_SEED``)
_SHIFT_SEED = 1729

#: named sub-streams of a run's seed
STREAMS = {
    "rows": 1, "weights": 2, "background": 3, "sample": 4, "profile": 5,
    "split": 6, "smote": 7,
}


def seed_words(seed: int) -> list[int]:
    """A whole number of any sign and size as non-negative 32-bit words."""
    s = int(seed) % (1 << 64)
    return [s & 0xFFFFFFFF, s >> 32]


def rng(seed: int, stream: str) -> np.random.Generator:
    return np.random.default_rng([STREAMS[stream], *seed_words(seed)])


def stream_seed(seed: int, stream: str) -> int:
    """A 63-bit integer seed for generators that take one int."""
    return int(rng(seed, stream).integers(0, 1 << 63))


def fraud_shift(scale: float = 1.5) -> np.ndarray:
    return np.random.default_rng(_SHIFT_SEED).standard_normal(28).astype(np.float32) * scale


def generate_synthetic_rows(
    n_samples: int, fraud_ratio: float = 0.01, seed: int = 42,
    shift: np.ndarray | None = None, n_fraud: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """(X (n, 30) float32, y (n,) int32) in the Kaggle file's schema. With
    ``n_fraud`` exactly that many rows, at seeded positions, are frauds
    (the port's generator draws each label at ``fraud_ratio``), so every
    seed gives the same class sizes."""
    g = np.random.default_rng(seed)
    x = np.empty((n_samples, len(KAGGLE_FEATURES)), dtype=np.float32)
    x[:, 0] = np.sort(g.uniform(0, 172800, n_samples)).astype(np.float32)
    x[:, 1:29] = g.standard_normal((n_samples, 28), dtype=np.float32)
    x[:, 29] = g.lognormal(mean=3.0, sigma=1.0, size=n_samples).astype(np.float32)
    if n_fraud is None:
        y = (g.random(n_samples) < fraud_ratio).astype(np.int32)
    else:
        y = np.zeros(n_samples, np.int32)
        y[g.choice(n_samples, n_fraud, replace=False)] = 1
    if y.sum() < 2:
        y[:2] = 1
    if shift is None:
        shift = fraud_shift()
    x[:, 1:29] += y[:, None] * shift[None, :]
    return x, y


def rows(cfg: dict, seed: int, n: int, stream: str = "rows") -> tuple[np.ndarray, np.ndarray]:
    data = cfg["data"]
    return generate_synthetic_rows(
        n, data["fraud_rate"], stream_seed(seed, stream), fraud_shift(data["shift_scale"]),
        n_fraud=int(round(n * data["fraud_rate"])))


# ---------------------------------------------------------------------------
# Served models
# ---------------------------------------------------------------------------


def quantile_edges(x: np.ndarray, n_bins: int) -> np.ndarray:
    """(d, n_bins − 1) float32 interior quantile edges, non-decreasing (the
    rule of the port's ``compute_bin_edges`` without its subsample)."""
    qs = np.linspace(0.0, 1.0, n_bins + 1)[1:-1]
    edges = np.quantile(np.asarray(x, np.float32), qs, axis=0).T.astype(np.float32)
    return np.maximum.accumulate(edges, axis=1)


def logistic_weights(cfg: dict, seed: int) -> dict:
    """A standard scaler fitted on seeded rows and seeded coefficients on
    the scaled features: ``{"mean", "scale", "coef", "intercept"}``, float64."""
    x, _ = rows(cfg, seed, cfg["data"]["fit_rows"], "profile")
    x = x.astype(np.float64)
    mean = x.mean(axis=0)
    scale = x.std(axis=0)
    scale[scale == 0.0] = 1.0
    g = rng(seed, "weights")
    m = cfg["model"]
    coef = g.normal(0.0, m["coef_std"], x.shape[1])
    return {"mean": mean, "var": scale ** 2, "scale": scale, "coef": coef,
            "intercept": np.float64(m["intercept"]), "n": np.float64(x.shape[0])}


def forest_weights(cfg: dict, seed: int) -> dict:
    """A seeded forest of the configuration's shape over quantile edges of
    seeded rows, with its TreeSHAP background of raw rows:
    ``{"split_feature", "split_bin", "leaf_value", "bin_edges", "base_logit",
    "background"}``. Every node splits (bins in the middle of the range)."""
    m = cfg["model"]
    d = cfg["data"]["d"]
    x, _ = rows(cfg, seed, cfg["data"]["fit_rows"], "profile")
    edges = quantile_edges(x, m["n_bins"])
    g = rng(seed, "weights")
    trees, depth = m["n_trees"], m["max_depth"]
    internal = (1 << depth) - 1
    split_feature = g.integers(0, d, (trees, internal)).astype(np.int32)
    lo = m["n_bins"] // 16
    split_bin = g.integers(lo, m["n_bins"] - 1 - lo, (trees, internal)).astype(np.int32)
    leaf_value = g.normal(0.0, m["leaf_std"], (trees, 1 << depth)).astype(np.float32)
    bg, _ = rows(cfg, seed, cfg["serve"]["background_rows"], "background")
    return {"split_feature": split_feature, "split_bin": split_bin,
            "leaf_value": leaf_value, "bin_edges": edges,
            "base_logit": np.float32(0.0), "background": bg}


def make_weights(cfg: dict, seed: int) -> dict:
    return (forest_weights if cfg["family"] == "gbt" else logistic_weights)(cfg, seed)


def _profile(x: np.ndarray, scores: np.ndarray, names: list[str]) -> dict:
    """The drift baseline in the port's ``monitor_profile.npz`` layout: 16
    equiprobable feature bins, 20 uniform score bins and five tail
    quantiles (counts by ``searchsorted(side='right')``, as the fold)."""
    qs = np.arange(1, 16, dtype=np.float64) / 16
    fe = np.quantile(x, qs, axis=0).T.astype(np.float32)
    fc = np.stack([np.bincount(np.searchsorted(fe[j], x[:, j], side="right"),
                               minlength=16) for j in range(x.shape[1])]).astype(np.float32)
    se = np.linspace(0.0, 1.0, 21)[1:-1].astype(np.float32)
    sc = np.bincount(np.searchsorted(se, scores, side="right"), minlength=20)
    return {
        "feature_edges": fe, "feature_counts": fc, "score_edges": se,
        "score_counts": sc.astype(np.float32),
        "score_quantiles": np.quantile(scores, [0.5, 0.9, 0.95, 0.99, 0.999]).astype(np.float32),
        "n_rows": np.int64(x.shape[0]), "feature_names": np.asarray(names),
    }


def write_model_dir(directory: str, cfg: dict, weights: dict, seed: int) -> str:
    """The served directory: ``model.npz`` and ``feature_names.json`` in the
    port's layout, and ``monitor_profile.npz`` from seeded rows scored by
    the reference (so the drift fold has a baseline, as a trained model's
    directory has)."""
    from portbench.reference import score as ref_score

    os.makedirs(directory, exist_ok=True)
    names = list(KAGGLE_FEATURES)
    if cfg["family"] == "gbt":
        state = {
            "gbt_split_feature": weights["split_feature"],
            "gbt_split_bin": weights["split_bin"],
            "gbt_leaf_value": weights["leaf_value"],
            "gbt_bin_edges": weights["bin_edges"],
            "gbt_base_logit": np.asarray(weights["base_logit"], np.float32),
            "gbt_background": weights["background"],
        }
    else:
        state = {
            "coef": weights["coef"], "intercept": np.asarray(weights["intercept"]),
            "scaler_mean": weights["mean"], "scaler_scale": weights["scale"],
            "scaler_var": weights["var"], "scaler_n": np.asarray(weights["n"]),
        }
    np.savez(os.path.join(directory, "model.npz"), **state)
    with open(os.path.join(directory, "feature_names.json"), "w") as f:
        json.dump(names, f)
    x, _ = rows(cfg, seed, cfg["data"]["profile_rows"], "profile")
    scores = ref_score(cfg, weights, x)
    np.savez(os.path.join(directory, "monitor_profile.npz"), **_profile(x, scores, names))
    return directory


# ---------------------------------------------------------------------------
# The fit's training split
# ---------------------------------------------------------------------------


def stratified_split(y: np.ndarray, test_share: float, g: np.random.Generator):
    """(train idx, test idx): each class shuffled and cut at the share."""
    train, test = [], []
    for c in (0, 1):
        idx = np.flatnonzero(y == c)
        g.shuffle(idx)
        k = int(round(len(idx) * test_share))
        test.append(idx[:k])
        train.append(idx[k:])
    return np.sort(np.concatenate(train)), np.sort(np.concatenate(test))


def smote(x: np.ndarray, y: np.ndarray, k: int, g: np.random.Generator):
    """Oversample the frauds to the legitimate rows' count: each new row
    lies a uniform share of the way from a random fraud row to one of its
    k nearest fraud neighbours (squared Euclidean, itself excluded)."""
    pos = x[y == 1].astype(np.float64)
    need = int((y == 0).sum() - len(pos))
    if need <= 0:
        return x, y
    d2 = ((pos[:, None, :] - pos[None, :, :]) ** 2).sum(axis=2)
    np.fill_diagonal(d2, np.inf)
    nn = np.argsort(d2, axis=1, kind="stable")[:, :k]
    base = g.integers(0, len(pos), need)
    nb = nn[base, g.integers(0, k, need)]
    gap = g.random(need)[:, None]
    new = pos[base] + gap * (pos[nb] - pos[base])
    xs = np.concatenate([x, new.astype(np.float32)])
    ys = np.concatenate([y, np.ones(need, y.dtype)])
    return xs, ys


def fit_inputs(cfg: dict, seed: int) -> dict:
    """The recipe's final-fit input from the seed: the whole seeded file,
    its stratified split, a scaler on the training part, SMOTE. Returns
    float32 ``x_fit``/``y_fit`` and the scaled held-out ``x_test``/``y_test``."""
    data = cfg["data"]
    x, y = rows(cfg, seed, data["rows"])
    tr, te = stratified_split(y, data["test_share"], rng(seed, "split"))
    mean = x[tr].astype(np.float64).mean(axis=0)
    scale = x[tr].astype(np.float64).std(axis=0)
    scale[scale == 0.0] = 1.0
    xs = ((x - mean) / scale).astype(np.float32)
    x_fit, y_fit = smote(xs[tr], y[tr], data["smote_k"], rng(seed, "smote"))
    return {"x_fit": x_fit, "y_fit": y_fit, "x_test": xs[te], "y_test": y[te]}


def check_sample(seed: int, population: int, k: int) -> np.ndarray:
    """The sorted ids, drawn from the seed, of the ``k`` answers a run
    compares with the reference."""
    k = min(k, population)
    return np.sort(rng(seed, "sample").choice(population, k, replace=False))
