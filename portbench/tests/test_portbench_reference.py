"""The plain references against the definitions and against the port on
the CPU, at a tiny size."""

from __future__ import annotations

import itertools
import math

import numpy as np
import pytest
import torch

from portbench import inputs, registry
from portbench import reference as ref
from portbench.reference.booster import Booster
from portbench.reference.forest import forest_margin, forest_shap


def _tiny_forest(seed=0, d=4, trees=3, depth=3, nb=16, n_bg=5):
    g = np.random.default_rng(seed)
    internal, leaves = (1 << depth) - 1, 1 << depth
    return {"split_feature": g.integers(0, d, (trees, internal)).astype(np.int32),
            "split_bin": g.integers(0, nb, (trees, internal)).astype(np.int32),
            "leaf_value": g.normal(0, 1, (trees, leaves)).astype(np.float32),
            "bin_edges": np.sort(g.normal(0, 1, (d, nb - 1)), axis=1).astype(np.float32),
            "base_logit": np.float32(0.1),
            "background": g.normal(0, 1, (n_bg, d)).astype(np.float32)}


def test_forest_shap_is_the_shapley_value_by_enumeration():
    w = _tiny_forest()
    x = np.random.default_rng(1).normal(0, 1, (5, 4)).astype(np.float32)
    phi = forest_shap(w, x)
    d, bg = 4, w["background"].astype(np.float64)

    def v(row, s):
        z = bg.copy()
        z[:, list(s)] = row[list(s)]
        return forest_margin(w, z).mean()

    for i, row in enumerate(x.astype(np.float64)):
        for j in range(d):
            others = [k for k in range(d) if k != j]
            want = sum(
                math.factorial(r) * math.factorial(d - r - 1) / math.factorial(d)
                * (v(row, s + (j,)) - v(row, s))
                for r in range(d) for s in itertools.combinations(others, r))
            assert abs(phi[i, j] - want) < 1e-12


def _port_scorer(cfg, weights, tmp_path, seed):
    from fraud_detection_tpu_torch.models import load_any_model

    d = inputs.write_model_dir(str(tmp_path / "m"), cfg, weights, seed)
    return load_any_model(d, device="cpu")


@pytest.mark.parametrize("name", ["xgb_kaggle_100x5", "lr_kaggle_d30"])
def test_references_agree_with_the_port_on_the_cpu(name, tmp_path, small):
    cfg = registry.config(name, small)
    weights = inputs.make_weights(cfg, 3)
    model = _port_scorer(cfg, weights, tmp_path, 3)
    x, _ = inputs.rows(cfg, 3, 300)
    p = model.scorer.predict_proba(x)
    np.testing.assert_allclose(p, ref.score(cfg, weights, x), rtol=0, atol=2e-6)
    phi, _ = model.explain_batch(x)
    np.testing.assert_allclose(phi, ref.explain(cfg, weights, x), rtol=0, atol=5e-6)


def test_the_judge_passes_the_ports_fit_and_fails_a_broken_one(small):
    from fraud_detection_tpu_torch.ops.gbt import GBTConfig, gbt_fit, gbt_predict_proba

    cfg = registry.config("xgb_kaggle_100x5", small)
    data = inputs.fit_inputs(cfg, 11)
    m = cfg["model"]
    gcfg = GBTConfig(n_trees=m["n_trees"], max_depth=m["max_depth"])
    model = gbt_fit(data["x_fit"], data["y_fit"], gcfg, device="cpu")
    p = gbt_predict_proba(model, torch.from_numpy(data["x_test"])).numpy()
    forest = {k: getattr(model, k).numpy()
              for k in ("split_feature", "split_bin", "leaf_value", "bin_edges")}
    judge = Booster(data["x_fit"], data["y_fit"], m)
    good = judge.judge(forest, data["x_test"], p)
    assert good["edges_gap"] == 0.0
    assert good["split_gap"] < 1e-5 and good["leaf_gap"] < 1e-4 and good["heldout_gap"] < 1e-4
    bad = dict(forest, split_bin=forest["split_bin"].copy())
    bad["split_bin"][1, 0] = (bad["split_bin"][1, 0] + 40) % 250
    assert judge.judge(bad, data["x_test"], p)["split_gap"] > 1e-3


def test_the_judges_grown_forest_judges_itself(small):
    cfg = registry.config("xgb_kaggle_100x5", small)
    data = inputs.fit_inputs(cfg, 12)
    b = Booster(data["x_fit"], data["y_fit"], cfg["model"])
    forest = b.grow()
    p = 1 / (1 + np.exp(-forest_margin(forest, data["x_test"])))
    got = b.judge(forest, data["x_test"], p)
    assert got["split_gap"] == 0.0 and got["leaf_gap"] < 1e-6 and got["heldout_gap"] < 1e-7
