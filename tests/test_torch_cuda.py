"""Card-only tests of the port (marker ``cuda``): the hand-written CUDA
kernels against their plain versions, the served path launching
``fused_score``, SMOTE launching ``knn_topk``, the GBT fit launching
``gbt_hist`` and TreeSHAP launching ``tree_shap``.

They import nothing of JAX, so they run on a machine with the card and no
JAX: ``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``
(``--noconftest``: the suite's conftest sets JAX up). Without a card each
test skips with its reason."""

import asyncio
import os

import numpy as np
import pytest
import torch

from fraud_detection_tpu_torch.models import FraudLogisticModel
from fraud_detection_tpu_torch.monitor.baseline import build_baseline_profile
from fraud_detection_tpu_torch.monitor.watchtower import Watchtower
from fraud_detection_tpu_torch.ops import kernels
from fraud_detection_tpu_torch.service.microbatch import MicroBatcher

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _require_card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n, d", [(1, 30), (1024, 30), (20000, 30), (1031, 37)])
def test_kernel_matches_plain_version(n, d):
    """Within 1e-6: the kernel and cuBLAS sum x·w in different orders."""
    dev = _require_card()
    rng = np.random.default_rng(n + d)
    x = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32)).to(dev)
    w = torch.from_numpy((rng.standard_normal(d) / np.sqrt(d)).astype(np.float32)).to(dev)
    b = torch.tensor(-0.5, device=dev)
    before = kernels.FUSED_SCORE_LAUNCHES
    got = kernels.fused_score(w, b, x)
    want = kernels.fused_score_reference(w, b, x)
    torch.cuda.synchronize()
    assert kernels.FUSED_SCORE_LAUNCHES == before + 1
    assert got.shape == (n,)
    assert float((got - want).abs().max()) <= 1e-6


@pytest.mark.cuda
def test_wrapper_raises_on_non_contiguous_cuda_input():
    dev = _require_card()
    x = torch.zeros((8, 60), device=dev)[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        kernels.fused_score(torch.zeros(30, device=dev), torch.tensor(0.0, device=dev), x)


@pytest.mark.cuda
def test_fused_flush_on_the_card_launches_the_kernel_and_matches_cpu():
    """The micro-batcher's fused flush on CUDA agrees with the same flush on
    the CPU (scores within 1e-6, equal reason indices) and went through the
    kernel."""
    _require_card()
    data = np.loadtxt(
        os.path.join(ROOT, "data", "creditcard.csv"), delimiter=",",
        skiprows=1, max_rows=1000, dtype=np.float32,
    )
    x = data[:, :30]
    out = {}
    for dev in ("cpu", "cuda"):
        model = FraudLogisticModel.load(os.path.join(ROOT, "models"), device=dev)
        profile = build_baseline_profile(
            x, model.scorer.predict_proba(x), feature_names=model.feature_names,
            device=dev,
        )
        wt = Watchtower(profile, device=dev)
        try:
            b = MicroBatcher(model.scorer, max_batch=64, watchtower=wt,
                             fused=True, explain=True, explain_k=3)

            async def go():
                await b.start()
                try:
                    return await asyncio.gather(*(b.score_ex(r) for r in x[:100]))
                finally:
                    await b.stop()

            kernels.reset_launch_counts()
            out[dev] = asyncio.run(go())
            launches = kernels.FUSED_SCORE_LAUNCHES
        finally:
            wt.close()
    assert launches > 0
    for (sc, (ic, _)), (sg, (ig, _)) in zip(out["cpu"], out["cuda"]):
        assert sg == pytest.approx(sc, abs=1e-6)
        assert ig == ic


def _knn_inputs(x: np.ndarray, dev):
    xt = torch.from_numpy(x).to(dev)
    xc = (xt - xt.mean(dim=0)).contiguous()
    return xc, (xc * xc).sum(dim=1)


def _knn_fixture(name: str) -> tuple[np.ndarray, int]:
    """The shapes of chip_smoke.py's phase 2b up to m = 4096, the
    duplicated-rows fixture and the lattice (integer points closed under
    x → −x: every distance exact, every tie an exact tie)."""
    rng = np.random.default_rng(len(name))
    if name == "duplicated":
        base = rng.standard_normal((40, 30)).astype(np.float32)
        return np.concatenate([base, base, base[:9]]), 5
    if name == "lattice":
        half = rng.integers(-3, 4, (150, 30))
        return np.concatenate([half, -half]).astype(np.float32), 5
    m, d, k = (int(v) for v in name.split("x"))
    return rng.standard_normal((m, d)).astype(np.float32), k


@pytest.mark.cuda
@pytest.mark.parametrize(
    "name",
    ["2x30x1", "6x30x5", "126x30x5", "158x30x5", "1000x37x5", "4096x30x5",
     "300x128x32", "500x64x9", "duplicated", "lattice"],
)
def test_knn_kernel_matches_plain_version_exactly(name):
    """Exact index equality: at these sizes no two candidate distances of a
    row sit within float32 rounding of each other, and the lattice's ties
    are exact in every summation order."""
    dev = _require_card()
    x, k = _knn_fixture(name)
    xc, sq = _knn_inputs(x, dev)
    before = kernels.KNN_TOPK_LAUNCHES
    got = kernels.knn_topk(xc, sq, k)
    want = kernels.knn_topk_reference(xc, sq, k)
    torch.cuda.synchronize()
    assert kernels.KNN_TOPK_LAUNCHES == before + 1
    assert got.dtype == torch.int32 and got.shape == (x.shape[0], k)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_knn_wrapper_raises_on_what_the_kernel_does_not_take():
    dev = _require_card()
    xc, sq = _knn_inputs(np.random.default_rng(0).standard_normal((40, 30)).astype(np.float32), dev)
    with pytest.raises(ValueError, match="k < m"):
        kernels.knn_topk(xc[:5].contiguous(), sq[:5], 5)
    with pytest.raises(ValueError, match="k <= 32"):
        kernels.knn_topk(xc, sq, 33)
    wide = torch.zeros((40, 129), device=dev)
    with pytest.raises(ValueError, match="d <= 128"):
        kernels.knn_topk(wide, torch.zeros(40, device=dev), 5)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.knn_topk(torch.zeros((40, 60), device=dev)[:, ::2], sq, 5)


@pytest.mark.cuda
def test_smote_on_the_card_launches_the_kernel_and_matches_cpu():
    """The same seed draws the same synthetic rows on both devices (the
    draws come from a CPU generator); the neighbour indices are equal, so
    the rows agree to float32 rounding of the interpolation."""
    from fraud_detection_tpu_torch.ops.smote import smote

    _require_card()
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3000, 30)).astype(np.float32)
    y = np.zeros(3000, np.int32)
    y[rng.choice(3000, 90, replace=False)] = 1
    kernels.reset_launch_counts()
    xg, yg = smote(torch.from_numpy(x).cuda(), y, seed=5)
    assert kernels.KNN_TOPK_LAUNCHES == 1
    xc, yc = smote(x, y, seed=5)
    np.testing.assert_array_equal(yg, yc)
    np.testing.assert_allclose(xg.cpu().numpy(), xc.numpy(), rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("n, d, n_nodes, n_bins", [
    (31684, 30, 1, 256), (31684, 30, 16, 256), (1031, 30, 4, 16), (5, 3, 2, 256),
    (31684, 1, 1, 32),
])
def test_gbt_hist_kernel_is_deterministic_and_matches_float64(n, d, n_nodes, n_bins):
    """Two launches give the same bits; every cell within 1e-6·Σ|value| of
    its float64 sum; inert rows (node −1, zero weight) add nothing."""
    dev = _require_card()
    rng = np.random.default_rng(n + n_nodes)
    bins = rng.integers(0, n_bins, (n, d)).astype(np.uint8)
    local = rng.integers(-1, n_nodes, n).astype(np.int32)
    g = rng.standard_normal(n).astype(np.float32)
    h = (rng.random(n) * 0.25).astype(np.float32)
    g[::7] = 0.0
    h[::7] = 0.0
    args = [torch.from_numpy(a).to(dev) for a in (bins, local, g, h)]
    before = kernels.GBT_HIST_LAUNCHES
    a = kernels.gbt_hist(*args, n_nodes, n_bins)
    b = kernels.gbt_hist(*args, n_nodes, n_bins)
    torch.cuda.synchronize()
    assert kernels.GBT_HIST_LAUNCHES == before + 2
    assert torch.equal(a, b)
    seg = (local[:, None].astype(np.int64) * n_bins + bins) + np.arange(d) * (n_nodes * n_bins)
    keep = np.broadcast_to((local >= 0)[:, None], seg.shape)
    want = np.zeros((d * n_nodes * n_bins, 2))
    absum = np.zeros_like(want)
    for c, v in ((0, g), (1, h)):
        vv = np.broadcast_to(v[:, None].astype(np.float64), seg.shape)
        np.add.at(want[:, c], seg[keep], vv[keep])
        np.add.at(absum[:, c], seg[keep], np.abs(vv[keep]))
    got = a.cpu().numpy().reshape(-1, 2)
    assert np.all(np.abs(got - want) <= 1e-6 * absum)


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [1.0, 100.0])
@pytest.mark.parametrize("n, d, n_nodes, n_bins", [
    (31684, 30, 1, 256), (31684, 30, 16, 256), (1031, 30, 4, 16), (5, 3, 2, 256),
    (31684, 1, 1, 32),
])
def test_gbt_hist_kernel_equals_its_fixed_point_model_bitwise(n, d, n_nodes, n_bins, scale):
    """Integer sums make the kernel exact to its model: the same quanta and
    the same bits, at unit weights and at g, h scaled by 100 (the order of
    ``scale_pos_weight`` on the committed CSV)."""
    dev = _require_card()
    rng = np.random.default_rng(n + n_nodes + int(scale))
    bins = rng.integers(0, n_bins, (n, d)).astype(np.uint8)
    local = rng.integers(-1, n_nodes, n).astype(np.int32)
    g = (rng.standard_normal(n) * scale).astype(np.float32)
    h = (rng.random(n) * 0.25 * scale).astype(np.float32)
    g[::7] = 0.0
    h[::7] = 0.0
    args = [torch.from_numpy(a).to(dev) for a in (bins, local, g, h)]
    got, quanta = kernels.gbt_hist_and_quanta(*args, n_nodes, n_bins)
    want, want_q = kernels.gbt_hist_fixed_point_reference(*args, n_nodes, n_bins)
    torch.cuda.synchronize()
    assert tuple(quanta.cpu().tolist()) == want_q
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_gbt_hist_floored_hessian_leaf_is_positive():
    """The leaf-sum shape with one leaf whose rows all carry the fit's
    floor h = 1e-16 beside leaves at h ≈ 0.25: its H comes out > 0 (one
    quantum a row, rounded away from zero), bitwise the model's."""
    dev = _require_card()
    rng = np.random.default_rng(16)
    n = 31684
    leaf = rng.integers(0, 32, n).astype(np.uint8)[:, None]
    h = (0.2 + 0.05 * rng.random(n)).astype(np.float32)
    h[leaf[:, 0] == 0] = np.float32(1e-16)
    g = (rng.standard_normal(n) * 1e-3).astype(np.float32)
    args = [torch.from_numpy(a).to(dev) for a in (leaf, np.zeros(n, np.int32), g, h)]
    got = kernels.gbt_hist(*args, 1, 32)
    want, _ = kernels.gbt_hist_fixed_point_reference(*args, 1, 32)
    torch.cuda.synchronize()
    assert float(got[0, 0, 0, 1]) > 0.0
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_gbt_fit_on_the_card_matches_the_cpu_fit():
    """The same forest on both devices (deterministic kernel histograms;
    no near-tie on this fixture), one launch per level and one per tree's
    leaf sums."""
    from fraud_detection_tpu_torch.ops import gbt

    dev = _require_card()
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3000, 30)).astype(np.float32)
    y = (x @ rng.standard_normal(30).astype(np.float32) > 1.0).astype(np.int32)
    cfg = gbt.GBTConfig(n_trees=10, max_depth=5, n_bins=64)
    kernels.reset_launch_counts()
    card = gbt.gbt_fit(torch.from_numpy(x).to(dev), y, cfg)
    assert kernels.GBT_HIST_LAUNCHES == 10 * 6
    cpu = gbt.gbt_fit(x, y, cfg, device="cpu")
    assert torch.equal(card.split_feature.cpu(), cpu.split_feature)
    assert torch.equal(card.split_bin.cpu(), cpu.split_bin)
    np.testing.assert_allclose(card.leaf_value.cpu().numpy(), cpu.leaf_value.numpy(),
                               rtol=0, atol=1e-6)
    xt = torch.from_numpy(x[:500])
    np.testing.assert_allclose(gbt.gbt_predict_proba(card, xt.to(dev)).cpu().numpy(),
                               gbt.gbt_predict_proba(cpu, xt).numpy(), rtol=0, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("depth, trees, n", [(5, 100, 1024), (5, 100, 9), (3, 16, 33), (2, 1, 1)])
def test_tree_shap_kernel_matches_plain_version(depth, trees, n):
    """rtol 1e-4 / atol 2e-5 against the plain body, equal top-3 indices,
    and additivity Σφ + E[f] = f(x)."""
    from fraud_detection_tpu_torch.ops import gbt
    from fraud_detection_tpu_torch.ops import tree_shap as ts
    from fraud_detection_tpu_torch.ops.linear_shap import topk_reasons

    dev = _require_card()
    rng = np.random.default_rng(depth * 100 + trees)
    x = rng.standard_normal((2000, 30)).astype(np.float32)
    y = (x[:, 0] + x[:, 1] * x[:, 2] > 0.2).astype(np.int32)
    model = gbt.gbt_fit(torch.from_numpy(x).to(dev), y,
                        gbt.GBTConfig(n_trees=trees, max_depth=depth, n_bins=64))
    e = ts.build_tree_explainer(model, x[:128])
    rows = torch.from_numpy(x[500:500 + n]).to(dev)
    binned = gbt.bin_features(rows, model.bin_edges)
    before = kernels.TREE_SHAP_LAUNCHES
    got = kernels.tree_shap(binned, e.tables)
    want = kernels.tree_shap_reference(binned, model.split_feature, model.split_bin,
                                       model.leaf_value, e.bg_table)
    torch.cuda.synchronize()
    assert kernels.TREE_SHAP_LAUNCHES == before + 1
    torch.testing.assert_close(got, want, rtol=1e-4, atol=2e-5)
    # a row's phi does not depend on the batch around it (the fused flush
    # pads to its bucket; the standalone explainer does not)
    assert torch.equal(kernels.tree_shap(binned[:1].contiguous(), e.tables), got[:1])
    assert torch.equal(topk_reasons(got, 3)[0], topk_reasons(want, 3)[0])
    recon = got.sum(dim=1) + e.expected_value
    torch.testing.assert_close(recon, gbt.gbt_predict_logits(model, rows), rtol=1e-3, atol=1e-4)


@pytest.mark.cuda
def test_gbt_hist_and_tree_shap_wrappers_raise_on_what_the_kernels_do_not_take():
    dev = _require_card()
    z = torch.zeros(4, device=dev)
    loc = torch.zeros(4, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError, match="uint8"):
        kernels.gbt_hist(torch.zeros((4, 2), dtype=torch.int32, device=dev), loc, z, z, 1, 4)
    with pytest.raises(ValueError, match="n_bins <= 256"):
        kernels.gbt_hist(torch.zeros((4, 2), dtype=torch.uint8, device=dev), loc, z, z, 1, 300)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.gbt_hist(torch.zeros((4, 4), dtype=torch.uint8, device=dev)[:, ::2],
                         loc, z, z, 1, 4)


@pytest.mark.cuda
def test_nan_binning_on_the_card_matches_the_host():
    from fraud_detection_tpu_torch.ops import gbt

    dev = _require_card()
    edges = np.array([[0.0, 1.0, 2.0], [-1.0, 0.0, 5.0]], np.float32)
    x = np.array([[np.nan, 0.5], [np.inf, -np.inf], [-np.inf, np.nan], [1.0, 5.0]], np.float32)
    got = gbt.bin_features(torch.from_numpy(x).to(dev), torch.from_numpy(edges).to(dev))
    np.testing.assert_array_equal(got.cpu().numpy(), gbt.bin_features_host(x, edges, 4))
