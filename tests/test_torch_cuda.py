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


@pytest.fixture(autouse=True)
def empty_tracking_store(tmp_path, monkeypatch):
    """An empty tracking store for every test, so an app or worker serves
    ``MODEL_PATH``'s directory, never a registered ``@prod``."""
    monkeypatch.setenv("MLFLOW_TRACKING_URI", f"file:{tmp_path}/mlruns")
    monkeypatch.setenv("FRAUD_REGISTRY_CACHE", str(tmp_path / "registry_cache"))


def _require_card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n, d", [(1, 30), (1024, 30), (20000, 30), (1031, 37), (8, 30),
                                  (33, 30), (4096, 30), (284807, 30), (5, 1), (300, 65),
                                  (50, 200), (40, 513), (9, 1025), (3, 3000), (8191, 30),
                                  (8192, 30), (8193, 1), (10000, 64), (10000, 65)])
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


def _score_inputs(n: int, d: int, dev, seed: int = 3):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32)).to(dev)
    w = torch.from_numpy((rng.standard_normal(d) / np.sqrt(d)).astype(np.float32)).to(dev)
    return x, w, torch.tensor(-0.5, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("n, d", [(1, 30), (8, 30), (33, 37), (1024, 30), (20000, 30),
                                  (284807, 30), (77, 64), (40, 513), (8193, 37),
                                  (10000, 64), (10000, 65)])
def test_bf16_rows_are_bitwise_the_f32_path_on_their_values(n, d):
    """bf16 rows are upcast exactly as they are read: the scores equal
    the kernel's on ``x.float()`` bit for bit, and the plain version on the
    bf16 rows within 1e-6."""
    dev = _require_card()
    x, w, b = _score_inputs(n, d, dev)
    xb = x.bfloat16()
    before = kernels.FUSED_SCORE_LAUNCHES
    got = kernels.fused_score(w, b, xb)
    via_f32 = kernels.fused_score(w, b, xb.float())
    want = kernels.fused_score_reference(w, b, xb)
    torch.cuda.synchronize()
    assert kernels.FUSED_SCORE_LAUNCHES == before + 2
    assert got.dtype == torch.float32 and got.shape == (n,)
    assert torch.equal(got.view(torch.int32), via_f32.view(torch.int32))
    assert float((got - want).abs().max()) <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 30, 37, 64])
def test_a_row_scores_the_same_bits_in_either_shape(d):
    """The launcher takes a warp a row for 4096 rows and a thread a row of
    a tile for 20,000 (d <= 64): the rows the two batches share get the
    same bits."""
    dev = _require_card()
    x, w, b = _score_inputs(20000, d, dev)
    whole = kernels.fused_score(w, b, x)
    head = kernels.fused_score(w, b, x[:4096])
    torch.cuda.synchronize()
    assert torch.equal(whole[:4096].view(torch.int32), head.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("view", ["rows", "flat"])
@pytest.mark.parametrize("d", [30, 37])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1000, 10000])
def test_views_off_16_byte_alignment_give_the_same_bits(view, d, dtype, n):
    """``x[1:]`` (one row in) and a flat buffer one element in start off a
    16-byte boundary; the kernel takes them as they are, with the bits it
    gives an aligned copy of the same rows, within 1e-6 of the plain
    version, at a row count of each of the kernel's shapes."""
    dev = _require_card()
    rng = np.random.default_rng(d)
    buf = torch.from_numpy(rng.standard_normal((n + 1) * d + 1, dtype=np.float32))
    buf = buf.to(dev).to(dtype)
    x = buf[: (n + 1) * d].view(n + 1, d)[1:] if view == "rows" else buf[1 : 1 + n * d].view(n, d)
    assert x.is_contiguous() and x.data_ptr() % 16
    w = torch.from_numpy((rng.standard_normal(d) / np.sqrt(d)).astype(np.float32)).to(dev)
    b = torch.tensor(-0.5, device=dev)
    got = kernels.fused_score(w, b, x)
    aligned = kernels.fused_score(w, b, x.clone())
    want = kernels.fused_score_reference(w, b, x)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), aligned.view(torch.int32))
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
     "300x128x32", "500x64x9", "duplicated", "lattice",
     # tile and split edges: one key tile and one over (32 rows), one over
     # 4 tiles, 8 and 32 tiles plus one, the switch to 128-row tiles; k = 32
     # at d = 128, and d = 1
     "33x30x5", "129x30x5", "257x30x5", "1025x30x5", "4097x30x5", "5000x30x5",
     "1025x128x32", "33x128x32", "500x1x5",
     # more than 32 features above 4096 rows
     "5000x64x5"],
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
@pytest.mark.parametrize(
    "name", ["158x30x5", "1025x128x32", "5000x30x5", "5000x128x32", "lattice"]
)
def test_knn_kernel_two_launches_are_bitwise_equal(name):
    dev = _require_card()
    x, k = _knn_fixture(name)
    xc, sq = _knn_inputs(x, dev)
    first = kernels.knn_topk(xc, sq, k).clone()
    second = kernels.knn_topk(xc, sq, k)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [126, 158])
def test_knn_plan_spreads_the_training_sizes_over_tens_of_blocks(m):
    dev = _require_card()
    plan = kernels.knn_topk_plan(m, 30, 5, dev)
    assert plan["splits"] > 1 and plan["splits"] * plan["query_tiles"] >= 10
    assert plan["splits"] * plan["keys_per_split"] >= m


@pytest.mark.cuda
def test_knn_launch_refuses_a_scratch_smaller_than_its_plan():
    dev = _require_card()
    x, k = _knn_fixture("158x30x5")
    xc, sq = _knn_inputs(x, dev)
    m, d = xc.shape
    splits = kernels.knn_topk_plan(m, d, k, dev)["splits"]
    assert splits > 1
    lib = kernels._lib("knn_topk")
    out = torch.empty((m, k), dtype=torch.int32, device=dev)
    short = torch.empty((splits - 1, m, k), dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for ptr, nbytes in ((None, 0), (short.data_ptr(), short.numel() * 8)):
        rc = lib.knn_topk_launch(xc.data_ptr(), sq.data_ptr(), ptr, nbytes, out.data_ptr(),
                                 m, d, k, torch.cuda.current_device(), stream)
        assert rc != 0


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


def _random_forest(rng, trees: int, depth: int, d: int, n_bins: int):
    from fraud_detection_tpu_torch.ops.gbt import GBTModel

    nodes = 2**depth - 1
    return GBTModel(
        split_feature=torch.from_numpy(rng.integers(0, d, (trees, nodes)).astype(np.int32)),
        split_bin=torch.from_numpy(rng.integers(0, n_bins - 1, (trees, nodes)).astype(np.int32)),
        leaf_value=torch.from_numpy((0.1 * rng.standard_normal((trees, 2**depth))).astype(np.float32)),
        bin_edges=torch.from_numpy(np.sort(rng.standard_normal((d, n_bins - 1)), axis=1).astype(np.float32)),
        base_logit=torch.tensor(-1.0),
    )


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 8, 64])
def test_gbt_card_score_does_not_depend_on_the_batch(n):
    """A row's forest score on the card has the same bits alone, in a
    bucket of 8 and in a batch of 1024 (the recipe's 100 trees of depth
    5): the lanes' scores are bitwise /predict's only so."""
    from fraud_detection_tpu_torch.ops import gbt

    dev = _require_card()
    rng = np.random.default_rng(3)
    model = _random_forest(rng, 100, 5, 30, 256).to(dev)
    rows = torch.from_numpy(rng.standard_normal((1024, 30)).astype(np.float32)).to(dev)
    full = gbt.gbt_predict_proba(model, rows)
    for i in range(0, 64, n):
        assert torch.equal(gbt.gbt_predict_proba(model, rows[i:i + n]), full[i:i + n]), i


@pytest.mark.cuda
@pytest.mark.parametrize("depth, trees, n", [
    (5, 100, 1024), (5, 100, 9), (3, 16, 33), (2, 1, 1),
    (5, 100, 1), (5, 100, 8), (5, 100, 64), (5, 101, 1025), (5, 9, 8), (1, 3, 64),
])
def test_tree_shap_kernel_matches_plain_version(depth, trees, n):
    """rtol 1e-4 / atol 2e-5 against the plain body, equal top-3 indices,
    and additivity Σφ + E[f] = f(x) — at the buckets' sizes and past them,
    with tree counts that are and are not a multiple of the kernel's group
    of trees."""
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
def test_tree_shap_at_explains_row_count_matches_plain_on_sampled_rows():
    """``explain``'s largest batch, n = 20,000 rows, over 100 trees of
    depth 5 (about 13 groups × 10 row chunks, a (groups, d, n) scratch of
    31.2 MB): 1,024 rows sampled across the batch within rtol 1e-4 /
    atol 2e-5 of the plain version on those rows, and additive."""
    from fraud_detection_tpu_torch.ops import gbt
    from fraud_detection_tpu_torch.ops import tree_shap as ts

    dev = _require_card()
    rng = np.random.default_rng(20000)
    x = rng.standard_normal((22000, 30)).astype(np.float32)
    y = (x[:, 0] + x[:, 1] * x[:, 2] > 0.2).astype(np.int32)
    model = gbt.gbt_fit(torch.from_numpy(x[:2000]).to(dev), y[:2000],
                        gbt.GBTConfig(n_trees=100, max_depth=5, n_bins=256))
    e = ts.build_tree_explainer(model, x[:128])
    rows = torch.from_numpy(x[2000:]).to(dev)
    binned = gbt.bin_features(rows, model.bin_edges)
    before = kernels.TREE_SHAP_LAUNCHES
    got = kernels.tree_shap(binned, e.tables)
    torch.cuda.synchronize()
    assert kernels.TREE_SHAP_LAUNCHES == before + 1
    sample = torch.from_numpy(np.sort(rng.choice(20000, 1024, replace=False))).to(dev)
    want = kernels.tree_shap_reference(binned[sample], model.split_feature, model.split_bin,
                                       model.leaf_value, e.bg_table)
    torch.testing.assert_close(got[sample], want, rtol=1e-4, atol=2e-5)
    assert bool(torch.isfinite(got).all())
    recon = got.sum(dim=1) + e.expected_value
    torch.testing.assert_close(recon, gbt.gbt_predict_logits(model, rows), rtol=1e-3, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["logistic", "gbt"])
def test_evaluate_on_the_card_matches_the_cpu(family, tmp_path):
    """``evaluate`` on the committed CSV's test split (4,000 rows): the
    same confusion matrix as on the CPU, the AUC within 1e-6, the scores
    within 1e-5; one ``fused_score`` launch for the logistic model."""
    from fraud_detection_tpu_torch.evaluate import evaluate
    from fraud_detection_tpu_torch.models import FraudGBTModel
    from fraud_detection_tpu_torch.ops.gbt import GBTConfig, gbt_fit

    dev = _require_card()
    csv = os.path.join(ROOT, "data", "creditcard.csv")
    model_dir = os.path.join(ROOT, "models")
    if family == "gbt":
        data = np.loadtxt(csv, delimiter=",", skiprows=1, max_rows=4000, dtype=np.float32)
        forest = gbt_fit(data[:, :30], data[:, 30].astype(np.int32),
                         GBTConfig(n_trees=20, max_depth=4, n_bins=64), device=dev)
        model_dir = str(tmp_path / "gbt")
        FraudGBTModel(forest, FraudLogisticModel.load(os.path.join(ROOT, "models"),
                                                      device="cpu").feature_names,
                      background=data[:64, :30], device=dev).save(model_dir)
    kernels.reset_launch_counts()
    card = evaluate(csv, model_dir, None, device="cuda")
    launches = kernels.launch_counts()
    cpu = evaluate(csv, model_dir, None, device="cpu")
    assert card["confusion_matrix"] == cpu["confusion_matrix"]
    assert abs(card["auc"] - cpu["auc"]) <= 1e-6
    np.testing.assert_allclose(card["scores"], cpu["scores"], rtol=0, atol=1e-5)
    if family == "logistic":
        assert launches["fused_score"] == 1


@pytest.mark.cuda
def test_tree_shap_is_bitwise_batch_independent_and_deterministic():
    """A row's φ is bitwise the same alone, at position 7 of an 8-row batch
    and at position 1000 of a 1024-row batch (the fused flush pads to its
    bucket; the standalone explainer does not), and two launches agree
    bitwise — on a forest whose tree count is not a multiple of the group."""
    from fraud_detection_tpu_torch.ops import gbt
    from fraud_detection_tpu_torch.ops import tree_shap as ts

    dev = _require_card()
    rng = np.random.default_rng(101)
    x = rng.standard_normal((3000, 30)).astype(np.float32)
    y = (x[:, 0] + x[:, 1] * x[:, 2] > 0.2).astype(np.int32)
    trees = 12 * kernels.TREE_SHAP_GROUP + 5
    model = gbt.gbt_fit(torch.from_numpy(x).to(dev), y,
                        gbt.GBTConfig(n_trees=trees, max_depth=5, n_bins=256))
    e = ts.build_tree_explainer(model, x[:128])
    binned = gbt.bin_features(torch.from_numpy(x[1000:2024]).to(dev), model.bin_edges)
    full = kernels.tree_shap(binned, e.tables)
    again = kernels.tree_shap(binned, e.tables)
    torch.cuda.synchronize()
    assert torch.equal(full, again)
    for r in (1000, 3, 511):
        alone = kernels.tree_shap(binned[r:r + 1].contiguous(), e.tables)
        batch8 = torch.cat([binned[r + 1:r + 8], binned[r:r + 1]]) if r + 8 <= 1024 else \
            torch.cat([binned[r - 7:r], binned[r:r + 1]])
        in8 = kernels.tree_shap(batch8.contiguous(), e.tables)
        moved = binned.clone()
        moved[[r, 1000]] = binned[[1000, r]]
        in1024 = kernels.tree_shap(moved, e.tables)
        torch.cuda.synchronize()
        assert torch.equal(alone[0], full[r])
        assert torch.equal(in8[7], full[r])
        assert torch.equal(in1024[1000], full[r])


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


def _queue_explain_tasks(broker, db, rows, names, prefix):
    for i, row in enumerate(rows):
        feats = {n: float(v) for n, v in zip(names, row)}
        db.create_pending(f"{prefix}{i}", feats, None)
        broker.send_task("xai_tasks.compute_shap", [f"{prefix}{i}", feats, None])


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["logistic", "gbt"])
def test_worker_run_batch_on_the_card(family, tmp_path, monkeypatch):
    """The SHAP worker on the card: ``run_batch`` of 64 tasks in one
    dispatch launches the family's kernel (``fused_score`` for logistic
    scoring, ``tree_shap`` for GBT explanations), a second run of the same
    rows stores bitwise the same values, and a CPU worker agrees within
    the kernels' tolerances."""
    from fraud_detection_tpu_torch.models import FraudGBTModel
    from fraud_detection_tpu_torch.ops.gbt import GBTConfig, gbt_fit
    from fraud_detection_tpu_torch.service.db import COMPLETED, ResultsDB
    from fraud_detection_tpu_torch.service.taskq import Broker
    from fraud_detection_tpu_torch.service.worker import XaiWorker

    _require_card()
    data = np.loadtxt(os.path.join(ROOT, "data", "creditcard.csv"), delimiter=",",
                      skiprows=1, max_rows=2000, dtype=np.float32)
    x, y = data[:, :30], data[:, 30].astype(np.int32)
    names = FraudLogisticModel.load(os.path.join(ROOT, "models"), device="cpu").feature_names
    if family == "gbt":
        model_dir = str(tmp_path / "gbt")
        forest = gbt_fit(x, y, GBTConfig(n_trees=20, max_depth=5, n_bins=64), device="cuda")
        FraudGBTModel(forest, names, background=x[:128], device="cuda").save(model_dir)
        monkeypatch.setenv("MODEL_PATH", os.path.join(model_dir, "model.npz"))
        counter = "TREE_SHAP_LAUNCHES"
    else:
        monkeypatch.setenv("MODEL_PATH", os.path.join(ROOT, "models", "model.npz"))
        counter = "FUSED_SCORE_LAUNCHES"
    db_url, q_url = f"sqlite:///{tmp_path}/f.db", f"sqlite:///{tmp_path}/q.db"
    broker, db = Broker(q_url), ResultsDB(db_url)
    rows = x[1000:1064]
    worker = XaiWorker(broker_url=q_url, database_url=db_url, device="cuda")
    stored = {}
    for run in ("a", "b"):
        _queue_explain_tasks(broker, db, rows, names, run)
        kernels.reset_launch_counts()
        assert worker.run_batch(64) == 64
        assert getattr(kernels, counter) >= 1
        got = [db.get(f"{run}{i}") for i in range(64)]
        assert all(r["status"] == COMPLETED for r in got)
        stored[run] = np.array([[r["prediction_score"], r["expected_value"],
                                 *r["shap_values"].values()] for r in got])
    np.testing.assert_array_equal(stored["a"], stored["b"])
    cpu = XaiWorker(broker_url=q_url, database_url=db_url, device="cpu")
    _queue_explain_tasks(broker, db, rows, names, "c")
    assert cpu.run_batch(64) == 64
    want = np.array([[r["prediction_score"], r["expected_value"], *r["shap_values"].values()]
                     for r in (db.get(f"c{i}") for i in range(64))])
    np.testing.assert_allclose(stored["a"], want, rtol=1e-4, atol=2e-5)
    for w in (worker, cpu):
        w.close()


def _wire_models(wire, monkeypatch, x, y):
    """(family → {device: model}) on ``wire``: the committed logistic model
    and a small forest fitted on the CPU, its int8 calibration derived
    from a scaler of the same rows."""
    from fraud_detection_tpu_torch.models import FraudGBTModel
    from fraud_detection_tpu_torch.ops.gbt import GBTConfig, gbt_fit
    from fraud_detection_tpu_torch.ops.quant import derive_calibration
    from fraud_detection_tpu_torch.ops.scaler import scaler_fit

    monkeypatch.setenv("SCORER_WIRE", wire)
    names = FraudLogisticModel.load(os.path.join(ROOT, "models"), device="cpu").feature_names
    forest = gbt_fit(x, y, GBTConfig(n_trees=20, max_depth=5, n_bins=64), device="cpu")
    cal = derive_calibration(scaler_fit(torch.from_numpy(x)))
    out = {"logistic": {}, "gbt": {}}
    for dev in ("cpu", "cuda"):
        out["logistic"][dev] = FraudLogisticModel.load(os.path.join(ROOT, "models"), device=dev)
        out["gbt"][dev] = FraudGBTModel(forest, names, background=x[:64], calibration=cal,
                                        device=dev)
    return out


def _staged_fused_flush(scorer, mon, rows, k):
    from fraud_detection_tpu_torch.ops.scorer import _bucket
    from fraud_detection_tpu_torch.service.microbatch import fetch

    n = len(rows)
    spec = scorer.fused_spec()
    slot = scorer.staging.acquire(_bucket(n, scorer.min_bucket))
    try:
        hx = scorer.stage_items(slot, [(r,) for r in rows])
        out = mon.fused_flush(scorer.to_device(hx), scorer.to_device(slot.valid), n,
                              spec.score_args, spec.score_fn, dequant_scale=spec.dequant_scale,
                              score_codes=spec.score_codes, explain_args=spec.explain_args,
                              explain_k=k)
        return [h[:n].copy() for h in fetch(*out)]
    finally:
        scorer.staging.release(slot)


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["bfloat16", "int8"])
@pytest.mark.parametrize("family", ["logistic", "gbt"])
def test_narrow_wire_fused_flush_on_the_card_matches_the_cpu(family, wire, monkeypatch):
    """The bf16 and int8 fused flushes with explain on the card against the
    same flushes on the CPU: scores within 1e-6, reason codes equal but
    across a 2e-5 tie (values within 1e-6, or TreeSHAP's rtol 1e-4 / atol
    2e-5), feature counts equal (a half-life long enough that the window
    holds whole counts); the family's kernel launched."""
    from fraud_detection_tpu_torch.monitor.drift import DriftMonitor

    _require_card()
    data = np.loadtxt(os.path.join(ROOT, "data", "creditcard.csv"), delimiter=",",
                      skiprows=1, max_rows=2000, dtype=np.float32)
    x, y = data[:, :30], data[:, 30].astype(np.int32)
    models = _wire_models(wire, monkeypatch, x, y)[family]
    cpu = models["cpu"]
    profile = build_baseline_profile(x, cpu.scorer.predict_proba(x),
                                     feature_names=cpu.feature_names, device="cpu")
    out, windows = {}, {}
    for dev, model in models.items():
        assert model.scorer.io_dtype == wire
        mon = DriftMonitor(profile, halflife_rows=1e12, device=dev)
        kernels.reset_launch_counts()
        out[dev] = [_staged_fused_flush(model.scorer, mon, x[lo:lo + n], 3)
                    for lo, n in ((0, 1), (1, 64), (65, 700))]
        launches = kernels.launch_counts()
        windows[dev] = mon.window.feature_counts.cpu().numpy()
    assert launches["fused_score" if family == "logistic" else "tree_shap"] == 3
    rtol, atol = (0.0, 1e-6) if family == "logistic" else (1e-4, 2e-5)
    for (lo, n), (sc, ic, vc), (sg, ig, vg) in zip(((0, 1), (1, 64), (65, 700)),
                                                  out["cpu"], out["cuda"]):
        np.testing.assert_allclose(sg, sc, rtol=0, atol=1e-6)
        np.testing.assert_allclose(vg, vc, rtol=rtol, atol=atol)
        hx = cpu.scorer._prepare_host(np.ascontiguousarray(x[lo:lo + n]))
        xf = (hx.float().numpy() if isinstance(hx, torch.Tensor)
              else hx.astype(np.float32) * cpu.scorer._quant_scale)
        srt = -np.sort(-cpu.explain_batch(xf)[0], axis=1)
        for i in np.nonzero((ig != ic).any(axis=1))[0]:
            assert abs(srt[i, 2] - srt[i, 3]) <= 2e-5, (lo + i, ig[i], ic[i])
    np.testing.assert_array_equal(windows["cuda"], windows["cpu"])


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["bfloat16", "int8"])
def test_pinned_io_buffer_is_reused_across_flushes(wire, monkeypatch):
    """The micro-batcher's flushes on the card ship the slot's pinned
    ``io`` buffer: the same buffer flush after flush, the pool's
    ``allocations`` constant after the first, the scores unchanged."""
    _require_card()
    monkeypatch.setenv("SCORER_WIRE", wire)
    data = np.loadtxt(os.path.join(ROOT, "data", "creditcard.csv"), delimiter=",",
                      skiprows=1, max_rows=1000, dtype=np.float32)
    x = data[:, :30]
    model = FraudLogisticModel.load(os.path.join(ROOT, "models"), device="cuda")
    profile = build_baseline_profile(x, model.scorer.predict_proba(x),
                                     feature_names=model.feature_names, device="cuda")
    wt = Watchtower(profile, device="cuda")
    try:
        b = MicroBatcher(model.scorer, max_batch=64, watchtower=wt, fused=True,
                         explain=True, explain_k=3)
        scorer = b.scorer
        target = b._fused_target(scorer)
        batch = [(x[i], None) for i in range(64)]
        ptrs, scores, allocs = set(), [], []
        for _ in range(5):
            res = b._flush_device(scorer, target, batch)
            slot = res[-1]
            io = slot.io if isinstance(slot.io, torch.Tensor) else torch.from_numpy(slot.io)
            assert io.is_pinned() and io.dtype == {"bfloat16": torch.bfloat16,
                                                    "int8": torch.int8}[wire]
            ptrs.add(io.data_ptr())
            scores.append(res[0].copy())
            scorer.staging.release(slot)
            allocs.append(scorer.staging.allocations)
    finally:
        wt.close()
    assert len(ptrs) == 1 and len(set(allocs)) == 1
    for s in scores[1:]:
        np.testing.assert_array_equal(s, scores[0])


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["float32", "bfloat16", "int8"])
def test_predict_proba_stream_on_the_card_matches_the_cpu(wire, monkeypatch):
    """The chunked stream on the card (a CUDA stream per worker thread)
    against ``predict_proba`` on the CPU over the same wire: within 1e-6,
    in row order."""
    _require_card()
    monkeypatch.setenv("SCORER_WIRE", wire)
    x = np.random.default_rng(5).standard_normal((5000, 30)).astype(np.float32)
    card = FraudLogisticModel.load(os.path.join(ROOT, "models"), device="cuda").scorer
    cpu = FraudLogisticModel.load(os.path.join(ROOT, "models"), device="cpu").scorer
    got = card.predict_proba_stream(x, chunk=512, inflight=4)
    np.testing.assert_allclose(got, cpu.predict_proba(x), rtol=0, atol=1e-6)


def test_a_cuda_worker_without_a_card_raises(tmp_path, monkeypatch):
    """No fallback: a worker (or app) asked for ``cuda`` where
    ``torch.cuda.is_available()`` is False raises. Runs on either machine:
    the card is hidden from it."""
    from fraud_detection_tpu_torch.service.app import create_app
    from fraud_detection_tpu_torch.service.worker import XaiWorker

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("MODEL_PATH", os.path.join(ROOT, "models", "model.npz"))
    with pytest.raises(RuntimeError, match="cuda"):
        XaiWorker(broker_url=f"sqlite:///{tmp_path}/q.db",
                  database_url=f"sqlite:///{tmp_path}/f.db", device="cuda")
    monkeypatch.setenv("DEVICE", "cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        XaiWorker(broker_url=f"sqlite:///{tmp_path}/q.db",
                  database_url=f"sqlite:///{tmp_path}/f.db")
    with pytest.raises(RuntimeError, match="cuda"):
        create_app(database_url=f"sqlite:///{tmp_path}/f.db",
                   broker_url=f"sqlite:///{tmp_path}/q.db")


def _card_served(tmp_path, monkeypatch, family):
    """models/ (or a card-fitted 20-tree forest) with a drift baseline, an
    empty tracking store, explain on: the app's settings for the lanes."""
    import shutil

    from fraud_detection_tpu_torch.monitor.baseline import save_profile

    x = np.loadtxt(os.path.join(ROOT, "data", "creditcard.csv"), delimiter=",",
                   skiprows=1, max_rows=2048, dtype=np.float32)
    d = str(tmp_path / "models")
    if family == "logistic":
        shutil.copytree(os.path.join(ROOT, "models"), d)
        model = FraudLogisticModel.load(d, device="cuda")
    else:
        from fraud_detection_tpu_torch.models import load_any_model
        from fraud_detection_tpu_torch.models.gbt import FraudGBTModel
        from fraud_detection_tpu_torch.ops import gbt
        from fraud_detection_tpu_torch.ops.scaler import scaler_fit

        scaler = scaler_fit(torch.from_numpy(x[:, :30]).cuda())
        xs = ((torch.from_numpy(x[:, :30]).cuda() - scaler.mean) / scaler.scale)
        fit = gbt.gbt_fit(xs, x[:, 30].astype(np.int32),
                          gbt.GBTConfig(n_trees=20, max_depth=5, n_bins=64))
        names = FraudLogisticModel.load(os.path.join(ROOT, "models"),
                                        device="cpu").feature_names
        FraudGBTModel(fit, names, scaler=scaler, background=x[:64, :30]).save(d)
        model = load_any_model(d, device="cuda")
    profile = build_baseline_profile(x[:, :30], model.scorer.predict_proba(x[:, :30]),
                                     feature_names=model.feature_names, device="cuda")
    save_profile(d, profile)
    monkeypatch.setenv("MODEL_PATH", os.path.join(d, "model.npz"))
    monkeypatch.setenv("SCORER_EXPLAIN", "topk")
    monkeypatch.setenv("SCORER_MAX_BATCH", "256")
    monkeypatch.setenv("DATABASE_URL", f"sqlite:///{tmp_path}/f.db")
    monkeypatch.setenv("CELERY_BROKER_URL", f"sqlite:///{tmp_path}/q.db")
    monkeypatch.setenv("DEVICE", "cuda")
    return np.ascontiguousarray(x[:, :30])


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["logistic", "gbt"])
def test_socket_lane_scores_bitwise_predict_on_the_card(family, tmp_path, monkeypatch):
    """Frames of 1, 64 and 256 rows through the binary lane score the bits
    /predict gives the same rows on the card, with equal reason codes; the
    staging pool allocates nothing once warm."""
    import json
    import socket
    import threading

    from fraud_detection_tpu_torch.service import binlane
    from fraud_detection_tpu_torch.service.app import create_app
    from fraud_detection_tpu_torch.service.http import Request

    _require_card()
    x = _card_served(tmp_path, monkeypatch, family)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    monkeypatch.setenv("INGEST_PORT", str(port))
    monkeypatch.setenv("INGEST_HOST", "127.0.0.1")
    loop = asyncio.new_event_loop()
    t = threading.Thread(target=loop.run_forever, daemon=True)
    t.start()

    def call(coro):
        return asyncio.run_coroutine_threadsafe(coro, loop).result(120)

    app = create_app()
    try:
        call(app.startup())
        rows = x[:256]
        with binlane.BinLaneClient("127.0.0.1", port) as cli:
            frames = [cli.score_batch(rows[:1]), cli.score_batch(rows[:64]),
                      cli.score_batch(rows)]
            pool = app.state["model"].scorer.staging
            before = pool.allocations
            for _ in range(10):
                cli.score_batch(rows)
            assert pool.allocations == before
        names = app.state["model"].feature_names
        for i in (0, 1, 63, 100, 255):
            req = Request("POST", "/predict", {"content-type": "application/json"},
                          json.dumps({"features": rows[i].tolist()}).encode())
            body = json.loads(call(app.dispatch(req)).body)
            for scores, (idx, _vals) in frames:
                if i < len(scores):
                    assert np.float32(body["score"]).tobytes() == scores[i:i + 1].tobytes()
                    assert [c["feature"] for c in body["reason_codes"]] == \
                        [names[j] for j in idx[i]]
    finally:
        call(app.shutdown())
        loop.call_soon_threadsafe(loop.stop)
        t.join(30)


@pytest.mark.cuda
def test_one_fence_a_flush_with_spyglass_on(monkeypatch):
    """With spyglass on, every flush on the card waits on ONE CUDA event
    and never on torch.cuda.synchronize; with it off, on none."""
    from fraud_detection_tpu_torch.service import metrics, microbatch

    _require_card()
    model = FraudLogisticModel.load(os.path.join(ROOT, "models"), device="cuda")
    fences = []
    real = microbatch._fence
    monkeypatch.setattr(microbatch, "_fence", lambda dev: (fences.append(dev), real(dev)))

    def refuse(*a, **k):
        raise AssertionError("the flush synchronised the whole device")

    x = np.random.default_rng(0).standard_normal((64, 30)).astype(np.float32)
    hist = metrics.microbatch_size._children[()]
    for telemetry in (True, False):
        b = MicroBatcher(model.scorer, max_batch=16, telemetry=telemetry,
                         fused=False, explain=False)

        async def go():
            await b.start()  # the warm-up may synchronise; the flushes may not
            sync = torch.cuda.synchronize
            torch.cuda.synchronize = refuse
            try:
                for lo in range(0, 64, 16):
                    await asyncio.gather(*(b.score(r) for r in x[lo:lo + 16]))
            finally:
                torch.cuda.synchronize = sync
                await b.stop()

        fences.clear()
        count0 = hist.count
        asyncio.run(go())
        flushes = hist.count - count0
        assert flushes >= 4
        assert len(fences) == (flushes if telemetry else 0)
        assert all(d.type == "cuda" for d in fences)


def _ledger_rows(n=3000, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 30)).astype(np.float32)
    x[:, -1] = np.abs(x[:, -1]) * 50.0
    names = ["Time"] + [f"V{i}" for i in range(1, 29)] + ["Amount"]
    x[:, 0] = np.sort(rng.uniform(0, 3 * 3600, n))
    return x, names


@pytest.mark.cuda
@pytest.mark.parametrize("slots", [64, 8192])
def test_ledger_replay_is_bitwise_on_the_card(slots):
    """Two replays on the card are bitwise equal (the accumulating
    index_put_ sorts; the maxima are order-free), and the card's replay
    matches the CPU's: last_ts, fingerprints and counts equal, the float
    columns within rtol/atol 1e-5."""
    from fraud_detection_tpu_torch.ledger import (
        LedgerSpec,
        materialize_features,
        synthesize_entities,
    )

    _require_card()
    x, names = _ledger_rows()
    spec = LedgerSpec(n_base=30, slots=slots, halflife_s=3600.0, amount_col=-1)
    ents, ts = synthesize_entities(x, names, 42, 20)
    (f1, s1), (f2, s2), (fc, sc) = (
        materialize_features(spec, x, ents, ts, device=d) for d in ("cuda", "cuda", "cpu")
    )
    assert f1.tobytes() == f2.tobytes()
    for a, b, c, name in zip(s1, s2, sc, s1._fields):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes(), name
        if name == "acc":
            np.testing.assert_allclose(a, c, rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_array_equal(a, c, err_msg=name)
    np.testing.assert_allclose(f1, fc, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_ledger_flush_on_the_card_is_a_replay(tmp_path):
    """A widened model served on the card: one fused_score launch a ledger
    flush (at d = 34), and the served table bitwise a replay of the served
    rows in the flush partition."""
    from fraud_detection_tpu_torch.ledger import (
        LEDGER_FEATURE_NAMES,
        LedgerSpec,
        materialize_features,
    )
    from fraud_detection_tpu_torch.ledger.state import host_state
    from fraud_detection_tpu_torch.ops.logistic import LogisticParams
    from fraud_detection_tpu_torch.ops.scaler import scaler_fit

    dev = _require_card()
    x, names = _ledger_rows()
    spec = LedgerSpec(n_base=30, slots=8192, halflife_s=3600.0, amount_col=-1)
    ents = [f"card-{i % 37}" for i in range(len(x))]
    ts = np.arange(1.0, len(x) + 1.0, dtype=np.float32)
    feats, state = materialize_features(spec, x, ents, ts, device="cuda")
    xw = np.concatenate([x, feats], axis=1).astype(np.float32)
    rng = np.random.default_rng(1)
    params = LogisticParams(coef=torch.from_numpy(rng.standard_normal(34).astype(np.float32) * 0.2),
                            intercept=torch.tensor(-0.3))
    model = FraudLogisticModel(params, scaler_fit(torch.from_numpy(xw)),
                               names + list(LEDGER_FEATURE_NAMES), io_dtype="float32",
                               device=dev, ledger_spec=spec, ledger_state=state)
    scores = model.scorer.predict_proba(xw[:2048])
    wt = Watchtower(build_baseline_profile(xw[:2048], scores, feature_names=model.feature_names,
                                           device="cuda"), device=dev)
    wt.drift.bind_ledger(spec, state)
    b = MicroBatcher(model.scorer, watchtower=wt, telemetry=False, explain=True)
    tgt = b._fused_target(model.scorer)
    rows, batch_ents, batch_ts = x[:320], [f"card-{i % 9}" if i % 7 else None
                                           for i in range(320)], ts[-1] + 5.0 + np.arange(320.0)
    try:
        before = kernels.FUSED_SCORE_LAUNCHES
        for lo in range(0, 320, 64):
            items = []
            for i in range(lo, lo + 64):
                ent = None
                if batch_ents[i] is not None:
                    s, fp = spec.row_keys(batch_ents[i])
                    ent = (s, fp, float(np.float32(batch_ts[i])))
                items.append((rows[i], None, None, ent))
            out = b._flush_device(model.scorer, tgt, items)
            model.scorer.staging.release(out[-1])
        assert kernels.FUSED_SCORE_LAUNCHES == before + 5
        _, replayed = materialize_features(spec, rows, batch_ents,
                                           batch_ts.astype(np.float32), state=state,
                                           batch=64, device="cuda")
        snap = wt.drift.ledger_snapshot()
        for a, c, name in zip(host_state(snap), replayed, snap._fields):
            assert a.tobytes() == np.asarray(c).tobytes(), name
    finally:
        wt.close()
