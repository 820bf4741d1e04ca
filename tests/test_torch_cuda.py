"""Card-only tests of the port (marker ``cuda``): the hand-written CUDA
kernels against their plain versions, the served path launching
``fused_score`` and SMOTE launching ``knn_topk``.

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
