"""Card-only tests of the port (marker ``cuda``): the hand-written CUDA
kernel against its plain version, and the served path launching it.

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
