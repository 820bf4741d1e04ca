"""The port's fused_score kernel module against the JAX package's Pallas
``fused_score`` (interpret mode on the CPU, as tests/test_pallas_kernels.py
runs it) and its XLA reference ``_raw_score_linear``.

On the CPU the wrapper takes the plain PyTorch version; the CUDA kernel
itself is compared with that plain version on the card
(tests/test_torch_cuda.py and ``chip_smoke.py``)."""

import numpy as np
import pytest
import torch

from fraud_detection_tpu.ops.pallas_kernels import fused_score as jax_fused_score
from fraud_detection_tpu.ops.scorer import _raw_score_linear as jax_raw_score_linear
from fraud_detection_tpu_torch.ops import kernels

torch.set_num_threads(1)

D = 30


def _inputs(n: int, d: int = D, seed: int = 5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    w = rng.standard_normal(d).astype(np.float32)
    b = np.float32(-2.0)
    return x, w, b


@pytest.mark.parametrize("n", [1, 7, 1024, 1031])
def test_fused_score_reference_matches_jax(n):
    """Tolerance 1e-6 absolute: both sides compute x·w + b in f32 with
    different summation orders (≈1e-6 relative on z), and the sigmoid's
    slope is at most 1/4."""
    x, w, b = _inputs(n)
    got = kernels.fused_score_reference(
        torch.from_numpy(w), torch.tensor(b), torch.from_numpy(x)
    ).numpy()
    pallas = np.asarray(jax_fused_score(w, b, x, interpret=True))
    xla = np.asarray(jax_raw_score_linear((w, b), x))
    assert got.shape == (n,)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, xla, rtol=0, atol=1e-6)


def test_cpu_wrapper_uses_plain_version_and_does_not_count():
    x, w, b = _inputs(64)
    kernels.reset_launch_counts()
    xt, wt, bt = torch.from_numpy(x), torch.from_numpy(w), torch.tensor(b)
    got = kernels.fused_score(wt, bt, xt)
    assert kernels.FUSED_SCORE_LAUNCHES == 0
    assert kernels.launch_counts() == {"fused_score": 0, "knn_topk": 0}
    assert torch.equal(got, kernels.fused_score_reference(wt, bt, xt))


@pytest.mark.parametrize(
    "bad, match",
    [
        (dict(x=np.zeros((4, D), np.float64)), "float32 x"),
        (dict(w=np.zeros(D + 1, np.float32)), "features"),
        (dict(x=np.zeros(D, np.float32)), r"x \(n, d\)"),
        (dict(b=np.zeros(2, np.float32)), "intercept"),
    ],
)
def test_wrapper_rejects_bad_inputs(bad, match):
    x, w, b = _inputs(4)
    args = dict(x=x, w=w, b=np.asarray(b))
    args.update(bad)
    with pytest.raises((TypeError, ValueError), match=match):
        kernels.fused_score(
            torch.from_numpy(args["w"]), torch.from_numpy(args["b"]),
            torch.from_numpy(args["x"]),
        )


def test_kernel_sources_and_build_tags():
    """Every csrc/*.cu is a kernel; the library name changes with the
    source, so an edited kernel never loads a stale build."""
    assert kernels.kernel_names() == ["fused_score", "knn_topk"]
    path = kernels._lib_path("fused_score")
    assert path.parent == kernels.BUILD_DIR
    assert path.name.startswith("libfused_score-") and path.suffix == ".so"
    src = (kernels.CSRC_DIR / "fused_score.cu").read_text()
    assert "sm_90a" in " ".join(kernels.NVCC_FLAGS)
    assert "__expf" not in src.replace("not __expf", "")
    assert "_score_kernel" in src  # names the TPU kernel it replaces

