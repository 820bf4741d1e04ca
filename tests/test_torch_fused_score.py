"""The port's ``fused_score`` on bfloat16 rows against the JAX package's
Pallas ``fused_score`` on the same rows (interpret mode on the CPU, as
tests/test_pallas_kernels.py runs it): JAX upcasts any float rows to f32
inside its jit, and so does the port.

On the CPU the wrapper takes the plain PyTorch version; the CUDA kernel is
held against that plain version, against its earlier design and against
its own f32 path on the card (tests/test_torch_cuda.py, ``chip_smoke.py``
and ``python -m fraud_detection_tpu_torch.fused_score_turns``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fraud_detection_tpu.ops.pallas_kernels import fused_score as jax_fused_score
from fraud_detection_tpu_torch.ops import kernels

torch.set_num_threads(1)


def _bf16_inputs(n: int, d: int, seed: int = 11):
    """Rows that bf16 holds exactly (rounded once, by torch), so both
    packages see the same values; coef and intercept in f32."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).bfloat16()
    w = (rng.standard_normal(d) / np.sqrt(d)).astype(np.float32)
    return x, w, np.float32(-0.5)


@pytest.mark.parametrize("d", [30, 37])
@pytest.mark.parametrize("n", [1, 7, 1024, 1031])
def test_bf16_rows_match_jax(n, d):
    """Tolerance 1e-6 absolute: both sides score the same bf16 values in
    f32, summing x·w in different orders (≈1e-6 relative on z), and the
    sigmoid's slope is at most 1/4."""
    x, w, b = _bf16_inputs(n, d)
    x32 = x.float().numpy()
    assert np.array_equal(np.asarray(jnp.asarray(x32, jnp.bfloat16), np.float32), x32)
    got = kernels.fused_score(torch.from_numpy(w), torch.tensor(b), x)
    want = np.asarray(jax_fused_score(w, b, jnp.asarray(x32, jnp.bfloat16), interpret=True))
    assert got.dtype == torch.float32 and got.shape == (n,)
    assert want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("n, d", [(1, 30), (8, 30), (33, 37), (1031, 37)])
def test_cpu_wrapper_takes_bf16_rows_and_counts_no_launch(n, d):
    """bf16 rows give f32 (n,) scores: exactly the plain version on the same
    rows, which is the f32 plain version on ``x.float()``."""
    x, w, b = _bf16_inputs(n, d)
    wt, bt = torch.from_numpy(w), torch.tensor(b)
    kernels.reset_launch_counts()
    got = kernels.fused_score(wt, bt, x)
    assert kernels.FUSED_SCORE_LAUNCHES == 0
    assert got.dtype == torch.float32 and got.shape == (n,)
    assert torch.equal(got, kernels.fused_score_reference(wt, bt, x))
    assert torch.equal(got, kernels.fused_score(wt, bt, x.float()))


@pytest.mark.parametrize("dtype", [torch.float64, torch.int8, torch.float16])
def test_wrapper_refuses_rows_of_other_types(dtype):
    x = torch.zeros((4, 30), dtype=dtype)
    with pytest.raises(TypeError, match="a float32 x or a bfloat16 x"):
        kernels.fused_score(torch.zeros(30), torch.tensor(0.0), x)


def test_wrapper_still_wants_f32_coef_and_intercept():
    x = torch.zeros((4, 30), dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="float32 coef"):
        kernels.fused_score(torch.zeros(30, dtype=torch.bfloat16), torch.tensor(0.0), x)
    with pytest.raises(TypeError, match="float32 intercept"):
        kernels.fused_score(torch.zeros(30), torch.tensor(0.0, dtype=torch.float64), x)


def test_turns_script_refuses_without_a_card(monkeypatch, capsys):
    from fraud_detection_tpu_torch import fused_score_turns

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert fused_score_turns.main(["--earlier-source", "earlier.cu"]) == 2
    assert "needs a CUDA card" in capsys.readouterr().err


@pytest.mark.parametrize("n, elem, copies", [
    (8, 4, 1), (20_000, 4, 1), (20_000, 2, 1), (284_807, 4, 4), (284_807, 2, 1),
    (1_000_000, 2, 2),
])
def test_turns_rotate_past_the_l2_only_where_the_rows_fit_in_it(n, elem, copies):
    """One copy while two fit in the 50 MB L2; past that, enough copies
    that one rotation reads more than twice the L2 from device memory."""
    from fraud_detection_tpu_torch.fused_score_turns import D, L2_BYTES, rotated_copies

    got = rotated_copies(n, elem)
    assert got == copies
    if got > 1:
        assert got * n * D * elem >= 2 * L2_BYTES
