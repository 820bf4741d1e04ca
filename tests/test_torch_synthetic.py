"""The port's synthetic Kaggle-schema generator against the JAX package's:
the same rows and the same file bytes for the same seed."""

import numpy as np
import pytest
import torch

from fraud_detection_tpu.data import synthetic as jax_synthetic
from fraud_detection_tpu_torch.data import synthetic
from fraud_detection_tpu_torch.data.loader import load_creditcard_csv

torch.set_num_threads(1)


@pytest.mark.parametrize("seed", [0, 7, 42])
def test_rows_equal_jax(seed):
    for ratio in (0.01, 0.05):
        x, y = synthetic.generate_synthetic_rows(2000, ratio, seed)
        jx, jy = jax_synthetic.generate_synthetic_rows(2000, ratio, seed)
        assert x.dtype == jx.dtype == np.float32 and y.dtype == jy.dtype == np.int32
        assert x.tobytes() == jx.tobytes() and y.tobytes() == jy.tobytes()
    assert synthetic.fraud_shift(0.5).tobytes() == jax_synthetic.fraud_shift(0.5).tobytes()


@pytest.mark.parametrize("seed", [0, 7, 42])
def test_file_bytes_equal_jax(seed, tmp_path):
    """Three chunks (the last one short), a 0.5 σ shift."""
    kw = dict(n_samples=2500, fraud_ratio=0.03, seed=seed, chunk_rows=1000, shift_scale=0.5)
    a = synthetic.generate_synthetic_data(str(tmp_path / "p" / "a.csv"), **kw)
    b = jax_synthetic.generate_synthetic_data(str(tmp_path / "j" / "b.csv"), **kw)
    assert open(a, "rb").read() == open(b, "rb").read()
    x, y, names = load_creditcard_csv(a)
    assert x.shape == (2500, 30) and names[0] == "Time" and names[-1] == "Amount"
    assert np.all(np.diff(x[:, 0]) >= 0)  # Time sorted across chunks


def test_sample_count_from_the_environment(tmp_path, monkeypatch):
    """``CI_SYNTHETIC_SAMPLES`` wins over ``TEST_SYNTHETIC_SAMPLES``; 500
    without either, as in the JAX package."""
    for ci, test, want in ((None, None, 500), (None, "30", 30), ("20", "30", 20)):
        for name, v in (("CI_SYNTHETIC_SAMPLES", ci), ("TEST_SYNTHETIC_SAMPLES", test)):
            if v is None:
                monkeypatch.delenv(name, raising=False)
            else:
                monkeypatch.setenv(name, v)
        p = synthetic.generate_synthetic_data(str(tmp_path / f"{want}.csv"))
        j = jax_synthetic.generate_synthetic_data(str(tmp_path / f"j{want}.csv"))
        assert open(p, "rb").read() == open(j, "rb").read()
        assert len(open(p).readlines()) == want + 1
