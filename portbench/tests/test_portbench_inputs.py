"""The seeded inputs repeat exactly, differ between seeds, and keep the
sizes the configurations state."""

from __future__ import annotations

import numpy as np
import pytest

from portbench import inputs, registry

CFG = registry.config("xgb_kaggle_100x5")


def test_rows_repeat_for_a_seed_and_differ_between_seeds():
    a, ya = inputs.rows(CFG, 2**31 + 17, 5000)
    b, yb = inputs.rows(CFG, 2**31 + 17, 5000)
    c, _ = inputs.rows(CFG, 2**31 + 18, 5000)
    assert a.tobytes() == b.tobytes() and ya.tobytes() == yb.tobytes()
    assert a.tobytes() != c.tobytes()
    assert int(ya.sum()) == round(5000 * CFG["data"]["fraud_rate"]) or int(ya.sum()) == 2
    assert a.shape == (5000, 30) and a.dtype == np.float32


def test_negative_and_huge_seeds_are_whole_numbers_too():
    for seed in (-1, 0, 2**40 + 3, -(2**33)):
        x, _ = inputs.rows(CFG, seed, 100)
        assert np.isfinite(x).all()


def test_the_copy_is_the_ports_generator():
    from fraud_detection_tpu_torch.data.synthetic import generate_synthetic_rows

    x, y = inputs.generate_synthetic_rows(3000, 0.01, 1234)
    xp, yp = generate_synthetic_rows(3000, 0.01, 1234)
    assert x.tobytes() == xp.tobytes() and y.tobytes() == yp.tobytes()


@pytest.mark.parametrize("name", ["xgb_kaggle_100x5", "lr_kaggle_d30"])
def test_weights_repeat_for_a_seed(name):
    cfg = registry.config(name)
    a, b = inputs.make_weights(cfg, 99), inputs.make_weights(cfg, 99)
    c = inputs.make_weights(cfg, 100)
    for k in a:
        assert np.asarray(a[k]).tobytes() == np.asarray(b[k]).tobytes()
    assert any(np.asarray(a[k]).tobytes() != np.asarray(c[k]).tobytes() for k in a)


def test_the_fit_input_has_the_recipe_sizes():
    d = inputs.fit_inputs(CFG, 7)
    assert d["x_fit"].shape == (454_904, 30) and d["y_fit"].sum() == 227_452
    assert d["x_test"].shape == (56_961, 30) and d["y_test"].sum() == 98
    again = inputs.fit_inputs(CFG, 7)
    assert d["x_fit"].tobytes() == again["x_fit"].tobytes()


def test_the_check_sample_repeats():
    assert inputs.check_sample(5, 256, 4).tolist() == inputs.check_sample(5, 256, 4).tolist()
    assert len(set(inputs.check_sample(5, 256, 64).tolist())) == 64
