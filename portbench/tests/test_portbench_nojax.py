"""The check that no module of JAX or of the JAX package is loaded."""

from __future__ import annotations

import sys
import types

import pytest

from portbench import nojax, run


def test_whole_top_level_names_are_compared():
    mods = {"jax.numpy": None, "fraud_detection_tpu.ops": None,
            "fraud_detection_tpu_torch.ops": None, "jaxtyping": None, "flax.linen": None,
            "numpy": None}
    assert nojax.forbidden_modules(mods) == ["flax.linen", "fraud_detection_tpu.ops",
                                             "jax.numpy"]
    assert nojax.forbidden_modules({"fraud_detection_tpu_torch": None}) == []


def test_a_run_refuses_a_loaded_jax(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("jaxlib"))
    with pytest.raises(run.RunFailed) as e:
        run._check_nojax("after set-up")
    assert e.value.code != 0 and "jaxlib" in str(e.value)
