"""The range's campaign and control-plane scenarios (``burst``,
``drift_onset``, ``fraud_ring``, ``label_delay``, ``control_plane_chaos``)
through both packages' ``run_scenario`` at their default seeds and sizes,
on the CPU, held to ``tests/range_parity.py``'s contract: every invariant
ok in both under the same names, the deterministic metrics equal, the
drift detection within one sampling interval, the ring and background
mean scores within 1e-3. The latency invariants that failed under a loaded
run (``burst``'s, ``explain_under_burst``'s, ``gbt_explain_under_burst``'s:
``tests/range_parity.LATENCY_SLOW``) are held in a ``slow`` test here."""

import pytest
import torch

from tests.range_parity import LATENCY_SLOW, compare

torch.set_num_threads(1)


@pytest.mark.parametrize(
    "name", ["burst", "drift_onset", "fraud_ring", "label_delay", "control_plane_chaos"])
def test_scenario_matches_jax(name, tmp_path):
    compare(name, tmp_path, latency=name not in LATENCY_SLOW)


@pytest.mark.slow
@pytest.mark.parametrize("name", LATENCY_SLOW)
def test_scenario_latency_invariant_holds(name):
    """The port's every invariant, ``p99-holds`` included, with nothing
    else in the process (the JAX package's chaos tier, ``-m slow`` in
    ``tests/test_range.py``, holds the reference's)."""
    from fraud_detection_tpu_torch.range.scenarios import run_scenario

    run_scenario(name, device="cpu").raise_if_failed()
