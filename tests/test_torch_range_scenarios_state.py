"""The range's forest and ledger scenarios (``gbt_explain_under_burst``,
``poison_entity_state``) through both packages' ``run_scenario`` at their
default seeds and sizes, on the CPU, held to ``tests/range_parity.py``'s
contract: every invariant ok in both under the same names (both fusion
gauges at 1, every row carrying k finite reason codes; the poison clamped,
every other slot bitwise the clean run's), the deterministic metrics
equal (the wire, ``poison_fired``, ``mule_slot``), ``mule_count`` within
1e-5 relative. The forest's latency invariant, a closed-loop host-clock
probe that failed under a loaded run, is held by the ``slow`` test in
``tests/test_torch_range_scenarios_fold.py``."""

import pytest
import torch

from tests.range_parity import LATENCY_SLOW, compare

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["gbt_explain_under_burst", "poison_entity_state"])
def test_scenario_matches_jax(name, tmp_path):
    jd, td = compare(name, tmp_path, latency=name not in LATENCY_SLOW)
    if name == "gbt_explain_under_burst":
        assert td["metrics"]["wire"] == "int8"
        assert td["metrics"]["explain_fused_gauge"] == td["metrics"]["wire_fused_gauge"] == 1.0


def test_every_ported_scenario_is_registered():
    """The registry holds the reference's eighteen scenarios, in its
    order; the seven that need a scratch directory are the reference's."""
    from fraud_detection_tpu.range import scenarios as jsc
    from fraud_detection_tpu_torch.range import scenarios as tsc

    assert list(tsc.SCENARIOS) == list(jsc.SCENARIOS)
    assert len(tsc.SCENARIOS) == 18
    assert tuple(tsc.NEEDS_TMPDIR) == tuple(jsc.NEEDS_TMPDIR)
