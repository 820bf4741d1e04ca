"""The range's longhaul failover scenario (``ledger_owner_failover_mid_traffic``)
through both packages' ``run_scenario`` at its default seed and sizes, on
the CPU, in its own scratch directory, held to ``tests/range_parity.py``'s
contract: every invariant ok in both under the same names in the same order
(routed scores before the kill and after the failover bitwise a single
host's, the dead segment's 503 + Retry-After, the survivor's table bitwise
the single host's), and the deterministic metrics equal — the batches, the
rows the survivor replayed, the 503 probes, no kernel library loaded across
the inheritance (vacuous on the CPU). The two epoch-fence scenarios are in
``test_torch_range_scenarios_longhaul_fence.py``."""

import torch

from tests.range_parity import compare

torch.set_num_threads(1)


def test_failover_scenario_matches_jax(tmp_path):
    jd, td = compare("ledger_owner_failover_mid_traffic", tmp_path)
    m = td["metrics"]
    assert m["replayed_rows"] > 0 and m["compiles_delta"] == 0
    assert m["inherit_device_allocs"] is None  # no card here
