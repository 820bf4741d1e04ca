"""The range's hot-swap and shard-front scenarios (``hot_swap``,
``shard_kill_mid_swap``, ``replica_burst``, ``explain_under_burst``)
through both packages' ``run_scenario`` at their default seeds and sizes,
on the CPU, held to ``tests/range_parity.py``'s contract: every invariant
ok in both under the same names (p99 through the swap, the kill and the
drain among them), and the deterministic metrics equal — rows scored and
explained, the victim's state and its injected failures, the drained
shard's state, ``post_swap_compiles`` 0 (vacuous on the CPU: no kernel
library loads here). ``explain_under_burst``'s latency invariant, a
closed-loop host-clock probe that failed under a loaded run, is held by the
``slow`` test in ``tests/test_torch_range_scenarios_fold.py``."""

import pytest
import torch

from tests.range_parity import LATENCY_SLOW, compare

torch.set_num_threads(1)


@pytest.mark.parametrize(
    "name", ["hot_swap", "shard_kill_mid_swap", "replica_burst", "explain_under_burst"])
def test_scenario_matches_jax(name, tmp_path):
    jd, td = compare(name, tmp_path, latency=name not in LATENCY_SLOW)
    if "post_swap_compiles" in td["metrics"]:
        assert td["metrics"]["post_swap_compiles"] == 0
        assert td["metrics"]["post_swap_device_allocs"] is None  # no card here
