"""The range's two longhaul epoch-fence scenarios
(``host_partition_mid_promotion``, ``split_brain_scrape``) through both
packages' ``run_scenario`` at their default seeds, on the CPU, each in its
own scratch directory, held to ``tests/range_parity.py``'s contract: every
invariant ok in both under the same names in the same order (the
stale-epoch finalizes fenced and counted, the fresh one lands; the
split-brain contribution dropped and counted, the merged window the live
host's alone, both re-admitted after the rejoin), and the membership
epochs and the merged window's rows equal."""

import pytest
import torch

from tests.range_parity import compare

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["host_partition_mid_promotion", "split_brain_scrape"])
def test_fence_scenario_matches_jax(name, tmp_path):
    jd, td = compare(name, tmp_path)
    m = td["metrics"]
    if name == "host_partition_mid_promotion":
        assert m["epoch_before"] < m["epoch_dead"] < m["epoch_fresh"]
    else:
        assert m["epoch_baseline"] < m["epoch_split"] < m["epoch_healed"]
        assert m["window_rows_baseline"] > 0
