"""The range's socket and admission scenarios (``ingest_storm``,
``slo_burn_under_shed``) through both packages' ``run_scenario`` at their
default seeds and sizes, on the CPU, held to ``tests/range_parity.py``'s
contract: every invariant ok in both under the same names (the reference's
``sheds-bounded`` excepted, a race its own timing decides), and the
deterministic metrics equal — the frames offered, no hard error, the
bound, the drained shard's state; the sheds, the rows scored and the
budget before the burst. ``ingest_storm`` runs over real localhost
sockets in both packages: the binary lane's server and client."""

import pytest
import torch

from tests.range_parity import LATENCY_SLOW, compare

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["ingest_storm", "slo_burn_under_shed"])
def test_scenario_matches_jax(name, tmp_path):
    jd, td = compare(name, tmp_path, latency=name not in LATENCY_SLOW)
    m = td["metrics"]
    if name == "ingest_storm":
        # every frame went over a socket: accepted, or shed with a busy frame
        assert m["frames_accepted"] + m["frames_shed"] == m["frames_offered"] == 48
        assert 0 < m["peak_queued_rows"] <= m["admit_max_rows"]
        assert m["flushes_replayed"] > 0
    else:
        assert m["sheds"] > 0 and m["scored"] == 80
        assert m["budget_after_burst"] < m["budget_before"] == 1.0


def test_the_slowed_scorer_flushes_through_its_own_predict_proba():
    """``slo_burn_under_shed``'s scorer has no staging protocol: the
    batcher scores it through its ``predict_proba`` over the stacked rows
    (the legacy flush), with no staging slot and no reason codes."""
    import asyncio

    import numpy as np

    from fraud_detection_tpu_torch.service.microbatch import MicroBatcher

    calls = []

    class Legacy:
        min_bucket = 8

        def warmup(self, top):
            pass

        def predict_proba(self, rows):
            calls.append(rows.shape)
            return rows[:, 0] * 0.5

    async def run():
        mb = MicroBatcher(scorer=Legacy(), max_batch=8, max_wait_ms=5.0,
                          telemetry=False, explain=True, explain_k=3)
        await mb.start()
        try:
            rows = np.arange(12, dtype=np.float32).reshape(4, 3)
            return await asyncio.gather(*(mb.score(r) for r in rows))
        finally:
            await mb.stop()

    out = asyncio.run(run())
    assert out == [0.0, 1.5, 3.0, 4.5]
    assert sum(n for n, _ in calls) == 4 and all(d == 3 for _, d in calls)
