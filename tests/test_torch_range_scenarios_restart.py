"""The range's lifeboat scenarios (``crash_warm_restart``,
``kill_mid_snapshot``) through both packages' ``run_scenario`` at their
default seeds and sizes, on the CPU, each in its own scratch directory,
held to ``tests/range_parity.py``'s contract: every invariant ok in both
under the same names (the warm restart bitwise the journal's replay and a
clean drive, the app's 503 gate, the generation fallback, the torn tail
counted), and the deterministic metrics equal — the snapshot and
generation sequence numbers, the generations skipped, the rows replayed
and torn, no kernel library loaded after the recovery (vacuous on the
CPU)."""

import pytest
import torch

from tests.range_parity import compare

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["crash_warm_restart", "kill_mid_snapshot"])
def test_scenario_matches_jax(name, tmp_path):
    jd, td = compare(name, tmp_path)
    m = td["metrics"]
    if name == "crash_warm_restart":
        assert m["post_recovery_compiles"] == 0
        assert m["post_recovery_device_allocs"] is None  # no card here
        # the restarted app served on the scenario's device
        assert m["app_device"] == "cpu"
    else:
        assert m["torn_tail_rows"] > 0
        assert m["replayed_rows_full"] == m["replayed_rows_torn_tail"] + m["torn_tail_rows"]


def test_the_scenarios_leave_the_environment_as_they_found_it(tmp_path, monkeypatch):
    """``crash_warm_restart`` sets ``MODEL_PATH``, ``LIFEBOAT_DIR`` and
    ``MLFLOW_TRACKING_URI`` for its app and restores them after."""
    import os

    from fraud_detection_tpu_torch.range import run_scenario

    monkeypatch.setenv("MODEL_PATH", "/nonexistent/model.npz")
    monkeypatch.delenv("LIFEBOAT_DIR", raising=False)
    monkeypatch.delenv("MLFLOW_TRACKING_URI", raising=False)
    run_scenario("crash_warm_restart", tmpdir=str(tmp_path), device="cpu").raise_if_failed()
    assert os.environ["MODEL_PATH"] == "/nonexistent/model.npz"
    assert "LIFEBOAT_DIR" not in os.environ and "MLFLOW_TRACKING_URI" not in os.environ
