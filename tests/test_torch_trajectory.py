"""The port's bench trajectory (``analysis/trajectory.py``) against the JAX
package's: JAX's three trajectory tests held on the port, the same
headlines, regressions and ``compared_to`` order from both packages on the
same bench files, and the port's two departures — ``--trajectory`` is
required, and no default writes the committed ``BENCH_TRAJECTORY.json``.
"""

from __future__ import annotations

import json
import os
from types import SimpleNamespace

import pytest
import torch

from fraud_detection_tpu.analysis import trajectory as jax_trajectory
from fraud_detection_tpu_torch.analysis import trajectory

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bench_file(tmp_path, name, **keys):
    p = tmp_path / name
    p.write_text(json.dumps(keys))
    return str(p)


# -- JAX's three tests (tests/test_panopticon.py), on the port ----------------

def test_trajectory_gates_same_host_regressions(tmp_path):
    traj = str(tmp_path / "trajectory.json")
    b1 = _bench_file(
        tmp_path, "b1.json",
        microbatch_flush_speedup=1.5, telemetry_overhead_frac=0.03,
        online_binary_rows_per_sec=100000.0,
    )
    entry, reg = trajectory.append([b1], traj)
    assert reg == [] and entry["compared_to"] is None
    # within tolerance: clean
    b2 = _bench_file(
        tmp_path, "b2.json",
        microbatch_flush_speedup=1.4, telemetry_overhead_frac=0.035,
        online_binary_rows_per_sec=95000.0,
    )
    _, reg = trajectory.append([b2], traj)
    assert reg == []
    # >15% drop on a higher-is-better headline: gated
    b3 = _bench_file(
        tmp_path, "b3.json",
        microbatch_flush_speedup=1.0, telemetry_overhead_frac=0.03,
        online_binary_rows_per_sec=95000.0,
    )
    _, reg = trajectory.append([b3], traj)
    assert any("fused_speedup" in r for r in reg)
    entries = json.load(open(traj))
    assert len(entries) == 3
    assert entries[-1]["regressions"]


def test_trajectory_overhead_slack_and_host_mismatch(tmp_path, monkeypatch):
    traj = str(tmp_path / "t.json")
    b1 = _bench_file(tmp_path, "b1.json", telemetry_overhead_frac=0.001)
    trajectory.append([b1], traj)
    # 10x relative jump but within the absolute slack: NOT a regression
    b2 = _bench_file(tmp_path, "b2.json", telemetry_overhead_frac=0.01)
    _, reg = trajectory.append([b2], traj)
    assert reg == []
    # a different host never gates — it seeds its own baseline
    monkeypatch.setattr(trajectory, "host_fingerprint", lambda: "other-host")
    b3 = _bench_file(tmp_path, "b3.json", telemetry_overhead_frac=0.9)
    entry, reg = trajectory.append([b3], traj)
    assert reg == [] and entry["compared_to"] is None


def test_trajectory_cli_exit_codes(tmp_path):
    traj = str(tmp_path / "t.json")
    good = _bench_file(tmp_path, "g.json", microbatch_flush_speedup=1.5)
    assert trajectory.main([good, "--trajectory", traj]) == 0
    bad = _bench_file(tmp_path, "b.json", microbatch_flush_speedup=0.5)
    assert trajectory.main([bad, "--trajectory", traj]) == 1


# -- the port against JAX's module ----------------------------------------------

def test_the_headline_table_is_jaxs():
    assert trajectory.HEADLINES == jax_trajectory.HEADLINES


@pytest.mark.parametrize("tolerance", [0.15, 0.05])
def test_both_packages_append_alike_on_the_same_files(tmp_path, monkeypatch, tolerance):
    """Five bench files (two merged into one entry, a missing one skipped,
    a regression on either direction, then a change of host and back), one
    fingerprint and one clock patched into both packages: the same
    entries — headlines, regressions and ``compared_to`` order."""
    steps = [
        [dict(microbatch_flush_speedup=1.5, telemetry_overhead_frac=0.02),
         dict(online_binary_rows_per_sec=1e5, multihost_failover_s=0.4)],
        [dict(microbatch_flush_speedup=1.3, telemetry_overhead_frac=0.05,
              online_binary_rows_per_sec=9.1e4, multihost_failover_s=1.2)],
        [dict(microbatch_flush_speedup=1.6, explain_cost_ratio=0.7, unrelated=3)],
        [dict(gbt_explain_cost_ratio=0.4, recovery_replay_rows_per_sec=5e5)],
        [dict(gbt_explain_cost_ratio=0.3, recovery_snapshot_overhead_frac=0.2)],
    ]
    hosts = ["h1", "h1", "h1", "h2", "h1"]
    out = {}
    for tag, mod in (("jax", jax_trajectory), ("port", trajectory)):
        traj = str(tmp_path / f"{tag}.json")
        seen = []
        for i, (files, host) in enumerate(zip(steps, hosts)):
            monkeypatch.setattr(mod, "host_fingerprint", lambda host=host: host)
            # each entry its own second, so compared_to names one entry
            monkeypatch.setattr(mod, "time", SimpleNamespace(time=lambda i=i: 1000.0 + i))
            paths = [_bench_file(tmp_path, f"{tag}{i}_{j}.json", **keys)
                     for j, keys in enumerate(files)]
            paths.append(str(tmp_path / "missing.json"))
            entry, reg = mod.append(paths, traj, tolerance=tolerance, note=f"step {i}")
            assert entry["regressions"] == reg
            seen.append(entry)
        assert json.load(open(traj)) == seen
        out[tag] = seen
    assert out["port"] == out["jax"]
    assert [e["compared_to"] for e in out["port"]] == [None, 1000, 1001, None, 1002]
    assert any(e["regressions"] for e in out["port"])


def test_the_fingerprint_reads_device_where_jax_reads_jax_platforms(monkeypatch):
    monkeypatch.setenv("DEVICE", "cpu")
    assert trajectory.host_fingerprint().endswith(f"-cpu{os.cpu_count()}-cpu")
    monkeypatch.delenv("DEVICE")
    assert trajectory.host_fingerprint().endswith("-default")
    assert trajectory.host_fingerprint().split("-cpu")[0] == \
        jax_trajectory.host_fingerprint().split("-cpu")[0]


def test_the_trajectory_is_required_and_the_committed_file_untouched(tmp_path, monkeypatch,
                                                                     capsys):
    committed = os.path.join(ROOT, "BENCH_TRAJECTORY.json")
    with open(committed, "rb") as f:
        before = f.read()
    monkeypatch.chdir(ROOT)
    good = _bench_file(tmp_path, "g.json", microbatch_flush_speedup=1.5)
    with pytest.raises(SystemExit) as e:
        trajectory.main([good])
    assert e.value.code == 2
    assert "--trajectory" in capsys.readouterr().err
    traj = tmp_path / "t.json"
    assert trajectory.main([good, "--trajectory", str(traj)]) == 0
    with open(committed, "rb") as f:
        assert f.read() == before
    assert len(json.loads(traj.read_text())) == 1
