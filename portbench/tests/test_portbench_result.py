"""The result line: exactly the contract's keys, the metrics of the run's
kind, and no line at all without a card or without the program."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

from portbench import run

ROOT = Path(__file__).resolve().parents[2]
KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


def _run(small, cell, trace, seconds=1.0):
    return run.run_cell(cell, 2**31 + 5, seconds, trace, device="cpu", pkg=small,
                        root=small.parent, t_start=time.perf_counter(),
                        log=lambda *_: None)


@pytest.mark.parametrize("cell", ["xgb.lane1024", "lr.lane1024", "xgb.fit_kaggle"])
def test_an_untraced_run_reports_the_cells_end_to_end_metrics(small, cell):
    r = _run(small, cell, False)
    assert set(r) == KEYS and list(r)[-1] == "checks"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    want = {"setup_s", "fit_s" if cell.endswith("fit_kaggle") else "rows_per_s"}
    assert set(r["metrics"]) == want
    assert all(m["value"] > 0 for m in r["metrics"].values())
    assert set(r["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(set(c) == {"value", "limit"} for c in r["checks"].values())


def test_a_traced_run_reports_per_layer_metrics_and_a_breakdown(small):
    r = _run(small, "lr.lane1024", True, seconds=1.5)
    assert set(r) == KEYS | {"breakdown"} and list(r)[-1] == "checks"
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    # the host's counters and the client's span; no device on the CPU, so no
    # roofline, idle share or mfu
    assert {"lane_parse_ms.serve", "rows_per_flush.serve", "flush_wait_ms.serve",
            "device_compute_ms.serve"} <= set(r["metrics"])
    assert not {"fused_score_roofline", "device_idle.serve", "mfu.serve"} & set(r["metrics"])
    assert {"busy_s", "window_s"} <= set(r["device"])


def test_without_a_card_the_run_fails_and_prints_nothing():
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", "xgb.fit_kaggle",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""
    assert "CUDA" in p.stderr


def test_without_the_program_the_run_fails_and_prints_nothing(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    code = ("import sys, time; sys.path.insert(0, '.'); from portbench import run; "
            "run.run_cell('xgb.fit_kaggle', 1, 1.0, False, device='cpu')")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                       text=True, timeout=120, env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert p.returncode != 0 and p.stdout == ""
    assert "No module named 'fraud_detection_tpu_torch'" in p.stderr
    assert "During handling" not in p.stderr  # the teardown hides nothing


def test_the_printed_line_is_json_with_checks_last(small):
    r = _run(small, "lr.lane1024", False)
    line = json.dumps(r)
    assert list(json.loads(line)) == list(r)
