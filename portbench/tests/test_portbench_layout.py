"""The benchmark's layout: every cell, configuration, mix and metric is found
by name, ``BENCHMARK.json`` keeps to its contract, and a new cell,
configuration or per-layer metric needs new files only."""

from __future__ import annotations

import json
import re
import shutil
import time

import pytest

from portbench import registry, run
from portbench.tests.conftest import with_held_out

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
BENCH = registry.benchmark()
#: with the lane cells held out of BENCHMARK.json, whose harness stays tested
EVERY = with_held_out(BENCH)


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
        assert 1 <= len(c["why"]) <= 200 and "\n" not in c["why"]
        assert c["source"].startswith("https://")
        assert json.loads((registry.ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    names = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        names.add(w["name"])
    assert {c["name"] for c in BENCH["configs"]} == {w["config"] for w in BENCH["workloads"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:  # each lists the cells it is read in
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and m["source"] in SOURCES
        assert set(m.get("workloads", ())) <= names
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in {"lower", "higher"}
    every = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(every) == len(set(every))
    for cell in names:  # every cell reports set-up, another end-to-end and a per-layer metric
        reported = {m["name"] for m in registry.end_to_end(BENCH, cell)}
        assert "setup_s" in reported and len(reported) >= 2
        assert registry.per_layer(BENCH, cell)


@pytest.mark.parametrize("cell", [w["name"] for w in EVERY["workloads"]])
def test_every_cell_resolves_by_name(cell):
    entry = registry.cell_entry(EVERY, cell)
    w = registry.workload(cell)
    assert {k: w[k] for k in ("config", "traffic", "chips", "why")} == \
        {k: entry[k] for k in ("config", "traffic", "chips", "why")}
    cfg = registry.config(w["config"])
    assert cfg["family"] in {"gbt", "logistic"}
    mix = registry.mix(w["traffic"])
    assert hasattr(registry.traffic(mix["kind"]), "Session")
    assert set(w["check"]["limits"]), "a cell compares at least one number"


@pytest.mark.parametrize("metric", [m["name"] for m in EVERY["end_to_end"] + EVERY["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(registry.metric_reader(metric).read)


def test_a_new_cell_config_and_metric_need_only_new_files(tmp_path, small):
    """A configuration, a mix, a cell and a per-layer metric, each added as
    a file and an entry of BENCHMARK.json: a run of the new cell reports the
    new metric, and no file that was there changed."""
    root = tmp_path
    pkg = root / "portbench"
    shutil.copytree(small, pkg)
    before = {p: p.read_bytes() for p in pkg.rglob("*") if p.is_file()}
    cfg = json.loads((pkg / "configs" / "lr_kaggle_d30.json").read_text())
    cfg["model"]["intercept"] = -3.0
    (pkg / "configs" / "lr_kaggle_d30_b.json").write_text(json.dumps(cfg))
    (pkg / "traffic" / "mixes" / "lane16.json").write_text(json.dumps(
        {"kind": "lane", "connections": 2, "frame_rows": 16, "frames": 6, "warm_frames": 1,
         "trace_seconds": 0.5, "server_env": {"SCORER_MAX_BATCH": 64}}))
    why = "16-row frames from 2 connections"
    (pkg / "workloads" / "lrb.lane16.json").write_text(json.dumps(
        {"config": "lr_kaggle_d30_b", "traffic": "lane16", "chips": 1, "why": why,
         "check": {"sample_frames": 2, "limits": {"unanswered": 0, "score_gap": 1e-4,
                                                  "reason_rank_gap": 1e-3,
                                                  "reason_value_gap": 1e-3}}}))
    (pkg / "metrics" / "frames_sent.serve.py").write_text(
        "def read(run):\n    return run.window['counts']['sent']\n")
    bench = registry.benchmark(small.parent)
    bench["configs"].append({"name": "lr_kaggle_d30_b", "source": cfg["source"],
                             "file": "portbench/configs/lr_kaggle_d30_b.json", "reduced": [],
                             "why": "the logistic recipe with another intercept"})
    bench["workloads"].append({"name": "lrb.lane16", "config": "lr_kaggle_d30_b",
                               "traffic": "lane16", "chips": 1, "why": why})
    for m in bench["end_to_end"]:
        if m["name"] == "rows_per_s":
            m["workloads"].append("lrb.lane16")
    bench["per_layer"].append({"name": "frames_sent.serve", "unit": "frames", "better": "higher",
                               "source": "host_clock", "layer": "ingest lane, client side",
                               "moves": "rows_per_s", "workloads": ["lrb.lane16"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    result = run.run_cell("lrb.lane16", 5, 1.0, True, device="cpu", pkg=pkg, root=root,
                          t_start=time.perf_counter(), log=lambda *_: None)
    assert result["correct"], result
    assert result["metrics"]["frames_sent.serve"]["value"] > 0
    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_the_held_out_cells_keep_to_the_contract_and_resolve_by_name():
    """The lane cells held out of ``BENCHMARK.json`` are whole entries that
    a later change can move back as they stand."""
    bench = EVERY
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert set(m.get("workloads", ())) <= cells
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and m["source"] in SOURCES
        assert callable(registry.metric_reader(m["name"]).read)
    for w in bench["workloads"]:
        entry = registry.workload(w["name"])
        assert {k: entry[k] for k in ("config", "traffic", "chips", "why")} == \
            {k: w[k] for k in ("config", "traffic", "chips", "why")}
        assert w["config"] in {c["name"] for c in bench["configs"]}
        assert registry.per_layer(bench, w["name"])
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
