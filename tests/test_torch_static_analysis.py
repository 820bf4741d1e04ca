"""The port's tree under its own static rules, baseline and CLI
(``analysis/{baseline,report,__main__}.py``), against the JAX package's
on the CPU.

The port's tree is clean under ``python -m fraud_detection_tpu_torch.analysis``
with its empty baseline; JAX's rules, which cannot read the port's
``# lockcheck:`` marker, find exactly the fifteen sites the port sanctions
(the silent handlers and listener sockets at JAX's own sites, two
port-only ones), and nothing the port repaired; every hot-path function
of JAX's has its marked counterpart; the baseline holds JAX's three
properties; and the CLI's flags, ``--contracts`` on the CPU among them.
"""

from __future__ import annotations

import ast
import json
import os
import re
import time

import torch

from fraud_detection_tpu.analysis import core as jax_core
from fraud_detection_tpu.analysis import rules_perf as jax_rules_perf
from fraud_detection_tpu_torch.analysis import baseline as baseline_mod
from fraud_detection_tpu_torch.analysis.__main__ import main
from fraud_detection_tpu_torch.analysis.core import (
    SUPPRESS_RE,
    ModuleInfo,
    analyze_file,
    analyze_paths,
    iter_python_files,
    iter_rules,
)
from fraud_detection_tpu_torch.analysis.rules_perf import marked_functions

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "fraud_detection_tpu_torch")
JAX = os.path.join(ROOT, "fraud_detection_tpu")

#: (file, enclosing function, rule) of each port site JAX's rules find: the
#: thirteen sanctioned where JAX sanctions its own, then the two port-only
JAX_SITES = [
    ("analysis/meshcheck.py", "verify_entrypoint", "silent-except"),
    ("longhaul/fleet.py", "__init__", "socket-no-timeout"),
    ("longhaul/host.py", "__init__", "socket-no-timeout"),
    ("longhaul/membership.py", "__init__", "socket-no-timeout"),
    ("range/scenarios.py", "client_worker", "silent-except"),
    ("service/legacy.py", "predict", "silent-except"),
    ("service/netserver.py", "start", "socket-no-timeout"),
    ("service/sentinel.py", "start", "socket-no-timeout"),
    ("service/tracing.py", "_remote_parent_context", "silent-except"),
    ("service/tracing.py", "format_traceparent", "silent-except"),
    ("service/worker.py", "_run_one", "silent-except"),
    ("service/worker.py", "compute_shap_many", "silent-except"),
    ("service/worker.py", "compute_shap_many", "silent-except"),
    ("service/worker.py", "compute_shap_many", "silent-except"),
]
PORT_ONLY = [
    ("store_failover_rate.py", "free_port", "socket-no-timeout"),
    ("store_failover_rate.py", "wait_until", "retry-no-backoff"),
]

#: JAX's twenty ``# graftcheck: hot-path`` functions → the port's function
#: that does each one's work, (file, qualified name)
HOT_PATHS = {
    ("ops/scorer.py", "decode_scores_into"): ("ops/scorer.py", "decode_scores_into"),
    ("ops/scorer.py", "decode_explain_into"): ("ops/scorer.py", "decode_explain_into"),
    ("ops/scorer.py", "_BucketedScorer._encode_slot"): (
        "ops/scorer.py", "_BucketedScorer._encode_slot"),
    # the port stages single rows through stage_items, which takes both
    ("ops/scorer.py", "_BucketedScorer.stage_rows"): (
        "ops/scorer.py", "_BucketedScorer.stage_items"),
    ("ops/scorer.py", "_BucketedScorer.stage_items"): (
        "ops/scorer.py", "_BucketedScorer.stage_items"),
    ("ops/scorer.py", "_BucketedScorer.stage_items_placed"): (
        "ops/scorer.py", "_BucketedScorer.stage_items_placed"),
    ("ops/scorer.py", "_BucketedScorer.stage_rows_placed"): (
        "ops/scorer.py", "_BucketedScorer.stage_rows_placed"),
    ("service/binlane.py", "_FrameDecoder.features_into"): (
        "service/binlane.py", "_FrameDecoder.features_into"),
    ("service/binlane.py", "BinaryIngestServer._frame"): (
        "service/binlane.py", "BinaryIngestServer._frame"),
    ("service/binlane.py", "BinaryIngestServer._respond"): (
        "service/binlane.py", "BinaryIngestServer._respond"),
    ("service/microbatch.py", "MicroBatcher._flush_device"): (
        "service/microbatch.py", "MicroBatcher._flush_device"),
    ("service/microbatch.py", "MicroBatcher._stage_wide"): (
        "service/microbatch.py", "MicroBatcher._stage_wide"),
    ("service/microbatch.py", "MicroBatcher._stage_ledger"): (
        "service/microbatch.py", "MicroBatcher._stage_ledger"),
    ("monitor/drift.py", "DriftMonitor.fused_flush"): ("monitor/drift.py", "DriftMonitor.fused_flush"),
    # JAX's monitor methods wrap a jitted body; the port's bodies are the flushes
    ("monitor/drift.py", "DriftMonitor._ledger_flush"): ("monitor/drift.py", "_fused_flush_ledger"),
    ("monitor/drift.py", "DriftMonitor._wide_flush"): ("monitor/drift.py", "_fused_flush_wide"),
    ("mesh/shardflush.py", "MeshDriftMonitor.fused_flush"): ("mesh/shardflush.py", "_sharded_flush"),
    ("mesh/shardflush.py", "MeshDriftMonitor._ledger_flush"): (
        "mesh/shardflush.py", "_sharded_flush_ledger"),
    ("mesh/shardflush.py", "MeshDriftMonitor._wide_flush"): (
        "mesh/shardflush.py", "_sharded_flush_wide"),
    ("service/worker.py", "XaiWorker.compute_shap_many"): (
        "service/worker.py", "XaiWorker.compute_shap_many"),
}

#: the rule ids the CLI lists: the twelve static rules and the two lock rules
PORT_RULES = {
    "socket-no-timeout", "silent-except", "thread-nondaemon-nojoin", "prom-foreign-registry",
    "retry-no-backoff", "artifact-nonatomic-write", "alert-metric-registered", "hot-path-alloc",
    "hot-path-json", "capture-host-sync", "capture-scalar-closure", "capture-tensor-global",
    "blocking-under-lock", "lock-in-capture",
}


def _owner(tree: ast.AST, line: int) -> str:
    funcs = [n for n in ast.walk(tree) if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    return min((n for n in funcs if n.lineno <= line <= n.end_lineno),
               key=lambda n: n.end_lineno - n.lineno).name


def _qualnames(tree: ast.AST) -> dict:
    out = {}

    def visit(body, prefix):
        for n in body:
            if isinstance(n, ast.ClassDef):
                visit(n.body, prefix + n.name + ".")
            elif isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out[n] = prefix + n.name
    visit(tree.body, "")
    return out


def test_the_ports_tree_is_clean_under_its_cli_with_an_empty_baseline(capsys):
    with open(baseline_mod.DEFAULT_BASELINE) as f:
        doc = json.load(f)
    assert (doc["findings"], doc["contracts"], doc["lockcheck"]) == ([], [], [])
    assert main([]) == 0
    assert capsys.readouterr().out.strip() == "analysis: 0 finding(s), 0 baselined"


def test_jaxs_rules_find_exactly_the_fifteen_sanctioned_sites():
    """JAX's lint over the port's tree (its ``build/`` left out), blind to
    the port's marker: the sanctioned sites and nothing else — not the
    rank file's write or the ``fraud_store_*`` series, both repaired — and
    the port's rules find none of them."""
    rules = [r for r in jax_core.iter_rules() if r.id != "blocking-under-lock"]
    found = jax_core.analyze_paths([PORT], root=PORT, rules=rules,
                                   excludes=(os.path.join(PORT, "build") + os.sep,))
    trees = {}
    sites = []
    for f in found:
        if f.path not in trees:
            with open(os.path.join(PORT, f.path)) as fh:
                trees[f.path] = ast.parse(fh.read())
        sites.append((f.path, _owner(trees[f.path], f.line), f.rule_id))
    assert sorted(sites) == sorted(JAX_SITES + PORT_ONLY)
    mine = analyze_paths([PORT], root=PORT, rules=[r for r in iter_rules()
                                                   if r.id in {r.id for r in rules}])
    assert mine == []


def _sanctions(package: str, marker: str, rules, files) -> list[tuple[str, str, str]]:
    """(file, enclosing function, rule) of each ``<marker>: ignore[rule]``."""
    out = []
    for rel in files:
        with open(os.path.join(ROOT, package, rel)) as f:
            source = f.read()
        tree = ast.parse(source)
        for i, line in enumerate(source.splitlines(), 1):
            for rule in rules:
                if f"{marker}: ignore[{rule}]" in line:
                    code = i + 1 if line.lstrip().startswith("#") else i
                    out.append((rel, _owner(tree, code), rule))
    return sorted(out)


def test_the_sanctions_sit_at_jaxs_sites_and_each_port_only_one_has_a_reason():
    files = sorted({site[0] for site in JAX_SITES})
    rules = ("silent-except", "socket-no-timeout")
    mine = _sanctions("fraud_detection_tpu_torch", "lockcheck", rules, files)
    assert mine == _sanctions("fraud_detection_tpu", "graftcheck", rules, files)
    assert mine == sorted(JAX_SITES)
    assert _sanctions("fraud_detection_tpu_torch", "lockcheck", ("socket-no-timeout",
                      "retry-no-backoff"), ["store_failover_rate.py"]) == PORT_ONLY
    # every sanction of a static rule gives its reason, on its line or above
    static = PORT_RULES - {"blocking-under-lock", "lock-in-capture"}
    for path in iter_python_files([PORT]):
        with open(path) as f:
            lines = f.read().splitlines()
        for i, line in enumerate(lines):
            m = SUPPRESS_RE.search(line)
            if m is None or not m.group(1) or not set(m.group(1).split(",")) & static:
                continue
            said = line[m.end():].strip(" —-#")
            above = lines[i - 1].strip() if i else ""
            assert said or (above.startswith("#") and "lockcheck:" not in above), (path, i + 1)


def test_the_hot_path_markers_cover_jaxs_twenty_functions():
    theirs, mine = set(), set()
    for package, out, mark in ((JAX, theirs, jax_rules_perf._marked_functions),
                               (PORT, mine, marked_functions)):
        for rel in {k[0] for k in HOT_PATHS}:
            with open(os.path.join(package, rel)) as f:
                source = f.read()
            path = os.path.join(package, rel)
            mod = (jax_core.ModuleInfo(path, rel, source) if package == JAX
                   else ModuleInfo(path, rel, source))
            names = _qualnames(mod.tree)
            out.update((rel, names[fn]) for fn in mark(mod))
    assert len(theirs) == 20 and theirs == set(HOT_PATHS)
    assert mine == set(HOT_PATHS.values())
    # and each marked body is clean under both perf rules (the two flush
    # concatenations sanctioned with their reason)
    rules = [r for r in iter_rules() if r.id.startswith("hot-path")]
    for rel in {v[0] for v in HOT_PATHS.values()}:
        assert analyze_file(os.path.join(PORT, rel), root=ROOT, rules=rules) == []


# -- the baseline (JAX's three properties) ----------------------------------------------

SOCKET = "import socket\ns = socket.create_connection(('h', 1))\n"


def test_the_baseline_round_trips_and_reports_stale_entries(tmp_path):
    p = tmp_path / "m.py"
    p.write_text(SOCKET + "try:\n    pass\nexcept Exception:\n    pass\n")
    findings = analyze_file(str(p), root=str(tmp_path))
    assert len(findings) == 2
    path = str(tmp_path / "baseline.json")
    baseline_mod.save(path, findings)
    entries = baseline_mod.load(path)
    result = baseline_mod.apply(findings, entries)
    assert result.new == [] and len(result.suppressed) == 2 and result.stale == []
    # a repaired finding leaves its entry stale, never failing
    result = baseline_mod.apply(findings[1:], entries)
    assert result.new == [] and [e["rule"] for e in result.stale] == [findings[0].rule_id]
    assert baseline_mod.load_section(path, "contracts") == []
    assert baseline_mod.apply_keys(["a:x", "b:y"], ["a:x", "c:z"]) == (["b:y"], ["c:z"])


def test_a_baselined_fingerprint_survives_a_line_shift(tmp_path):
    p = tmp_path / "m.py"
    p.write_text(SOCKET)
    (before,) = analyze_file(str(p), root=str(tmp_path))
    p.write_text("# a new comment line above\n\n" + SOCKET)
    (after,) = analyze_file(str(p), root=str(tmp_path))
    assert before.line != after.line and before.fingerprint == after.fingerprint
    assert baseline_mod.apply([after], [before.to_dict()]).new == []


def test_the_baseline_does_not_cover_a_new_instance(tmp_path):
    p = tmp_path / "m.py"
    p.write_text(SOCKET)
    (one,) = analyze_file(str(p), root=str(tmp_path))
    p.write_text(SOCKET + "s = socket.create_connection(('h', 1))\n")
    two = analyze_file(str(p), root=str(tmp_path))
    result = baseline_mod.apply(two, [one.to_dict()])
    assert len(result.new) == 1 and len(result.suppressed) == 1


# -- the CLI ------------------------------------------------------------------------------


def test_list_rules_lists_the_fourteen(capsys):
    assert main(["--list-rules"]) == 0
    listed = {line.split()[0] for line in capsys.readouterr().out.splitlines()}
    assert listed == PORT_RULES


def test_an_unknown_rule_id_is_a_usage_error(capsys):
    assert main(["--rules", "silent-except,jit-missing-donate"]) == 2
    assert "jit-missing-donate" in capsys.readouterr().err


def test_write_baseline_accepts_the_findings_and_gates_them(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text(SOCKET)
    baseline = str(tmp_path / "baseline.json")
    assert main([str(bad), "--baseline", baseline]) == 1
    assert main([str(bad), "--baseline", baseline, "--write-baseline"]) == 0
    with open(baseline) as f:
        doc = json.load(f)
    assert [e["rule"] for e in doc["findings"]] == ["socket-no-timeout"]
    assert (doc["contracts"], doc["lockcheck"]) == ([], [])
    capsys.readouterr()
    out = str(tmp_path / "report.json")
    assert main([str(bad), "--baseline", baseline, "--format", "json", "--output", out]) == 0
    with open(out) as f:
        report = json.load(f)
    assert report["summary"] == {"new": 0, "baselined": 1, "stale": 0}
    # a warning under --fail-on error passes; --rules narrows the run
    assert main([str(bad), "--fail-on", "error"]) == 0
    assert main([str(bad), "--rules", "silent-except"]) == 0
    assert main([str(bad), "--contracts-only", "--write-baseline"]) == 2


def test_contracts_on_the_cpu(monkeypatch, tmp_path, capsys):
    """``--contracts`` with ``DEVICE=cpu``: the budgets, the programs at 1,
    2 and 8 shards and the grids, and the lock report — rc 0, no key."""
    monkeypatch.setenv("DEVICE", "cpu")
    out = str(tmp_path / "analysis.json")
    t = time.perf_counter()
    rc = main(["--contracts", "--format", "json", "--output", out])
    seconds = time.perf_counter() - t
    assert rc == 0, capsys.readouterr().out[-3000:]
    with open(out) as f:
        doc = json.load(f)
    summary = doc["summary"]
    assert summary["new"] == summary["stale"] == summary["contract_violations"] == 0
    assert summary["contract_new"] == summary["lock_new"] == summary["lock_stale"] == []
    assert doc["contracts"]["device"] == "cpu" and len(doc["contracts"]["runs"]) == 105
    assert doc["lockcheck"]["ok"] and len(doc["lockcheck"]["edges"]) == 4
    assert {r["id"] for r in doc["rules"]} == PORT_RULES
    dispatched = {k for r in doc["contracts"]["runs"] for k, v in r["dispatches"].items() if v}
    assert {"fused_score", "tree_shap", "knn_topk", "gbt_hist"} <= dispatched
    print(f"--contracts on the CPU: {seconds:.1f} s")


def test_contracts_on_a_missing_card_is_a_usage_error(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("DEVICE", raising=False)
    assert main(["--contracts-only"]) == 2
    assert re.search(r"DEVICE=cpu", capsys.readouterr().err)
