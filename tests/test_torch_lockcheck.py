"""The port's lock discipline (``analysis/{core,locknames,lockcheck}.py``)
against the JAX package's lock checker, on the CPU.

The inventory is JAX's fourteen locks with the modules mapped to the port;
the port's report over its own tree is ``ok`` with JAX's four edges; both
checkers read JAX's lock fixtures alike; the port's own fixtures (source
strings written to ``tmp_path``: no fixture directory under ``tests/``)
hold the device waits, the captured bodies and the inventory drift; the
``build/`` copy of the repo is never scanned; the eleven sanctions sit at
JAX's sites; the four locks the port created plainly are witnessed; and a
CPU lifeboat snapshot over served ledger flushes witnesses only edges of
the static graph.
"""

from __future__ import annotations

import ast
import os
import shutil
import textwrap
from types import SimpleNamespace

import pytest
import torch

from fraud_detection_tpu.analysis import lockcheck as jax_lockcheck
from fraud_detection_tpu.analysis import locknames as jax_locknames
from fraud_detection_tpu.analysis.core import analyze_file as jax_analyze_file
from fraud_detection_tpu_torch.analysis import lockcheck, locknames
from fraud_detection_tpu_torch.analysis.core import analyze_file, analyze_paths, device_wait
from fraud_detection_tpu_torch.analysis.hostsync import sync_calls
from fraud_detection_tpu_torch.analysis.locknames import LockDecl
from fraud_detection_tpu_torch.utils import lockdep

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "fraud_detection_tpu_torch")
FIXTURES = os.path.join(ROOT, "tests", "analysis_fixtures")
FOUR_EDGES = {("lifeboat.flush", "drift.window"), ("lifeboat.flush", "lifeboat.journal"),
              ("longhaul.inherit", "lifeboat.flush"), ("netstore.pub", "taskq.broker")}


def _edges(report) -> set:
    return {(e["src"], e["dst"]) for e in report["edges"]}


def _write(tmp_path, name: str, source: str) -> str:
    path = tmp_path / name
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(source))
    return str(path)


def test_inventory_is_jaxs_with_the_modules_mapped_to_the_port():
    assert len(locknames.LOCKS) == len(jax_locknames.LOCKS) == 14
    for mine, theirs in zip(locknames.LOCKS, jax_locknames.LOCKS):
        assert (mine.name, mine.kind, mine.cls, mine.attr, mine.purpose) == (
            theirs.name, theirs.kind, theirs.cls, theirs.attr, theirs.purpose)
        assert mine.module == theirs.module.replace(
            "fraud_detection_tpu/", "fraud_detection_tpu_torch/", 1)
        assert os.path.isfile(os.path.join(ROOT, mine.module)), mine.module
    assert set(locknames.by_name()) == set(jax_locknames.by_name())
    assert {k: [d.name for d in v] for k, v in locknames.by_attr().items()} == {
        k: [d.name for d in v] for k, v in jax_locknames.by_attr().items()}


def test_the_ports_tree_has_jaxs_edges_and_no_cycle_or_drift():
    """The port's report over the port's tree (its git-ignored ``build/``
    on disk included) against JAX's report over JAX's tree."""
    mine = lockcheck.build_lock_report()
    theirs = jax_lockcheck.build_lock_report(root=ROOT)
    assert mine["ok"] and not mine["cycles"] and not mine["inventory_drift"]
    assert _edges(mine) == _edges(theirs) == FOUR_EDGES
    assert lockcheck.violation_keys(mine) == []
    assert [lock["name"] for lock in mine["locks"]] == [d.name for d in locknames.LOCKS]


@pytest.mark.parametrize("fixture", ["bad_lock_order.py", "good_lock_order.py"])
def test_both_checkers_read_jaxs_order_fixtures_alike(fixture):
    path = os.path.join(FIXTURES, fixture)
    mine = lockcheck.build_lock_report(root=ROOT, package_dir=path)
    theirs = jax_lockcheck.build_lock_report(root=ROOT, package_dir=path)
    assert mine["edges"] == theirs["edges"]
    assert mine["cycles"] == theirs["cycles"]
    assert lockcheck.violation_keys(mine) == jax_lockcheck.violation_keys(theirs)
    if fixture.startswith("bad"):
        assert mine["cycles"] == ["lifeboat.flush -> lifeboat.journal -> lifeboat.flush"]
        assert not mine["ok"]
    else:
        assert mine["ok"] and _edges(mine) == {("lifeboat.flush", "lifeboat.journal")}


@pytest.mark.parametrize("fixture,count", [("bad_blocking_lock.py", 4),
                                           ("good_blocking_lock.py", 0)])
def test_both_blocking_rules_read_jaxs_fixtures_alike(tmp_path, fixture, count):
    """JAX's fixture through JAX's rule, and the same source through the
    port's rule with JAX's sanction written in the port's marker."""
    src = os.path.join(FIXTURES, fixture)
    theirs = jax_analyze_file(src, root=ROOT, rules=[jax_lockcheck.check_blocking_under_lock.rule])
    with open(src) as f:
        source = f.read().replace("graftcheck: ignore", "lockcheck: ignore")
    copy = _write(tmp_path, fixture, source)
    mine = analyze_file(copy, root=str(tmp_path), rules=[lockcheck.check_blocking_under_lock.rule])
    assert len(mine) == len(theirs) == count
    assert [(f.line, f.message) for f in mine] == [(f.line, f.message) for f in theirs]


_DEVICE_WAITS = """
    import torch

    class DriftMonitor:
        def __init__(self):
            self._lock = object()
            self.window = torch.zeros(4)

        def stats(self):
            with self._lock:
                torch.cuda.synchronize()
                n = self.window.sum().item()
                host = self.window.cpu()
                rows = self.window.tolist()
                array = self.window.numpy()
            return n, host, rows, array
"""
_DEVICE_WAITS_GOOD = """
    import torch

    class DriftMonitor:
        def __init__(self):
            self._lock = object()
            self.window = torch.zeros(4)

        def stats(self):
            with self._lock:
                copy = self.window.clone()
            return copy.sum().item(), copy.cpu(non_blocking=False)
"""
_CAPTURE = """
    import threading

    import torch

    class DriftMonitor:
        def __init__(self):
            self._lock = object()

        def record(self, g, x):
            with torch.cuda.graph(g):
                with self._lock:
                    x.mul_(2.0)

    @torch.compile
    def body(x):
        guard = threading.Lock()
        return x * 2
"""
_CAPTURE_GOOD = """
    import threading

    import torch

    class DriftMonitor:
        def __init__(self):
            self._lock = object()

        def record(self, g, x):
            with self._lock:
                with torch.cuda.graph(g):
                    x.mul_(2.0)

    guard = threading.Lock()

    @torch.compile
    def body(x):
        return x * 2
"""


def test_device_waits_under_a_named_lock_fire_and_the_good_twin_is_silent(tmp_path):
    bad = analyze_file(_write(tmp_path, "bad.py", _DEVICE_WAITS), root=str(tmp_path),
                       rules=list(lockcheck.LOCK_RULES))
    assert [f.message for f in bad] == [
        "torch.cuda.synchronize() while holding 'drift.window'",
        ".item() while holding 'drift.window'",
        "self.window.cpu() while holding 'drift.window'",
        "self.window.tolist() while holding 'drift.window'",
        "self.window.numpy() while holding 'drift.window'",
    ]
    assert {f.rule_id for f in bad} == {"blocking-under-lock"}
    good = analyze_file(_write(tmp_path, "good.py", _DEVICE_WAITS_GOOD), root=str(tmp_path),
                        rules=list(lockcheck.LOCK_RULES))
    assert good == []


def test_the_lock_rule_and_the_host_sync_rule_share_the_device_waits():
    """Every device wait of the fixtures blocks under a lock and is a host
    sync in a flush, and the calls that wait for nothing are neither."""
    calls = [node for src in (_DEVICE_WAITS, _DEVICE_WAITS_GOOD)
             for node in ast.walk(ast.parse(textwrap.dedent(src))) if isinstance(node, ast.Call)]
    waits = {ast.unparse(c.func) for c in calls if device_wait(c) is not None}
    assert waits == {"torch.cuda.synchronize", "self.window.sum().item", "self.window.cpu",
                     "self.window.tolist", "self.window.numpy", "copy.sum().item"}
    for call in calls:
        fn = ast.parse("def f():\n    pass").body[0]
        fn.body = [ast.Expr(call)]
        assert (lockcheck.blocking_call(call) is not None) == (device_wait(call) is not None)
        assert bool(sync_calls(fn)) == (device_wait(call) is not None), ast.unparse(call)


def test_a_lock_in_a_captured_body_fires_and_the_good_twin_is_silent(tmp_path):
    bad = analyze_file(_write(tmp_path, "bad.py", _CAPTURE), root=str(tmp_path),
                       rules=[lockcheck.check_lock_in_capture.rule])
    assert [(f.rule_id, f.message) for f in sorted(bad, key=lambda f: f.line)] == [
        ("lock-in-capture", "named lock 'drift.window' taken inside a captured body "
         "(recorded once, skipped by every replay)"),
        ("lock-in-capture", "threading.Lock() created inside a captured body"),
    ]
    good = analyze_file(_write(tmp_path, "good.py", _CAPTURE_GOOD), root=str(tmp_path),
                        rules=[lockcheck.check_lock_in_capture.rule])
    assert good == []


def test_a_sanction_needs_the_ports_marker_and_names_its_rule(tmp_path):
    sanctioned = _DEVICE_WAITS.replace(
        "                torch.cuda.synchronize()\n",
        "                # the flush's fence, reviewed\n"
        "                # lockcheck: ignore[blocking-under-lock]\n"
        "                torch.cuda.synchronize()\n")
    other = sanctioned.replace("ignore[blocking-under-lock]", "ignore[lock-in-capture]")
    rules = [lockcheck.check_blocking_under_lock.rule]
    assert len(analyze_file(_write(tmp_path, "a.py", sanctioned), str(tmp_path), rules)) == 4
    assert len(analyze_file(_write(tmp_path, "b.py", other), str(tmp_path), rules)) == 5


def test_a_findings_fingerprint_ignores_its_line_number(tmp_path):
    """The baseline identity: rule, file and the normalised source line."""
    one = analyze_file(_write(tmp_path, "m.py", _DEVICE_WAITS), str(tmp_path),
                       [lockcheck.check_blocking_under_lock.rule])
    moved = analyze_file(_write(tmp_path, "m.py", "\n\n" + textwrap.dedent(_DEVICE_WAITS)),
                         str(tmp_path), [lockcheck.check_blocking_under_lock.rule])
    assert [f.line + 2 for f in one] == [f.line for f in moved]
    assert [f.fingerprint for f in one] == [f.fingerprint for f in moved]
    assert len({f.fingerprint for f in one}) == 5
    assert one[0].to_dict()["fingerprint"] == one[0].fingerprint


def test_inventory_drift_shows_both_ways(tmp_path, monkeypatch):
    """An undeclared creation site and a declared lock whose site is gone,
    in a fixture root against a fixture inventory."""
    _write(tmp_path, "fraud_detection_tpu_torch/made.py", """
        from utils import lockdep

        class Made:
            def __init__(self):
                self._made_lock = lockdep.lock("made.up")
                self._kept_lock = lockdep.lock("kept.lock")
    """)
    monkeypatch.setattr(locknames, "LOCKS", (
        LockDecl("kept.lock", "fraud_detection_tpu_torch/made.py", "Made", "_kept_lock"),
        LockDecl("gone.lock", "fraud_detection_tpu_torch/gone.py", "Gone", "_gone_lock")))
    report = lockcheck.build_lock_report(root=str(tmp_path))
    assert not report["ok"]
    assert lockcheck.violation_keys(report) == [
        "undeclared-lock:fraud_detection_tpu_torch/made.py:6",
        "lock-inventory-drift:'gone.lock'"]
    # an overridden tree checks no drift, as JAX's
    assert lockcheck.build_lock_report(
        root=str(tmp_path), package_dir=str(tmp_path / "fraud_detection_tpu_torch"))["ok"]


def test_build_directories_are_not_scanned(tmp_path):
    """``bad_lock_order.py`` under a package's ``build/`` (as the proof
    runs' repo copy sits under the port's) adds no edge; the same file
    elsewhere in the package gives its cycle."""
    pkg = tmp_path / "pkg"
    (pkg / "build" / "proof").mkdir(parents=True)
    shutil.copy(os.path.join(FIXTURES, "good_lock_order.py"), pkg / "boat.py")
    shutil.copy(os.path.join(FIXTURES, "bad_lock_order.py"), pkg / "build" / "proof" / "bad.py")
    report = lockcheck.build_lock_report(root=str(tmp_path), package_dir=str(pkg))
    assert report["ok"] and report["cycles"] == []
    shutil.copy(os.path.join(FIXTURES, "bad_lock_order.py"), pkg / "bad.py")
    report = lockcheck.build_lock_report(root=str(tmp_path), package_dir=str(pkg))
    assert report["cycles"] == ["lifeboat.flush -> lifeboat.journal -> lifeboat.flush"]


def _sanctioned_sites(package: str, marker: str, files) -> list[tuple[str, str]]:
    """(file under the package, enclosing function) of each sanction of
    ``blocking-under-lock`` with ``marker`` in ``files``."""
    sites = []
    for rel in files:
        path = os.path.join(ROOT, package, rel)
        with open(path) as f:
            source = f.read()
        lines = source.splitlines()
        funcs = [n for n in ast.walk(ast.parse(source))
                 if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        for i, line in enumerate(lines, 1):
            if f"{marker}: ignore[blocking-under-lock]" not in line:
                continue
            code = i if not line.lstrip().startswith("#") else i + 1
            owner = min((n for n in funcs if n.lineno <= code <= n.end_lineno),
                        key=lambda n: n.end_lineno - n.lineno)
            sites.append((rel, owner.name))
    return sorted(sites)


def test_the_eleven_sanctions_sit_at_jaxs_sites_and_nothing_is_unsanctioned():
    files = ("lifeboat/journal.py", "service/netserver.py", "longhaul/membership.py")
    mine = _sanctioned_sites("fraud_detection_tpu_torch", "lockcheck", files)
    theirs = _sanctioned_sites("fraud_detection_tpu", "graftcheck", files)
    assert len(mine) == 11 and mine == theirs
    assert analyze_paths([PORT], root=ROOT, rules=list(lockcheck.LOCK_RULES)) == []
    # JAX's rule, blind to the port's marker, finds exactly these sites
    raw = [f for rel in files for f in jax_analyze_file(
        os.path.join(PORT, rel), root=ROOT, rules=[jax_lockcheck.check_blocking_under_lock.rule])]
    assert len(raw) == 11


def test_the_four_repaired_locks_are_witnessed(monkeypatch, tmp_path):
    import numpy as np

    from fraud_detection_tpu_torch.monitor.baseline import build_baseline_profile
    from fraud_detection_tpu_torch.mesh.shardflush import MeshDriftMonitor
    from fraud_detection_tpu_torch.monitor.drift import DriftMonitor
    from fraud_detection_tpu_torch.ops.scorer import StagingPool
    from fraud_detection_tpu_torch.parallel.mesh import MeshSpec, create_mesh
    from fraud_detection_tpu_torch.service.binlane import BinaryIngestServer
    from fraud_detection_tpu_torch.service.taskq import SqliteBroker

    monkeypatch.setenv("LOCKDEP", "1")
    rng = np.random.default_rng(0)
    profile = build_baseline_profile(rng.standard_normal((64, 4)).astype(np.float32),
                                     rng.random(64).astype(np.float32), device="cpu")
    broker = SqliteBroker(f"sqlite:///{tmp_path / 'q.db'}")
    mesh = create_mesh(MeshSpec(data=2), devices=["cpu"] * 2)
    held = {
        "drift.window": DriftMonitor(profile, device="cpu")._lock,
        "staging.pool": StagingPool(4)._lock,
        "taskq.broker": broker._lock,
        "binlane.server": BinaryIngestServer(SimpleNamespace(max_batch=64), None,
                                             host="127.0.0.1", port=0)._lock,
    }
    try:
        for name, lk in held.items():
            assert isinstance(lk, lockdep.LockdepLock) and lk.name == name
        assert MeshDriftMonitor(profile, mesh)._lock.name == "drift.window"
    finally:
        broker.close()
    monkeypatch.setenv("LOCKDEP", "0")
    assert not isinstance(StagingPool(4)._lock, lockdep.LockdepLock)


def test_a_lifeboat_snapshot_witnesses_only_static_edges(monkeypatch, tmp_path):
    """``kill_mid_snapshot`` on the CPU under ``LOCKDEP=1``: served ledger
    flushes through the lifeboat, two snapshots. The witness sees
    ``lifeboat.flush → drift.window`` and ``→ lifeboat.journal``, raises no
    inversion, and every edge it saw is in the static graph."""
    from fraud_detection_tpu_torch.range.scenarios import run_scenario

    monkeypatch.setenv("LOCKDEP", "1")
    lockdep.reset()
    try:
        res = run_scenario("kill_mid_snapshot", device="cpu", tmpdir=str(tmp_path)).to_dict()
        witnessed = set(lockdep.edges())
    finally:
        lockdep.reset()
    assert all(v["ok"] for v in res["invariants"].values()), res["invariants"]
    assert {("lifeboat.flush", "drift.window"), ("lifeboat.flush", "lifeboat.journal")} <= witnessed
    assert witnessed <= _edges(lockcheck.build_lock_report())
