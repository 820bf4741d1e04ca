"""The port's program contracts (``analysis/contracts.py``, its second half)
on the CPU: every program holds its kernel calls a unit, its host-sync
freedom, its output dtypes and its state in place at 1, 2 and 8 shards
(the 2-D programs on the 1×1, 2×2 and 2×4 grids); the table covers the
JAX package's 34 contract entry points and says why wherever its counts
or dtypes differ from JAX's; each of the six diagnostics is caught by
name on an injected fault; and the kernel wrappers count their calls on
the CPU, where they launch nothing.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import shutil
import textwrap

import numpy as np
import pytest
import torch

from fraud_detection_tpu.analysis.contracts import iter_contracts
from fraud_detection_tpu_torch.analysis import contracts as C
from fraud_detection_tpu_torch.analysis import hostsync
from fraud_detection_tpu_torch.analysis.contracts import PROGRAMS, Program, Run, check_programs
from fraud_detection_tpu_torch.analysis.hostsync import check_bodies
from fraud_detection_tpu_torch.ops import kernels

torch.set_num_threads(1)

BY_NAME = {p.entrypoint: p for p in PROGRAMS}
PORT = os.path.dirname(os.path.dirname(os.path.abspath(C.__file__)))
WINDOW_LEAVES, TABLE_LEAVES = 6, 5


def _own(keys: list[str]) -> list[str]:
    """The keys of the programs checked: JAX's other entry points are
    uncovered in a check of a few programs."""
    return [k for k in keys if not k.endswith(":uncovered-entrypoint")]


@pytest.mark.parametrize("name", sorted(BY_NAME))
def test_every_program_holds_its_contract(name):
    p = BY_NAME[name]
    runs: list = []
    assert _own(check_programs("cpu", contracts=(p,), report=runs)) == []
    assert [r["shards"] for r in runs] == (list(C.GRIDS) if p.grid else
                                           [(n, 1) for n in C.SHARD_COUNTS])
    for r in runs:  # the counts a unit equal the declaration, on the CPU too
        mesh_size = r["shards"][0] * r["shards"][1]
        for kernel, want in p.kernels.items():
            per_shard = mesh_size if kernel in p.per_shard else 1
            assert r["dispatches"][kernel] == want * per_shard * r["units"], (kernel, r)
        assert r["launches"] is None  # nothing launches on the CPU


def _jax_primary(con, program) -> tuple[str, ...] | None:
    """JAX's pinned dtypes without the trailing leaves the port folds in
    place: the window's six, and before them the table's five where JAX
    donates the table too."""
    if con.out_dtypes is None:
        return None
    out = tuple(con.out_dtypes)
    if program.in_place:
        out = out[:-TABLE_LEAVES] if len(con.donate) == 2 else out
        out = out[:-WINDOW_LEAVES]
    return out


def test_the_table_covers_jaxs_34_and_explains_every_difference():
    jax = {c.entrypoint: c for c in iter_contracts()}
    assert len(jax) == 34 and set(C.jax_entrypoints()) == set(jax)
    assert set(jax) <= set(BY_NAME)
    for name, con in jax.items():
        p = BY_NAME[name]
        kernel_calls = sum(v for k, v in p.kernels.items() if k != "gbt_hist_accumulate"
                           and k != "gbt_hist_max" and k != "gbt_hist_finish")
        if kernel_calls != con.pallas_calls:
            assert "JAX declares no pallas_call" in p.note, name
        if _jax_primary(con, p) != (None if p.out_dtypes is None else tuple(p.out_dtypes)):
            assert "JAX pins" in p.note or "JAX declares uint32" in p.note, name
        if p.in_place:
            assert "in place" in p.note, name
    for p in PROGRAMS:  # every per-shard count says so
        if p.per_shard:
            assert "once a shard" in p.note, p.entrypoint
    # the four kernels are each some program's
    assert {"fused_score", "tree_shap", "knn_topk", "gbt_hist"} <= {
        k for p in PROGRAMS for k in p.kernels}


def _fastlane(**kw) -> Program:
    return dataclasses.replace(BY_NAME["fastlane.flush"], **kw)


def _check(program: Program, **kw) -> list[str]:
    return _own(check_programs("cpu", shard_counts=(1,), contracts=(program,), **kw))


def test_an_extra_kernel_call_is_a_kernel_count():
    build = BY_NAME["fastlane.flush"].build

    def extra(mesh):
        run, units = build(mesh)
        x = torch.ones(4, C.FEATURES)

        def twice():
            out = run()
            kernels.fused_score(torch.ones(C.FEATURES), torch.tensor(0.0), x)
            return out

        return Run(twice, state=run.state, pool=run.pool), units

    assert _check(_fastlane(build=extra)) == ["fastlane.flush:kernel-count"]


def test_a_declared_kernel_on_its_plain_body_is_a_missing_kernel():
    """A depth-6 forest: ``_raw_tree_shap`` takes the plain body (the path a
    forest deeper than the kernel's cap takes on the card) and the
    ``tree_shap`` the contract declares is never called."""
    from fraud_detection_tpu_torch.ops.gbt import GBTConfig, gbt_fit
    from fraud_detection_tpu_torch.ops.tree_shap import build_tree_explainer, tree_shap

    def deep(mesh):
        x, y = C._rows()
        model = gbt_fit(x, y, GBTConfig(n_trees=2, max_depth=6, n_bins=16), device=mesh.device)
        e = build_tree_explainer(model, x[:32], seed=0)
        xt = torch.from_numpy(x).to(mesh.device)
        return Run(lambda: tree_shap(e, xt)), 1

    p = dataclasses.replace(BY_NAME["tree_shap.batch"], build=deep)
    assert _check(p) == ["tree_shap.batch:missing-kernel"]


def test_a_host_sync_in_a_flush_body_is_caught(tmp_path, monkeypatch):
    """The static rule over a flush body fixture with an ``.item()``: by
    name through the program check, and the finding itself; its good twin
    is silent."""
    # a body the contract names that is gone is a host-sync finding too
    assert _check(_fastlane(bodies=("monitor/drift.py:_no_such_flush",))) == [
        "fastlane.flush:host-sync"]
    body = """
        import torch

        def _fused_flush(window, x, valid, decay):
            rows = valid.sum().item()
            window.mul_(decay).add_(x.sum(dim=0))
            return x.sum(dim=1), rows
    """
    good = body.replace("rows = valid.sum().item()", "rows = valid.sum()")
    (tmp_path / "monitor").mkdir()
    (tmp_path / "monitor" / "bad.py").write_text(textwrap.dedent(body))
    (tmp_path / "monitor" / "good.py").write_text(textwrap.dedent(good))
    monkeypatch.setattr(hostsync, "_package_dir", lambda: str(tmp_path))
    found = check_bodies(["monitor/bad.py:_fused_flush"])
    assert [(f.rule_id, f.line, f.message) for f in found] == [
        ("host-sync", 5, ".item() in _fused_flush: a host sync")]
    assert check_bodies(["monitor/good.py:_fused_flush"]) == []
    assert _check(_fastlane(bodies=("monitor/bad.py:_fused_flush",))) == [
        "fastlane.flush:host-sync"]
    assert _check(_fastlane(bodies=("monitor/good.py:_fused_flush",))) == []


@pytest.mark.parametrize("line,sync", [
    ("torch.as_tensor(table, device=x.device)", True),
    ("torch.tensor([1, 2], dtype=torch.int64, device=x.device)", True),
    ("host.to(device=x.device)", True),
    ("host.to(device=x.device, non_blocking=True)", False),
    ("torch.as_tensor(table)", False),
    ("torch.zeros(4, device=x.device)", False),
])
def test_a_host_to_device_copy_is_a_host_sync(line, sync):
    fn = ast.parse(f"def flush(x, host, table):\n    return {line}\n").body[0]
    assert bool(hostsync.sync_calls(fn)) == sync


def test_a_host_to_device_copy_in_a_forest_flush_is_caught(tmp_path, monkeypatch):
    """The forest prediction's leaf-path tables copied from numpy each
    level of every call (a pageable host-to-device copy, which waits for
    the device) in a copy of the package: ``evergreen.flush`` shows
    ``host-sync``, by name and at both copies; the tree as it is is
    silent."""
    pkg = tmp_path / "fraud_detection_tpu_torch"
    shutil.copytree(PORT, pkg, ignore=shutil.ignore_patterns("build", "__pycache__"))
    monkeypatch.setattr(hostsync, "_package_dir", lambda: str(pkg))
    p = BY_NAME["evergreen.flush"]
    assert check_bodies(p.bodies) == []
    gbt = pkg / "ops" / "gbt.py"
    src = gbt.read_text()
    cached = ("    nodes, bits = _leaf_path_tensors(model.depth, binned.device)\n",
              "        sel = go_right[:, :, nodes[k]] == bits[k][None, None, :]\n")
    per_call = ("    nodes, bits = _leaf_paths(model.depth)\n    dev = binned.device\n",
                "        sel = go_right[:, :, torch.as_tensor(nodes[k], device=dev).long()] == \\\n"
                "            torch.as_tensor(bits[k], device=dev)[None, None, :]\n")
    for new, old in zip(cached, per_call):
        assert src.count(new) == 1
        src = src.replace(new, old)
    gbt.write_text(src)
    found = check_bodies(p.bodies)
    assert [(f.path, f.message) for f in found] == [
        ("fraud_detection_tpu_torch/ops/gbt.py",
         "torch.as_tensor(device=...), a host-to-device copy, in _leaf_contrib: a host sync")] * 2
    assert _check(p) == ["evergreen.flush:host-sync"]


def _fastlane_parts(mesh):
    from fraud_detection_tpu_torch.monitor.drift import DriftMonitor

    scorer, profile = C._linear(mesh.device, "float32")
    mon = DriftMonitor(profile, device=mesh.device)
    return scorer, mon, list(C._rows()[0][:C.FLUSH_ROWS])


def test_a_rebound_window_leaf_is_a_dropped_donation():
    from fraud_detection_tpu_torch.monitor.drift import DriftWindow

    def rebinding(mesh):
        scorer, mon, rows = _fastlane_parts(mesh)

        def run():
            out = C._flush(mon, scorer, rows)
            mon.window = DriftWindow(*(t.clone() for t in mon.window.tensors()))
            return out

        return Run(run, state=lambda: C._monitor_state(mon), pool=scorer.staging), 1

    assert _check(_fastlane(build=rebinding)) == ["fastlane.flush:dropped-donation"]


def test_a_staging_slot_never_released_is_a_dropped_donation():
    def leaking(mesh):
        scorer, mon, rows = _fastlane_parts(mesh)

        def run():
            out = C._flush(mon, scorer, rows)
            scorer.staging.acquire(64)  # never released
            return out

        return Run(run, state=lambda: C._monitor_state(mon), pool=scorer.staging), 1

    runs: list = []
    assert _check(_fastlane(build=leaking), report=runs) == ["fastlane.flush:dropped-donation"]
    assert runs[0]["violations"] == [
        "dropped-donation: the staging pool allocated 8 slots over 8 flushes"]


def test_a_wrong_return_dtype_is_an_out_dtype():
    p = _fastlane(build=C._narrow_flush("float32", 0, out_dtype=torch.float16, sharded=False))
    runs: list = []
    assert _check(p, report=runs) == ["fastlane.flush:out-dtype"]
    assert runs[0]["violations"] == [
        "out-dtype: pinned ('float32',), returned ('float16',)"]


def test_a_missing_entry_point_is_uncovered():
    rest = tuple(p for p in PROGRAMS if p.entrypoint == "fastlane.flush")
    found = check_programs("cpu", shard_counts=(1,), contracts=rest)
    assert "scorer.score:uncovered-entrypoint" in found
    assert len(found) == 33 and all(k.endswith(":uncovered-entrypoint") for k in found)
    assert "fastlane.flush:uncovered-entrypoint" not in found


def test_violation_keys_are_sorted_stable_strings():
    build = BY_NAME["fastlane.flush"].build

    def both(mesh):
        run, units = build(mesh)

        def run2():
            out = run()
            kernels.fused_score(torch.ones(C.FEATURES), torch.tensor(0.0),
                                torch.ones(2, C.FEATURES))
            return out.half()

        return Run(run2, state=run.state, pool=run.pool), units

    found = _check(_fastlane(build=both))
    assert found == ["fastlane.flush:kernel-count", "fastlane.flush:out-dtype"]


def test_dispatch_counts_count_on_the_cpu_and_reset():
    kernels.reset_dispatch_counts()
    kernels.reset_launch_counts()
    x = torch.ones(8, 4)
    kernels.fused_score(torch.ones(4), torch.tensor(0.0), x)
    kernels.fused_score(torch.ones(4), torch.tensor(0.0), x)
    rng = np.random.default_rng(0)
    xc = torch.from_numpy(rng.standard_normal((12, 4)).astype(np.float32))
    kernels.knn_topk(xc, (xc * xc).sum(dim=1), 3)
    n, d, nodes, bins = 16, 3, 2, 8
    args = (torch.from_numpy(rng.integers(0, bins, (n, d)).astype(np.uint8)),
            torch.from_numpy(rng.integers(0, nodes, n).astype(np.int32)),
            torch.from_numpy(rng.standard_normal(n).astype(np.float32)),
            torch.from_numpy(rng.random(n).astype(np.float32)))
    kernels.gbt_hist(*args, nodes, bins)
    max_bits = kernels.gbt_hist_max(*args[1:], nodes)
    acc = torch.zeros((d, nodes, bins, 2), dtype=torch.int64)
    quanta = torch.empty(2, dtype=torch.float64)
    kernels.gbt_hist_accumulate(*args, nodes, bins, max_bits, n, acc, quanta)
    kernels.gbt_hist_finish(acc, quanta)
    got = kernels.dispatch_counts()
    assert got == {"fused_score": 2, "knn_topk": 1, "gbt_hist": 2, "tree_shap": 0,
                   "gbt_hist_max": 1, "gbt_hist_accumulate": 1, "gbt_hist_finish": 1}
    assert set(kernels.launches_by_entry()) == set(kernels.DISPATCH_KEYS)
    assert all(v == 0 for v in kernels.launches_by_entry().values())
    kernels.reset_dispatch_counts()
    assert set(kernels.dispatch_counts().values()) == {0}


def test_the_cpu_treeshap_body_counts_as_the_kernels_dispatch_only_within_its_cap():
    from fraud_detection_tpu_torch.ops.gbt import GBTConfig, gbt_fit
    from fraud_detection_tpu_torch.ops.tree_shap import build_tree_explainer, tree_shap

    x, y = C._rows()
    xt = torch.from_numpy(x)
    for depth, want in ((3, 1), (6, 0)):
        model = gbt_fit(x, y, GBTConfig(n_trees=2, max_depth=depth, n_bins=16), device="cpu")
        e = build_tree_explainer(model, x[:32], seed=0)
        kernels.reset_dispatch_counts()
        phi = tree_shap(e, xt)
        assert phi.shape == xt.shape
        assert kernels.dispatch_counts()["tree_shap"] == want
