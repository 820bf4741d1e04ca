"""The port's shape pass (``analysis/meshcheck.py``) on the CPU against the
JAX package's meshcheck: every row ``ok`` at JAX's meshcheck shapes, the
(entry point, mesh size) pairs JAX registers and the conductor's pool,
each pinned summary JAX's shapes and dtypes (and each difference the one
the program's note gives), JAX's two negative controls, an exception as a
row, and the CLI's shape pass.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from fraud_detection_tpu.analysis import meshcheck as jax_meshcheck
from fraud_detection_tpu_torch.analysis import meshcheck
from fraud_detection_tpu_torch.analysis.__main__ import main
from fraud_detection_tpu_torch.analysis.contracts import PROGRAMS
from fraud_detection_tpu_torch.parallel.mesh import MeshSpec, create_mesh
from fraud_detection_tpu_torch.parallel.sharding import batch_sharding

torch.set_num_threads(1)

PORT_ONLY = "mesh.mapreduce_pool_stats"


def _label(size):
    return f"{size[0]}x{size[1]}" if isinstance(size, tuple) else size


@pytest.fixture(scope="module")
def rows():
    return meshcheck.verify_all(device="cpu")


@pytest.fixture(scope="module")
def jax_rows():
    return {(r["entrypoint"], r["mesh_size"]): r for r in jax_meshcheck.verify_all()}


def test_every_row_is_ok_at_jaxs_shapes(rows):
    bad = [r for r in rows if not r["ok"]]
    assert not bad, bad
    assert len(rows) == 107
    assert (meshcheck.SHAPE.rows, meshcheck.SHAPE.features) == (1024, 30)
    assert meshcheck.DEFAULT_MESH_SIZES == jax_meshcheck.DEFAULT_MESH_SIZES
    assert meshcheck.WIDE_MESH_SHAPES == jax_meshcheck.WIDE_MESH_SHAPES
    grid = {(r["entrypoint"], r["mesh_size"]) for r in rows if isinstance(r["mesh_size"], str)}
    assert grid == {(name, s) for name in ("mesh.broadside_flush", "mesh.wide_update")
                    for s in ("1x1", "2x2", "4x2", "2x4")}


def test_the_pairs_cover_jaxs_registry_and_the_pool(rows):
    """JAX's registry, read without running it: its 104 pairs, and the
    conductor's pool (no JAX entry point) at 1, 2 and 8."""
    theirs = {(ep.name, _label(s)) for ep in jax_meshcheck.iter_entrypoints()
              for s in ep.mesh_sizes}
    mine = {(r["entrypoint"], r["mesh_size"]) for r in rows}
    assert len(theirs) == 104
    assert mine - theirs == {(PORT_ONLY, s) for s in (1, 2, 8)}
    assert theirs <= mine


def _split(summary: str) -> list[str]:
    parts = summary.removesuffix("...").split(", (") if summary else []
    return [p if i == 0 else "(" + p for i, p in enumerate(parts)]


def test_each_summary_is_jaxs_or_its_note_says_why(rows, jax_rows):
    """Where the port's leaves lead JAX's (shapes and dtypes) the program
    holds JAX's layout; a port program that returns fewer leaves says in
    its note that the window folds in place or what JAX pins instead, and
    one whose leaves differ says what JAX pins."""
    notes = {p.entrypoint: p.note for p in PROGRAMS}
    matched = 0
    for r in rows:
        if r["entrypoint"] == PORT_ONLY:
            continue
        want = jax_rows[(r["entrypoint"], r["mesh_size"])]
        assert want["ok"], want
        mine, theirs = _split(r["out"]), _split(want["out"])
        note = notes[r["entrypoint"]]
        if mine == theirs[:len(mine)]:
            matched += 1
            if len(mine) < len(theirs):
                assert "not returned" in note or "JAX pins" in note, r["entrypoint"]
        else:
            assert "JAX pins" in note, (r["entrypoint"], r["out"], want["out"])
    assert matched >= 26 * 3  # all but the five fits and pools that JAX pins otherwise


def test_a_split_that_does_not_divide_fails_its_row():
    """JAX's negative control: 1003 rows over 8 data shards."""
    ep = meshcheck.Entrypoint(
        name="negative.indivisible",
        build=lambda mesh: (lambda: batch_sharding(mesh).segments(torch.zeros(1003, 30)) * 2.0,
                            1),
        mesh_sizes=(8,),
    )
    (res,) = meshcheck.verify_entrypoint(ep, device="cpu")
    assert not res["ok"] and "divisible" in res["error"]
    assert res["error"].startswith("ValueError: dimension 0 of shape (1003, 30)")
    assert "8 shards" in res["error"] and res["out"] is None


def test_an_unpadded_sgd_step_does_not_split():
    """JAX's second negative control, below the public fits (which pad on
    the host first, as JAX's do): a sharded SGD step's rows, 1004 at 8
    shards, handed to the layout unpadded raise; padded, they split."""
    from fraud_detection_tpu_torch.parallel.sharding import shard_batch

    mesh = create_mesh(MeshSpec(data=8), devices=["cpu"] * 8)
    layout = batch_sharding(mesh)
    for t in (torch.zeros(1004, 30), torch.zeros(1004)):
        with pytest.raises(ValueError, match="not divisible by 8 shards"):
            layout.segments(t)
    padded, n = shard_batch(torch.zeros(1004, 30), mesh)
    assert tuple(layout.segments(padded).shape) == (8, 126, 30) and n == 1004


def test_an_exception_in_a_build_is_one_failed_row(monkeypatch):
    def broken(mesh):
        raise RuntimeError("builder fault")

    eps = meshcheck.iter_entrypoints()
    fault = meshcheck.Entrypoint("negative.broken", broken)
    monkeypatch.setattr(meshcheck, "_ENTRYPOINTS",
                        {ep.name: ep for ep in eps[:3] + [fault] + eps[3:6]})
    out = meshcheck.verify_all(sizes=(2,), device="cpu")
    assert [r["entrypoint"] for r in out] == [ep.name for ep in eps[:3]] + [
        "negative.broken"] + [ep.name for ep in eps[3:6]]
    failed = [r for r in out if not r["ok"]]
    assert failed == [{"entrypoint": "negative.broken", "mesh_size": 2, "ok": False,
                       "error": "RuntimeError: builder fault", "out": None}]


def test_registering_twice_is_refused():
    with pytest.raises(ValueError, match="duplicate"):
        meshcheck.register_entrypoint("scorer.score")(lambda mesh: None)


def test_the_cli_runs_the_shape_pass_alone(monkeypatch, tmp_path, capsys):
    monkeypatch.setenv("DEVICE", "cpu")
    out = str(tmp_path / "shape.json")
    assert main(["--shape-check-only", "--mesh-sizes", "4", "--format", "json",
                 "--output", out]) == 0
    with open(out) as f:
        doc = json.load(f)
    assert doc["summary"]["mesh_failures"] == 0 and doc["findings"] == []
    assert "contracts" not in doc and "lockcheck" not in doc
    assert len(doc["mesh_verification"]) == len(PROGRAMS)
    assert {r["mesh_size"] for r in doc["mesh_verification"]} == {4}
    capsys.readouterr()
    assert main(["--shape-check-only", "--write-baseline"]) == 2
    assert "--write-baseline" in capsys.readouterr().err


def test_a_failed_row_fails_the_cli(monkeypatch, capsys):
    monkeypatch.setenv("DEVICE", "cpu")
    score = meshcheck.iter_entrypoints()[0]
    fault = meshcheck.Entrypoint(
        "negative.indivisible",
        lambda mesh: (lambda: batch_sharding(mesh).segments(torch.zeros(1003, 30)), 1), (8,))
    monkeypatch.setattr(meshcheck, "_ENTRYPOINTS", {fault.name: fault})
    assert main(["--shape-check-only"]) == 1
    text = capsys.readouterr().out
    assert "meshcheck: error [negative.indivisible] mesh size 8: ValueError: dimension 0" in text
    assert text.strip().endswith("mesh verification: 0/1 checks passed")
    ok = meshcheck.Entrypoint(score.name, score.build, (2,))
    monkeypatch.setattr(meshcheck, "_ENTRYPOINTS", {ok.name: ok})
    assert main(["--shape-check-only", "-v"]) == 0
    assert "meshcheck: ok [scorer.score] mesh size 2 ((1024,):float32)" in capsys.readouterr().out


def test_the_contracts_flags_carry_or_drop_the_shape_pass(monkeypatch, tmp_path):
    """``--contracts`` runs the shape pass beside the device passes;
    ``--no-shape-check`` drops it (the passes stubbed: their own tests run
    them)."""
    import fraud_detection_tpu_torch.analysis.contracts as contracts
    from fraud_detection_tpu_torch.analysis import lockcheck

    monkeypatch.setenv("DEVICE", "cpu")
    monkeypatch.setattr(contracts, "check_budgets", lambda device: [])
    monkeypatch.setattr(contracts, "check_programs", lambda device, report: [])
    monkeypatch.setattr(lockcheck, "build_lock_report", lambda root: {
        "ok": True, "locks": [], "edges": [], "cycles": [], "inventory_drift": []})
    calls = []
    monkeypatch.setattr(meshcheck, "verify_all",
                        lambda sizes, device: calls.append((sizes, str(device))) or [])
    for argv, want in ((["--contracts"], [(None, "cpu")]),
                       (["--contracts", "--mesh-sizes", "1,2"], [((1, 2), "cpu")]),
                       (["--contracts", "--no-shape-check"], []),
                       (["--contracts-only"], [])):
        calls.clear()
        out = str(tmp_path / "a.json")
        assert main(argv + ["--format", "json", "--output", out]) == 0
        assert calls == want, argv
        with open(out) as f:
            assert ("mesh_verification" in json.load(f)) == bool(want)


# -- the layout checks every split goes through ----------------------------------

def _mesh8():
    return create_mesh(MeshSpec(data=8), devices=["cpu"] * 8)


def _split_level():
    from fraud_detection_tpu_torch.ops.gbt import _split_hist

    n = 1003
    _split_hist(torch.zeros((n, 3), dtype=torch.uint8), torch.zeros(n, dtype=torch.int32),
                torch.zeros(n), torch.ones(n), 2, 4, mesh=_mesh8(), n_total=n)


def _serving_fold():
    from fraud_detection_tpu_torch.mesh.shardflush import init_sharded_window
    from fraud_detection_tpu_torch.monitor.drift import _fold_serving_batch

    n = 1003
    _fold_serving_batch(init_sharded_window(8, 3, 3, 4, device="cpu"), torch.zeros(n, 3),
                        torch.zeros(n), torch.ones(n), 1.0, torch.zeros(3, 2), torch.zeros(3))


def _ledger_update():
    from fraud_detection_tpu_torch.ledger.features import _ledger_read_update
    from fraud_detection_tpu_torch.ledger.state import LEDGER_K
    from fraud_detection_tpu_torch.mesh.shardflush import init_sharded_ledger

    n = 1003
    _ledger_read_update(init_sharded_ledger(8, None, 64, device="cpu"),
                        torch.zeros(n, dtype=torch.int64), torch.ones(n, dtype=torch.int64),
                        torch.ones(n), torch.ones(n), torch.ones(n), torch.zeros(LEDGER_K),
                        torch.tensor(60.0))


def _oracle_loop():
    from fraud_detection_tpu_torch.mesh.shardflush import _loop_flush, init_sharded_window
    from fraud_detection_tpu_torch.ops.scorer import _raw_score_linear

    n = 1003
    _loop_flush(init_sharded_window(8, 3, 3, 4, device="cpu"), torch.zeros(n, 3), torch.ones(n),
                1.0, torch.zeros(3, 2), torch.zeros(3), (torch.zeros(3), torch.tensor(0.0)),
                score_fn=_raw_score_linear)


@pytest.mark.parametrize("split", [_split_level, _serving_fold, _ledger_update, _oracle_loop],
                         ids=["gbt-split-phase", "serving-fold", "ledger-read-update",
                              "shard-loop-oracle"])
def test_a_split_outside_the_layouts_goes_through_their_check(split):
    """Each split of rows over shards that ran outside ``ShardLayout``
    (a remainder dropped, tail rows given a shard past the last, or
    torch's view error) raises the layouts' check: 1003 rows, 8 shards."""
    with pytest.raises(ValueError, match=r"dimension 0 of shape \(1003.*\) not divisible by 8 "
                                         r"shards: 1003 rows do not split over 8 shards"):
        split()


def test_the_wide_table_check_names_the_shape_and_the_count():
    """``_placed_wide_table``'s refusal says "not divisible" with the table
    and the model shards, and keeps its old words."""
    from fraud_detection_tpu_torch.mesh.shardflush import MeshDriftMonitor
    from fraud_detection_tpu_torch.monitor.baseline import build_baseline_profile
    from fraud_detection_tpu_torch.ops.crosses import CrossSpec

    x = np.random.default_rng(0).standard_normal((64, 6)).astype(np.float32)
    mon = MeshDriftMonitor(build_baseline_profile(x, np.full(64, 0.5, np.float32), device="cpu"),
                           create_mesh(MeshSpec(data=1, model=8), devices=["cpu"] * 8))
    spec = CrossSpec(n_base=2, log2_buckets=2, amount_col=1, time_col=0)
    with pytest.raises(ValueError) as e:
        mon._placed_wide_table(spec, torch.zeros(4))
    assert str(e.value) == ("wide table of 4 buckets does not column-shard over 8 model shards: "
                            "dimension 0 of shape (4,) not divisible by 8 model shards")
