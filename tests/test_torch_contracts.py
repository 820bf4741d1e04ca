"""The port's collective budgets (``analysis/contracts.py``) on the CPU:
every sharded program holds its budget at 1, 2 and 8 shards and on the
1×1, 2×2 and 2×4 grids; an extra collective, a budget declared one short
and a count that moves with the shard count are each reported under their
stable key; the counter counts a collective once at its outermost entry.
"""

from __future__ import annotations

import dataclasses

import pytest
import torch

from fraud_detection_tpu_torch.analysis import BUDGETS, Budget, check_budgets
from fraud_detection_tpu_torch.analysis.contracts import (
    GRIDS,
    PSUM,
    SHARD_COUNTS,
    run_budget,
    violations,
)
from fraud_detection_tpu_torch.parallel import collectives
from fraud_detection_tpu_torch.parallel.mesh import MeshSpec, create_mesh

torch.set_num_threads(1)

BY_NAME = {b.entrypoint: b for b in BUDGETS}


def _mesh(data: int, model: int = 1):
    return create_mesh(MeshSpec(data=data, model=model), devices=["cpu"] * (data * model))


@pytest.mark.parametrize("name", sorted(BY_NAME))
def test_every_program_holds_its_budget(name):
    """Each program at every shard count (or grid) — the table's port
    column, one budget at a time."""
    b = BY_NAME[name]
    assert check_budgets("cpu", budgets=(b,)) == []
    shapes = GRIDS if b.grid else [(n, 1) for n in SHARD_COUNTS]
    assert len(shapes) == 3


def test_the_table_covers_the_jax_entry_points():
    """The collective budgets JAX declares (``analysis/contracts.py``) each
    have a port program; the counts that differ from JAX's say why."""
    jax_declared = {
        "logistic.sgd_epoch": {"psum": 3}, "gbt.boost_step": {"psum": 4},
        "mesh.broadside_flush": {"psum": 1},
        "mesh.sharded_update": {"all_gather": 1, "psum": 2, "psum_scatter": 1},
        "mesh.wide_update": {"all_gather": 1, "psum": 4, "psum_scatter": 1},
        "longhaul.pool_merge": {"psum": 5}, "longhaul.grad_merge": {"psum": 2},
    }
    for name in ("mesh.sharded_flush", "mesh.quickwire_flush", "mesh.lantern_flush",
                 "mesh.evergreen_flush", "mesh.ledger_flush", "scaler.fit_transform",
                 "longhaul.partial_pool", "longhaul.fleet_grad"):
        jax_declared[name] = {}
    for name, want in jax_declared.items():
        b = BY_NAME[name]
        got: dict = {}
        for (kind, _axis), n in b.counts.items():  # JAX's count ignores the axis
            got[kind] = got.get(kind, 0) + n
        if got != want:
            assert "JAX declares" in b.note or "JAX's entry point" in b.note, name


def test_an_extra_psum_is_caught():
    b = BY_NAME["longhaul.pool_merge"]

    def build(mesh):
        run, units = b.build(mesh)

        def extra():
            run()
            collectives.psum(torch.zeros(1, 3), mesh=_mesh(1))

        return extra, units

    assert check_budgets("cpu", budgets=(dataclasses.replace(b, build=build),)) == [
        "longhaul.pool_merge:psum@data expected 5 got 6"]


def test_a_budget_declared_one_short_is_caught():
    short = dataclasses.replace(BY_NAME["mesh.sharded_update"], counts={
        ("all_gather", "data"): 1, PSUM: 1, ("psum_scatter", "data"): 1})
    assert check_budgets("cpu", budgets=(short,)) == [
        "mesh.sharded_update:psum@data expected 1 got 2"]
    model_short = dataclasses.replace(BY_NAME["mesh.broadside_flush"], counts={})
    assert check_budgets("cpu", budgets=(model_short,)) == [
        "mesh.broadside_flush:psum@model expected 0 got 1"]


def test_a_count_that_moves_with_the_shard_count_is_reported():
    """A program that reduces once a shard is a counting fault: each shard
    count reports its own count."""

    def build(mesh):
        def run():
            for _ in range(mesh.data):
                collectives.psum(torch.ones(mesh.data, 2), mesh)

        return run, 1

    b = Budget("probe.per_shard", "a psum a shard", "a call", {PSUM: 1}, build)
    assert check_budgets("cpu", budgets=(b,)) == [
        "probe.per_shard:psum@data expected 1 got 2", "probe.per_shard:psum@data expected 1 got 8"]


def test_setup_and_units_split_the_count():
    b = BY_NAME["longhaul.grad_merge"]
    got, units = run_budget(b, _mesh(2))
    assert units == 16 and got == {PSUM: 1 + 3 * units}
    assert violations(b, {PSUM: 3 * units}, units) == [
        f"longhaul.grad_merge:psum@data expected 3 got {(3 * units - 1) / units:g}"]


@pytest.mark.parametrize("shards", [1, 2, 8])
@pytest.mark.parametrize("call", ["psum_scatter", "pmean", "psum_scatter_blocks"])
def test_a_collective_counts_once_at_its_outermost_entry(call, shards):
    """``psum_scatter``, ``pmean`` and ``psum_scatter_blocks`` reduce through
    the fold inside and count once, under their own kind; at one shard
    too."""
    mesh = _mesh(shards, 2) if call == "psum_scatter_blocks" else _mesh(shards)
    collectives.reset_collective_counts()
    if call == "psum_scatter":
        collectives.psum_scatter(torch.ones(shards, 8 * shards), mesh)
        want = {("psum_scatter", "data"): 1}
    elif call == "pmean":
        collectives.pmean(torch.ones(shards, 3), mesh)
        want = {PSUM: 1}
    else:
        collectives.psum_scatter_blocks(torch.ones(shards, 2, 4 * shards), mesh)
        want = {("psum_scatter", "data"): 1}
    assert collectives.collective_counts() == want


def test_each_kind_is_counted_under_its_axis():
    mesh = _mesh(2, 2)
    collectives.reset_collective_counts()
    collectives.psum(torch.ones(2, 3), _mesh(2))
    collectives.psum(torch.ones(2, 3, dtype=torch.int64), _mesh(2))  # the exact path too
    collectives.pmax(torch.ones(2, 3), _mesh(2))
    collectives.all_gather(torch.ones(2, 3), _mesh(2))
    collectives.all_gather_blocks(torch.ones(2, 2, 3), mesh)
    collectives.psum_model(torch.ones(2, 2, 3), mesh)
    assert collectives.collective_counts() == {
        PSUM: 2, ("pmax", "data"): 1, ("all_gather", "data"): 2, ("psum", "model"): 1}
    collectives.reset_collective_counts()
    assert collectives.collective_counts() == {}
